"""The port's native host library (sitewhere_tpu_torch/native.py over
csrc/host_runtime.cc) held against the JAX package's, on the CPU.

The wire pack and unpack byte for byte against the JAX `batch_to_blob` /
`blob_to_batch_np` (with the JAX native library and with its numpy path)
and against the port's plain numpy pack, on all three layouts; the batched
interner against the JAX TokenInterner (long, non-UTF-8 and empty tokens,
and after a restore); the frame decoder against the JAX native decoder and
the plain Python decoder. The library builds at first use, never at
import, and a failed build raises. Tolerance: none (f32 as bit patterns).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sitewhere_tpu.native as jnative
from sitewhere_tpu.ops import pack as jpack
from sitewhere_tpu.registry.interning import TokenInterner as JInterner
from sitewhere_tpu_torch import native
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.registry.interning import TokenInterner
from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireCodec, WireError, decode_event_frames_to_columns,
    decode_frames, encode_frame)

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("device_idx", "event_type", "ts", "mm_idx", "value", "lat", "lon",
          "elevation", "alert_type_idx", "alert_level", "valid")
LAYOUTS = {"full": 5, "compact": 4, "packed": 3}


def _columns(layout, n=257, seed=11):
    """Seeded numpy columns whose content picks `layout`."""
    rng = np.random.default_rng(seed + LAYOUTS[layout])
    et = rng.integers(0, 6, n).astype(np.int32)
    if layout == "packed":
        et[et == 1] = 0            # no locations
        ts = rng.integers(-5000, 60000, n).astype(np.int32)
    else:
        ts = rng.integers(-2 ** 30, 2 ** 30, n).astype(np.int32)
    is_meas, is_loc, is_alert = et == 0, et == 1, et == 2
    elevation = (rng.normal(size=n).astype(np.float32) if layout == "full"
                 else np.zeros(n, np.float32))
    value = np.where(is_meas, rng.normal(size=n), 0).astype(np.float32)
    value[:3] = [np.float32(-0.0), np.float32(1e-40), np.float32(np.nan)]
    return dict(
        device_idx=rng.integers(0, 2 ** 22, n).astype(np.int32),
        tenant_idx=np.zeros(n, np.int32),
        event_type=et, ts=ts,
        mm_idx=np.where(is_meas, rng.integers(0, 8192, n), 0)
        .astype(np.int32),
        value=value,
        lat=np.where(is_loc, rng.uniform(-90, 90, n), 0).astype(np.float32),
        lon=np.where(is_loc, rng.uniform(-180, 180, n), 0)
        .astype(np.float32),
        elevation=elevation,
        alert_type_idx=np.where(is_alert, rng.integers(-5, 8192, n), 0)
        .astype(np.int32),
        alert_level=rng.integers(0, 8, n).astype(np.int32),
        valid=rng.integers(0, 2, n).astype(bool))


def _batches(cols):
    jb = jpack.EventBatch(**{k: v.copy() for k, v in cols.items()})
    tb = tpack.EventBatch(**{k: torch.from_numpy(v.copy())
                             for k, v in cols.items()})
    return jb, tb


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_matches_jax_and_plain(layout, jax_native, monkeypatch):
    if not jax_native:
        monkeypatch.setattr(jnative, "available", lambda: False)
    jb, tb = _batches(_columns(layout))
    ref = jpack.batch_to_blob(jb)
    # in place, into the caller's [WIRE_ROWS, B] buffer
    out = np.full((tpack.WIRE_ROWS, ref.shape[1]), -1, np.int32)
    got = tpack.batch_to_blob(tb, out=out)
    plain = tpack.batch_to_blob_plain(tb)
    assert ref.shape == (LAYOUTS[layout], 257)
    assert got.shape == ref.shape and np.shares_memory(got, out)
    assert got.tobytes() == ref.tobytes() == plain.tobytes()
    assert tpack.batch_to_blob(tb).tobytes() == ref.tobytes()


@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_unpack_matches_jax(layout, jax_native, monkeypatch):
    if not jax_native:
        monkeypatch.setattr(jnative, "available", lambda: False)
    jb, tb = _batches(_columns(layout, seed=5))
    blob = tpack.batch_to_blob(tb)
    ref = jpack.blob_to_batch_np(blob.copy())
    got = tpack.blob_to_batch_np(blob)
    plain = tpack.blob_to_batch(torch.from_numpy(blob.copy()))
    for name in FIELDS:
        want = _bits(getattr(ref, name))
        assert np.array_equal(_bits(getattr(got, name).numpy()), want), name
        assert np.array_equal(_bits(getattr(plain, name).numpy()),
                              want), name


@pytest.mark.parametrize("bad", [tpack.WIRE_DEV_MAX, -1])
def test_out_of_range_device_index_error(bad):
    cols = _columns("compact", n=16)
    cols["device_idx"][3] = bad
    jb, tb = _batches(cols)
    with pytest.raises(ValueError) as jerr:
        jpack.batch_to_blob(jb)
    with pytest.raises(ValueError) as terr:
        tpack.batch_to_blob(tb)
    with pytest.raises(ValueError) as perr:
        tpack.batch_to_blob_plain(tb)
    assert str(terr.value) == str(jerr.value) == str(perr.value)
    assert "out of wire-blob device field range" in str(terr.value)


def test_pack_reads_torch_columns_without_copies(monkeypatch):
    """The columns reach the library as views of the tensors' memory."""
    _, tb = _batches(_columns("full", n=64))
    seen = []
    real = native.host_column

    def spy(col, dtype):
        arr = real(col, dtype)
        if isinstance(col, torch.Tensor):
            seen.append(arr.ctypes.data == col.data_ptr())
        return arr

    monkeypatch.setattr(native, "host_column", spy)
    tpack.batch_to_blob(tb)
    assert len(seen) == 11 and all(seen)
    with pytest.raises(ValueError, match="host columns"):
        native.host_column(torch.zeros(2, device="meta"), np.int32)


# -- the interner -----------------------------------------------------------

LONG = "x" * 2000
NON_UTF8 = b"\xff\xfe"


def _drive(it):
    """One sequence of single and batched calls; returns what each gave."""
    out = [list(it.intern_batch([LONG, "short", "dev-1", "short"]))]
    out.append(it.intern("dev-2"))
    buf = NON_UTF8 + b"ok" + b"" + b"m1"
    off = np.array([0, 2, 4, 4, 6], np.int64)
    out.append(list(it.intern_offsets(buf, off)))
    out.append(list(it.intern_offsets(b"m9" + b"", np.array([0, 2, 2]),
                                      skip_empty=True)))
    out.append(list(it.lookup_batch([LONG, "missing", "dev-2", ""])))
    out.append(list(it.lookup_offsets(buf, off)))
    out.append(it.intern("after-batch"))
    out.append((it.lookup(LONG), it.token_of(1), len(it), it.version))
    return out


def test_batched_interner_matches_jax():
    assert jnative.available()
    j, t = JInterner(64, "tokens"), TokenInterner(64, "tokens")
    assert _drive(t) == _drive(j)
    assert t.snapshot() == j.snapshot()
    assert t.token_of(5).encode(errors="surrogateescape") == NON_UTF8
    assert None not in t._to_index
    # the native mirror holds exactly the Python table
    assert len(t._nat) == len(t)
    assert [t._nat.token_at(i) for i in range(1, len(t))] == \
        t.snapshot()[1:]


def test_batched_interner_after_restore():
    """A restore (with a gap slot, as a shard-congruent snapshot has)
    rebuilds the mirror: batched lookups and new interns agree with the
    JAX interner's."""
    snap = [None, "a", None, LONG, NON_UTF8.decode(errors="surrogateescape"),
            ""]
    j, t = JInterner(32, "tokens"), TokenInterner(32, "tokens")
    for it in (j, t):
        it.intern_batch(["stale-1", "stale-2"])   # a mirror exists
        it.restore(snap)
    buf, off = native.join_tokens(["a", LONG, "stale-1", "", "b", "c"])
    assert list(t.lookup_offsets(buf, off)) == \
        list(j.lookup_offsets(buf, off)) == [1, 3, 0, 5, 0, 0]
    assert list(t.intern_batch(["b", "a", "c"])) == \
        list(j.intern_batch(["b", "a", "c"])) == [6, 1, 7]
    assert t.snapshot() == j.snapshot()
    assert t.version == j.version
    # a mirror built lazily from a restored table agrees as well
    lazy = TokenInterner(32, "tokens")
    lazy.restore(snap)
    assert lazy._nat is None
    assert list(lazy.lookup_offsets(buf, off)) == [1, 3, 0, 5, 0, 0]


def test_native_calls_check_their_buffers():
    """Sizes and offsets are checked before a pointer reaches the
    library."""
    _, tb = _batches(_columns("compact", n=16))
    with pytest.raises(ValueError, match="columns of 8 rows"):
        native.pack_blob(tb, np.empty((4, 8), np.int32))
    t = TokenInterner(8, "tokens")
    with pytest.raises(ValueError, match="inside the buffer"):
        t.lookup_offsets(b"abc", np.array([0, 2, 9]))
    with pytest.raises(ValueError, match="non-decreasing"):
        t.intern_offsets(b"abc", np.array([0, 2, 1]))
    assert len(t) == 1


def test_batched_interner_capacity():
    j, t = JInterner(4, "tokens"), TokenInterner(4, "tokens")
    for it in (j, t):
        it.intern_batch(["a", "b"])
        with pytest.raises(Exception) as err:
            it.intern_batch(["c", "d", "e"])
        assert "capacity 4 exceeded" in str(err.value)
    assert t.snapshot() == j.snapshot() == [None, "a", "b", "c"]


# -- the frame decoder ---------------------------------------------------------

def _stream(n=200, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tok = f"dev-{int(rng.integers(0, 50))}"
        ts = 1_700_000_000_000 + i
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(encode_frame(
                MessageType.MEASUREMENT, WireCodec.encode_measurement(
                    tok, ts, f"m{int(rng.integers(0, 5))}" if i % 7 else "",
                    float(rng.normal()))))
        elif kind == 1:
            out.append(encode_frame(
                MessageType.LOCATION, WireCodec.encode_location(
                    tok, ts, float(rng.uniform(-90, 90)),
                    float(rng.uniform(-180, 180)), float(rng.normal()))))
        else:
            out.append(encode_frame(
                MessageType.ALERT, WireCodec.encode_alert(
                    tok, ts, f"alert.t{int(rng.integers(0, 3))}",
                    int(rng.integers(0, 5)), "engine hot")))
    return b"".join(out)


def _decoded(cols):
    return {
        "n": cols.n, "consumed": cols.consumed, "others": cols.others,
        "tokens": (cols.tokens[0], list(cols.tokens[1])),
        "names": (cols.names[0], list(cols.names[1])),
        "alert_types": (cols.alert_types[0], list(cols.alert_types[1])),
        **{k: _bits(getattr(cols, k)).tolist() for k in (
            "event_type", "ts_ms", "value", "lat", "lon", "elevation",
            "alert_level")}}


@pytest.mark.parametrize("case", ["stream", "partial", "control"])
def test_decoder_matches_jax_and_plain(case):
    reg = encode_frame(MessageType.REGISTER, b"\x81\xa1a\xa1b")
    data = {"stream": _stream(),
            "partial": _stream(10)[:-3],
            "control": reg + _stream(5) + reg}[case]
    got = native.decode_hot_frames(data)
    assert _decoded(got) == _decoded(jnative.decode_hot_frames(data))
    frames, rest = decode_frames(data)
    plain = decode_event_frames_to_columns(frames)
    assert got.consumed == len(data) - len(rest)
    assert got.token_list() == plain["tokens"]
    for name, col in (("names", "names"), ("alert_types", "alert_types")):
        buf, off = getattr(got, name)
        assert [buf[off[i]:off[i + 1]].decode() for i in range(got.n)] == \
            plain[col]
    for k in ("event_type", "ts_ms", "value", "lat", "lon", "elevation",
              "alert_level"):
        assert np.array_equal(_bits(getattr(got, k)), _bits(plain[k])), k
    assert [(t, p) for t, p in got.others] == [
        (int(t), p) for t, p in frames if t not in (
            MessageType.MEASUREMENT, MessageType.LOCATION,
            MessageType.ALERT)]
    if case == "partial":
        assert got.n == 9 and data[got.consumed:got.consumed + 2] == b"SW"


def test_decoder_errors():
    good = encode_frame(MessageType.MEASUREMENT,
                        WireCodec.encode_measurement("d", 1, "m", 1.0))
    truncated = good[:4] + (3).to_bytes(4, "little") + good[8:11]
    for data, text in ((b"XX\x01\x03\x04\x00\x00\x00abcd1234",
                        "bad magic/version"),
                       (truncated, "malformed frame payload")):
        with pytest.raises(native.WireDecodeError, match=text):
            native.decode_hot_frames(data)
        with pytest.raises(jnative.WireDecodeError, match=text):
            jnative.decode_hot_frames(data)
    assert issubclass(native.WireDecodeError, WireError)
    with pytest.raises(WireError):
        decode_frames(b"XX\x01\x03\x04\x00\x00\x00abcd1234")


# -- build and load --------------------------------------------------------------

_PROBE = r"""
import importlib, json, pkgutil
import sitewhere_tpu_torch
from sitewhere_tpu_torch import native
for m in pkgutil.walk_packages(sitewhere_tpu_torch.__path__,
                               "sitewhere_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps({"loaded": native._lib is not None}))
"""


def test_library_is_not_loaded_at_import():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        {"loaded": False}


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "host_runtime.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native host library build "
                                           "failed"):
        native.lib()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_stale_library_is_rebuilt(monkeypatch, tmp_path):
    """The ABI gate: a library of another version at the library's path is
    unloaded, removed and rebuilt from the source."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    path = native.library_path()
    path.parent.mkdir(parents=True)
    stub = tmp_path / "stub.cc"
    stub.write_text('extern "C" int swt_version() { return 8; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(path), str(stub)],
                   check=True)
    lib = native.lib()
    assert lib.swt_version() == native.ABI_VERSION
    assert path.exists() and path.stat().st_size > 10000
