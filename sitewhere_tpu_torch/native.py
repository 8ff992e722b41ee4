"""ctypes bindings of the port's native host library (csrc/host_runtime.cc).

Counterpart of `sitewhere_tpu/native/__init__.py`. The library is the
ingest path's host tier: the token interner table, the single-pass decoder
of wire frames, and the one-pass pack and unpack of the int32 wire blob.

It is built with `g++ -O3 -std=c++17 -shared -fPIC` at first use (never at
import) into `sitewhere_tpu_torch/_build/` (git-ignored), under a file name
keyed by a hash of the source and the flags, through a per-process
temporary file and `os.replace`, as `ops/cuda_build.py` builds the CUDA
kernels. It is loaded with `ctypes.CDLL`, which releases the GIL for the
length of every call. An ABI gate checks `swt_version()`: a library of
another version is unloaded, removed and rebuilt once.

Nothing falls back: a missing compiler, a failed build or a failed load
raises. The plain versions (`ops/pack.py:batch_to_blob_plain`,
`transport/wire.py:decode_frames` + `decode_event_frames_to_columns`) are
there for the tests and `chip_smoke.py` to hold the library against.

Columns go in as zero-copy numpy views: a contiguous CPU tensor's
`.numpy()`, or the array itself. A column of another dtype or layout is
converted (a copy); a CUDA tensor raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.transport.wire import WireError

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_runtime.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 9

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++ on PATH): the native "
                       "host library cannot be built")


def library_path() -> Path:
    """Where the library built from csrc/host_runtime.cc lives
    (hash-keyed)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"host_runtime-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path. Raises with
    the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host library build failed (exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    i32, i64, vp = c.c_int32, c.c_int64, c.c_void_p
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.swt_pack_blob.argtypes = [p_i32, p_i32, p_i32, p_i32, p_f32, p_f32,
                                  p_f32, p_f32, p_i32, p_i32, p_u8, i64,
                                  i32, i32, p_i32]
    lib.swt_pack_blob.restype = i32
    lib.swt_unpack_blob.argtypes = [p_i32, i64, i32, p_i32, p_i32, p_i32,
                                    p_i32, p_f32, p_f32, p_f32, p_f32, p_i32,
                                    p_i32, p_u8]
    lib.swt_unpack_blob.restype = None
    lib.swt_interner_create.argtypes = [i32]
    lib.swt_interner_create.restype = vp
    lib.swt_interner_destroy.argtypes = [vp]
    lib.swt_interner_destroy.restype = None
    lib.swt_interner_size.argtypes = [vp]
    lib.swt_interner_size.restype = i32
    lib.swt_interner_add.argtypes = [vp, c.c_char_p, i32]
    lib.swt_interner_add.restype = i32
    lib.swt_interner_add_gap.argtypes = [vp]
    lib.swt_interner_add_gap.restype = i32
    lib.swt_interner_token_at.argtypes = [vp, i32, c.c_char_p, i32]
    lib.swt_interner_token_at.restype = i32
    lib.swt_interner_lookup_offsets.argtypes = [vp, c.c_char_p, p_i64, i32,
                                                p_i32]
    lib.swt_interner_lookup_offsets.restype = i32
    lib.swt_interner_intern_offsets.argtypes = [vp, c.c_char_p, p_i64, i32,
                                                p_i32, i32]
    lib.swt_interner_intern_offsets.restype = i32
    lib.swt_decode_hot_frames.argtypes = [
        c.c_char_p, i64, i32,
        p_i32, p_i64, p_f32, p_f32, p_f32, p_f32, p_i32,
        p_u8, i64, p_i64,
        p_u8, i64, p_i64,
        p_u8, i64, p_i64,
        p_i32, p_i64, p_i64, i32, p_i64]
    lib.swt_decode_hot_frames.restype = i32
    # swt_route_blob / swt_pack_route_blob stay unbound until the sharded
    # path needs them


def _open(path: Path) -> Tuple[ctypes.CDLL, bool]:
    """(library, whether its ABI version is this binding's)."""
    lib = ctypes.CDLL(str(path))
    try:
        lib.swt_version.restype = ctypes.c_int32
        return lib, lib.swt_version() == ABI_VERSION
    except AttributeError:
        return lib, False


def lib() -> ctypes.CDLL:
    """The loaded, bound library; built first if needed. Raises when it
    cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib_, current = _open(build())
            if not current:
                # dlopen dedupes by path name: the stale mapping must be
                # closed, or the rebuilt library is never loaded
                import _ctypes

                _ctypes.dlclose(lib_._handle)
                library_path().unlink(missing_ok=True)
                lib_, current = _open(build())
                if not current:
                    raise RuntimeError(
                        f"native host library ABI version is not "
                        f"{ABI_VERSION} after a rebuild")
            _bind(lib_)
            _lib = lib_
    return _lib


# -- columns ----------------------------------------------------------------

def host_column(col, dtype) -> np.ndarray:
    """A C-contiguous numpy array of `dtype` over a host column: the
    column's own memory (no copy) when it is already a contiguous CPU
    tensor or array of that dtype; a bool column is viewed as uint8."""
    if isinstance(col, torch.Tensor):
        if col.device.type != "cpu":
            raise ValueError(f"the native host library reads host columns; "
                             f"got a tensor on {col.device}")
        col = col.numpy()
    arr = np.asarray(col)
    if arr.dtype == np.bool_ and dtype == np.uint8:
        arr = arr.view(np.uint8)
    return np.ascontiguousarray(arr, dtype)


def pack_blob(batch, out: np.ndarray, ts_base: int = 0) -> bool:
    """One pass: EventBatch columns -> the [wire_rows, n] wire blob `out`
    (wire_rows = out.shape[0]: 5, 4 compact or 3 packed; written in place,
    every element). Returns False when a device_idx is out of the wire
    field's range (the caller raises with the detail)."""
    if out.ndim != 2 or not out.flags.c_contiguous or out.dtype != np.int32:
        raise ValueError("pack_blob writes a C-contiguous [rows, n] int32 "
                         "blob")
    n = out.shape[1]
    i32, f32 = np.int32, np.float32
    cols = [host_column(getattr(batch, name), dtype) for name, dtype in (
        ("device_idx", i32), ("event_type", i32), ("ts", i32),
        ("mm_idx", i32), ("value", f32), ("lat", f32), ("lon", f32),
        ("elevation", f32), ("alert_type_idx", i32), ("alert_level", i32),
        ("valid", np.uint8))]
    _check_lengths(cols, n)
    rc = lib().swt_pack_blob(*cols, n, out.shape[0], int(ts_base),
                             out.reshape(-1))
    return rc == 0


def _check_lengths(cols, n: int) -> None:
    """Every column holds exactly n rows (the library reads n of each)."""
    bad = [c.shape for c in cols if c.shape != (n,)]
    if bad:
        raise ValueError(f"columns of {n} rows expected, got shapes {bad}")


def unpack_blob(blob: np.ndarray, cols: dict) -> None:
    """One pass: [wire_rows, n] wire blob -> preallocated column arrays
    (keys device_idx .. valid, `valid` uint8; a compact blob unpacks with
    elevation 0)."""
    blob = host_column(blob, np.int32)
    if blob.ndim != 2:
        raise ValueError(f"unpack_blob reads a [rows, n] blob, got "
                         f"{blob.shape}")
    out = [cols[name] for name in (
        "device_idx", "event_type", "ts", "mm_idx", "value", "lat", "lon",
        "elevation", "alert_type_idx", "alert_level", "valid")]
    _check_lengths(out, blob.shape[1])
    lib().swt_unpack_blob(blob.reshape(-1), blob.shape[1], blob.shape[0],
                          *out)


# -- the interner table -------------------------------------------------------

def join_tokens(tokens) -> Tuple[bytes, np.ndarray]:
    """Encode a sequence of str/bytes tokens into (joined buffer,
    offsets[n+1]); str tokens encode with surrogateescape, so non-UTF-8
    bytes round-trip."""
    enc = [t.encode(errors="surrogateescape") if isinstance(t, str) else t
           for t in tokens]
    off = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(t) for t in enc], out=off[1:])
    return b"".join(enc), off


def _offsets(buf: bytes, off) -> np.ndarray:
    """Token offsets as int64, checked to delimit tokens inside `buf` (the
    library reads buf[off[i]:off[i + 1]] for each i)."""
    off = host_column(off, np.int64)
    if off.ndim != 1 or len(off) < 1 or off[0] < 0 \
            or off[-1] > len(buf) or np.any(off[1:] < off[:-1]):
        raise ValueError("token offsets must be non-decreasing and lie "
                         "inside the buffer")
    return off


class NativeInterner:
    """Owner of one swt_interner_* table (index 0 = UNKNOWN)."""

    def __init__(self, capacity: int):
        self._lib = lib()
        self._h = self._lib.swt_interner_create(capacity)
        if not self._h:
            raise MemoryError("swt_interner_create failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.swt_interner_destroy(h)

    def __len__(self) -> int:
        return self._lib.swt_interner_size(self._h)

    def add(self, token: str) -> int:
        """Get-or-assign; -1 when the capacity is exceeded."""
        raw = token.encode(errors="surrogateescape")
        return self._lib.swt_interner_add(self._h, raw, len(raw))

    def add_gap(self) -> int:
        """Append a slot no lookup finds (a gap of a shard-congruent
        snapshot); its index, -1 when the capacity is exceeded."""
        return self._lib.swt_interner_add_gap(self._h)

    def token_at(self, idx: int) -> Optional[str]:
        cap = 1024
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.swt_interner_token_at(self._h, idx, buf, cap)
            if n >= 0:
                return buf.raw[:n].decode(errors="surrogateescape")
            if n == -1:
                return None
            cap = -n - 2  # too small: retry at the exact size

    def lookup_offsets(self, buf: bytes, off: np.ndarray) -> np.ndarray:
        off = _offsets(buf, off)
        n = len(off) - 1
        out = np.empty(n, np.int32)
        self._lib.swt_interner_lookup_offsets(self._h, buf, off, n, out)
        return out

    def intern_offsets(self, buf: bytes, off: np.ndarray,
                       skip_empty: bool = False) -> Tuple[np.ndarray, bool]:
        """(indices, capacity_ok). skip_empty maps zero-length tokens to
        UNKNOWN without interning them."""
        off = _offsets(buf, off)
        n = len(off) - 1
        out = np.empty(n, np.int32)
        rc = self._lib.swt_interner_intern_offsets(
            self._h, buf, off, n, out, 1 if skip_empty else 0)
        return out, rc == 0


# -- the wire decoder ---------------------------------------------------------

class WireDecodeError(WireError):
    """A malformed wire stream; a WireError, so `except WireError` covers
    both decoders."""


class DecodedColumns:
    """Output of decode_hot_frames: SoA columns, the string columns as
    (joined bytes, offsets[n+1]) pairs that feed the interner without
    Python strings, the control frames and the bytes consumed."""

    __slots__ = ("n", "event_type", "ts_ms", "value", "lat", "lon",
                 "elevation", "alert_level", "tokens", "names", "alert_types",
                 "others", "consumed")

    def __init__(self, n, event_type, ts_ms, value, lat, lon, elevation,
                 alert_level, tokens, names, alert_types, others, consumed):
        self.n = n
        self.event_type = event_type
        self.ts_ms = ts_ms
        self.value = value
        self.lat = lat
        self.lon = lon
        self.elevation = elevation
        self.alert_level = alert_level
        self.tokens = tokens            # (bytes, offsets[n+1])
        self.names = names              # (bytes, offsets[n+1])
        self.alert_types = alert_types  # (bytes, offsets[n+1])
        self.others = others            # [(msg_type, payload bytes)]
        self.consumed = consumed

    def token_list(self) -> List[str]:
        buf, off = self.tokens
        return [buf[off[i]:off[i + 1]].decode(errors="surrogateescape")
                for i in range(self.n)]


_DECODE_ERRORS = {1: "bad magic/version", 2: "decode capacity exceeded",
                  3: "malformed frame payload"}


def decode_hot_frames(data: bytes, max_events: Optional[int] = None
                      ) -> DecodedColumns:
    """Single-pass decode of a wire byte stream (the frame layout of
    transport/wire.py). Raises WireDecodeError on malformed input; a
    trailing partial frame is left unconsumed (`consumed`)."""
    data = bytes(data)
    cap = max_events if max_events is not None else max(len(data) // 13, 1)
    et = np.empty(cap, np.int32)
    ts = np.empty(cap, np.int64)
    val = np.empty(cap, np.float32)
    lat = np.empty(cap, np.float32)
    lon = np.empty(cap, np.float32)
    ele = np.empty(cap, np.float32)
    lvl = np.empty(cap, np.int32)
    str_cap = len(data)
    tok_buf = np.empty(max(str_cap, 1), np.uint8)
    name_buf = np.empty(max(str_cap, 1), np.uint8)
    atype_buf = np.empty(max(str_cap, 1), np.uint8)
    tok_off = np.zeros(cap + 1, np.int64)
    name_off = np.zeros(cap + 1, np.int64)
    atype_off = np.zeros(cap + 1, np.int64)
    other_cap = max(len(data) // 8, 1)
    other_type = np.empty(other_cap, np.int32)
    other_off = np.empty(other_cap, np.int64)
    other_len = np.empty(other_cap, np.int64)
    counts = np.zeros(4, np.int64)
    lib().swt_decode_hot_frames(
        data, len(data), cap, et, ts, val, lat, lon, ele, lvl,
        tok_buf, str_cap, tok_off, name_buf, str_cap, name_off,
        atype_buf, str_cap, atype_off,
        other_type, other_off, other_len, other_cap, counts)
    n, m, consumed, err = (int(x) for x in counts)
    if err:
        raise WireDecodeError(_DECODE_ERRORS.get(err, f"error {err}"))
    others = [(int(other_type[i]),
               data[int(other_off[i]):int(other_off[i]) + int(other_len[i])])
              for i in range(m)]
    return DecodedColumns(
        n, et[:n], ts[:n], val[:n], lat[:n], lon[:n], ele[:n], lvl[:n],
        (tok_buf[:tok_off[n]].tobytes(), tok_off[:n + 1]),
        (name_buf[:name_off[n]].tobytes(), name_off[:n + 1]),
        (atype_buf[:atype_off[n]].tobytes(), atype_off[:n + 1]),
        others, consumed)
