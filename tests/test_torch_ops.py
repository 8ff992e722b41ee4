"""The port's ops (sitewhere_tpu_torch.ops) held against the JAX package's.

Same inputs, made with numpy from a seed, go through the JAX function
(jitted, on the CPU backend tests/conftest.py forces) and the port's
(device="cpu"). Tolerance: none — every int and bool output is compared
exactly and every f32 output as its int32 bit pattern, dtypes included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import compact as jcompact
from sitewhere_tpu.ops import geofence as jgeo
from sitewhere_tpu.ops import pack as jpack
from sitewhere_tpu.ops import segments as jseg
from sitewhere_tpu.ops import threshold as jthr
from sitewhere_tpu.ops.pallas_geofence import points_in_zones_pallas
from chip_smoke import adversarial_world
from sitewhere_tpu_torch.ops import compact as tcompact
from sitewhere_tpu_torch.ops import geofence as tgeo
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.ops import segments as tseg
from sitewhere_tpu_torch.ops import threshold as tthr
from sitewhere_tpu_torch.ops.geofence_kernel import points_in_zones_kernel

BATCH_FIELDS = ("device_idx", "tenant_idx", "event_type", "ts", "mm_idx",
                "value", "lat", "lon", "elevation", "alert_type_idx",
                "alert_level", "valid")


def assert_bits_equal(ref, got, what=""):
    """Exact equality of dtype, shape and bits (f32 compared as int32)."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} != {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}"
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def cols_to_batches(cols):
    """(JAX EventBatch of numpy, port EventBatch of CPU tensors)."""
    j = jpack.EventBatch(**{k: np.asarray(cols[k]) for k in BATCH_FIELDS})
    t = tpack.EventBatch(**{k: torch.from_numpy(np.array(cols[k]))
                            for k in BATCH_FIELDS})
    return j, t


def random_cols(seed, B, variant):
    """Well-formed batch columns (payloads populated per event type) for a
    wire variant: 'full' (elevation), 'compact' (locations, no elevation),
    'packed' (measurements/alerts, ts span < 2^16)."""
    rng = np.random.default_rng(seed)
    if variant == "packed":
        et = rng.choice([0, 2, 3], B).astype(np.int32)
        ts = (rng.integers(-2 ** 31 + 2, 2 ** 31 - 70000)
              + rng.integers(0, 60000, B)).astype(np.int32)
    else:
        et = rng.integers(0, 6, B).astype(np.int32)
        ts = rng.integers(-2 ** 30, 2 ** 30, B).astype(np.int32)
    is_meas, is_loc, is_alert = et == 0, et == 1, et == 2
    value = rng.normal(size=B).astype(np.float32)
    value[rng.integers(0, B, 3)] = np.nan
    return {
        "device_idx": rng.integers(0, 2 ** 22, B).astype(np.int32),
        "tenant_idx": np.zeros(B, np.int32),
        "event_type": et, "ts": ts,
        "mm_idx": np.where(is_meas, rng.integers(0, 4096, B),
                           0).astype(np.int32),
        "value": np.where(is_meas, value, 0).astype(np.float32),
        "lat": np.where(is_loc, rng.uniform(-90, 90, B), 0).astype(np.float32),
        "lon": np.where(is_loc, rng.uniform(-180, 180, B),
                        0).astype(np.float32),
        "elevation": (rng.normal(size=B).astype(np.float32)
                      if variant == "full" else np.zeros(B, np.float32)),
        "alert_type_idx": np.where(is_alert, rng.integers(0, 4096, B),
                                   0).astype(np.int32),
        "alert_level": rng.integers(0, 8, B).astype(np.int32),
        "valid": rng.integers(0, 2, B).astype(bool),
    }


_ROWS = {"full": 5, "compact": 4, "packed": 3}
_jit_blob_to_batch = jax.jit(jpack.blob_to_batch)


class TestWireBlob:
    @pytest.mark.parametrize("variant", ["full", "compact", "packed"])
    def test_batch_to_blob_bytes_match(self, variant):
        j, t = cols_to_batches(random_cols(11, 193, variant))
        ref = jpack.batch_to_blob(j)
        got = tpack.batch_to_blob(t)
        assert ref.shape[0] == _ROWS[variant]
        assert got.dtype == np.int32 and got.tobytes() == ref.tobytes()

    @pytest.mark.parametrize("variant", ["full", "compact", "packed"])
    def test_blob_to_batch_matches_both_unpackers(self, variant):
        j, _ = cols_to_batches(random_cols(12, 257, variant))
        blob = jpack.batch_to_blob(j)
        ref_dev = _jit_blob_to_batch(jnp.asarray(blob))
        ref_np = jpack.blob_to_batch_np(blob)
        got = tpack.blob_to_batch(torch.from_numpy(blob))
        for name in BATCH_FIELDS:
            assert_bits_equal(getattr(ref_dev, name),
                              getattr(got, name), f"{variant}.{name}")
            assert_bits_equal(getattr(ref_np, name), getattr(got, name),
                              f"{variant}.{name} (np)")

    @pytest.mark.parametrize("base", [-(2 ** 31) + 2, -123_456_789, -1, 0,
                                      2 ** 30, 2 ** 30 + 12345,
                                      2 ** 31 - 70_000])
    def test_packed_ts_base_shift_wrap(self, base):
        """Lane 10 of the packed base holds bits 30-31: a negative base or
        one >= 2^30 is rebuilt only through int32 shift wrap-around."""
        cols = random_cols(13, 64, "packed")
        cols["ts"] = (base + np.arange(64) * 7).astype(np.int32)
        cols["valid"][:] = True
        j, t = cols_to_batches(cols)
        blob = jpack.batch_to_blob(j)
        assert blob.shape[0] == 3
        assert tpack.batch_to_blob(t).tobytes() == blob.tobytes()
        got = tpack.blob_to_batch(torch.from_numpy(blob))
        assert_bits_equal(cols["ts"], got.ts, "ts")
        assert_bits_equal(_jit_blob_to_batch(jnp.asarray(blob)).ts, got.ts)

    def test_int32_shift_wraps(self):
        x = torch.tensor([7, 3, 2], dtype=torch.int32)
        assert (x << 30).tolist() == [-(2 ** 30), -(2 ** 30), -(2 ** 31)]

    def test_pack_events_matches(self):
        from sitewhere_tpu import model as jm
        from sitewhere_tpu.registry.interning import TokenInterner as JI
        from sitewhere_tpu_torch import model as tm
        from sitewhere_tpu_torch.registry import TokenInterner as TI

        base = 1_700_000_000_000
        jdev, tdev = JI(16), TI(16)
        for token in ("d1", "d2", "d3"):
            jdev.intern(token)
            tdev.intern(token)
        jp = jpack.EventPacker(4, jdev, epoch_base_ms=base)
        tp = tpack.EventPacker(4, tdev, epoch_base_ms=base)

        def events(m):
            return [
                m.DeviceMeasurement(name="temp", value=21.5,
                                    event_date=base + 5),
                m.DeviceLocation(latitude=1.25, longitude=-2.5,
                                 elevation=3.0, event_date=base - 7),
                m.DeviceAlert(type="door", level=m.AlertLevel.ERROR,
                              event_date=base + 2 ** 40),
                m.DeviceMeasurement(name="hum", value=-0.0,
                                    event_date=base),
                m.DeviceAlert(type="door", event_date=base + 1),
            ]

        tokens = ["d1", "d2", "nobody", "d3", "d1"]
        ref = jp.pack_events(events(jm), tokens)
        got = tp.pack_events(events(tm), tokens)
        assert len(got) == len(ref) == 2
        for r, g in zip(ref, got):
            for name in BATCH_FIELDS:
                assert_bits_equal(getattr(r, name), getattr(g, name), name)
        assert tp.measurements.snapshot() == jp.measurements.snapshot()
        assert tp.alert_types.snapshot() == jp.alert_types.snapshot()
        assert tp.pack_events([], []) == jp.pack_events([], []) == []

    def test_packer_rel_ts_clamp_and_columns(self):
        from sitewhere_tpu.registry.interning import TokenInterner as JI
        from sitewhere_tpu_torch.registry import TokenInterner as TI

        base = 1_700_000_000_000
        jp = jpack.EventPacker(8, JI(16), epoch_base_ms=base)
        tp = tpack.EventPacker(8, TI(16), epoch_base_ms=base)
        for ts in (base - 2 ** 40, base - 5, base, base + 2 ** 40):
            assert tp.rel_ts(ts) == jp.rel_ts(ts)
            assert tp.abs_ts(tp.rel_ts(ts)) == jp.abs_ts(jp.rel_ts(ts))
        args = (np.array([1, 2, 3], np.int32), np.array([0, 1, 2], np.int32),
                np.array([base - 2 ** 40, base + 9, base + 2 ** 40]))
        kw = dict(mm_idx=np.array([1, 0, 0], np.int32),
                  value=np.array([3.5, 0, 0], np.float32),
                  lat=np.array([0, 1.5, 0], np.float32),
                  lon=np.array([0, -2.5, 0], np.float32),
                  alert_type_idx=np.array([0, 0, 4], np.int32),
                  alert_level=np.array([0, 0, 2], np.int32))
        ref = jp.pack_columns(*args, **kw)
        got = tp.pack_columns(*args, **kw)
        for name in BATCH_FIELDS:
            assert_bits_equal(getattr(ref, name), getattr(got, name), name)


# -- threshold rules ---------------------------------------------------------

def _threshold_world(seed, B=96, R=24):
    rng = np.random.default_rng(seed)
    table = {
        "active": rng.random(R) < 0.85,
        "tenant_idx": rng.choice([0, 1, 2], R).astype(np.int32),
        "mm_idx": rng.choice([0, 1, 2], R).astype(np.int32),
        "device_type_idx": rng.choice([0, 1, 2], R).astype(np.int32),
        "op": (np.arange(R) % 6).astype(np.int32),
        "threshold": rng.choice([25.0, 50.0, 75.0, 0.0, 1e-45],
                                R).astype(np.float32),
        "alert_level": rng.integers(0, 4, R).astype(np.int32),
        "alert_type_idx": rng.integers(0, 9, R).astype(np.int32),
    }
    # denormal values compare as zeros in the reference (ops/numerics.py)
    value = rng.choice([25.0, 50.0, 75.0, 10.0, 90.0, np.nan, -0.0, 0.0,
                        1e-45, -1e-45, 1e-39], B)
    cols = random_cols(seed, B, "compact")
    cols.update(value=value.astype(np.float32),
                event_type=rng.choice([0, 0, 1, 2], B).astype(np.int32),
                tenant_idx=rng.choice([0, 1, 2], B).astype(np.int32),
                mm_idx=rng.choice([0, 1, 2, 3], B).astype(np.int32))
    dtype = rng.choice([0, 1, 2], B).astype(np.int32)
    return table, cols, dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_rules_match(seed):
    table, cols, dtype = _threshold_world(seed)
    jb, tb = cols_to_batches(cols)
    ref = jax.jit(jthr.eval_threshold_rules)(
        jb, jthr.ThresholdRuleTable(**table), dtype)
    got = tthr.eval_threshold_rules(
        tb, tthr.ThresholdRuleTable(**{k: torch.from_numpy(v)
                                       for k, v in table.items()}),
        torch.from_numpy(dtype))
    assert set(got) == set(ref)
    for key in ref:
        assert_bits_equal(ref[key], got[key], key)
    # the six ops all fire somewhere, and NaN rows fire nothing
    assert np.asarray(ref["fired"]).any()
    nan_rows = np.isnan(cols["value"])
    assert not got["fired"].numpy()[nan_rows].any()


def test_nan_never_fires_on_not_equal():
    value = torch.tensor([[np.nan], [1.0]], dtype=torch.float32)
    op = torch.full((1, 1), tthr.ThresholdOp.NEQ, dtype=torch.int32)
    thr = torch.zeros((1, 1), dtype=torch.float32)
    assert tthr._compare(value, op, thr)[:, 0].tolist() == [False, True]


# -- geofence containment ----------------------------------------------------

def _random_world(seed, B=97, Z=5, V=7):
    """Copy of tests/test_pallas_ops.py's world: convex-ish polygons padded
    by repeating the last vertex, points across and beyond them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (Z, 2))
    verts = np.zeros((Z, V, 2), np.float32)
    for z in range(Z):
        nv = int(rng.integers(3, V + 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        r = rng.uniform(2, 12, nv)
        pts = centers[z] + np.stack([r * np.sin(ang), r * np.cos(ang)], 1)
        verts[z, :nv] = pts
        verts[z, nv:] = pts[-1]
    lat = rng.uniform(-70, 70, B).astype(np.float32)
    lon = rng.uniform(-70, 70, B).astype(np.float32)
    return lat, lon, verts


_jit_xla_pip = jax.jit(jgeo.points_in_zones)


@pytest.mark.parametrize("world", ["random0", "random1", "adversarial"])
def test_points_in_zones_matches_xla_and_pallas(world):
    if world == "adversarial":
        lat, lon, verts = adversarial_world()
    else:
        lat, lon, verts = _random_world(int(world[-1]))
    ref_xla = _jit_xla_pip(jnp.asarray(lat), jnp.asarray(lon),
                           jnp.asarray(verts))
    ref_pallas = points_in_zones_pallas(
        jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(verts),
        interpret=True)
    args = (torch.from_numpy(lat), torch.from_numpy(lon),
            torch.from_numpy(verts))
    got = tgeo.points_in_zones(*args)
    assert_bits_equal(ref_xla, got, "vs xla")
    assert_bits_equal(ref_pallas, got, "vs pallas interpret")
    # the kernel wrapper takes the plain version for CPU tensors
    assert_bits_equal(ref_xla, points_in_zones_kernel(*args), "wrapper")
    if world == "adversarial":  # the fixture must exercise both outcomes
        assert np.asarray(ref_xla).any() and not np.asarray(ref_xla).all()


def test_kernel_wrapper_does_not_count_cpu_calls():
    lat, lon, verts = _random_world(3, B=9, Z=2, V=4)
    before = points_in_zones_kernel.launches
    points_in_zones_kernel(torch.from_numpy(lat), torch.from_numpy(lon),
                           torch.from_numpy(verts))
    assert points_in_zones_kernel.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_geofence_rules_with_tenant_scoping(seed):
    rng = np.random.default_rng(seed)
    B, G = 120, 10
    lat, lon, verts = _random_world(seed, B=B, Z=6, V=6)
    lat = rng.uniform(-40, 40, B).astype(np.float32)
    lon = rng.uniform(-40, 40, B).astype(np.float32)
    zones = {"vertices": verts, "nvert": np.full(6, 6, np.int32),
             "tenant_idx": np.array([0, 1, 2, 1, 2, 0], np.int32),
             "active": np.array([1, 1, 1, 0, 1, 1], bool)}
    rules = {"active": rng.random(G) < 0.9,
             "zone_row": rng.integers(0, 6, G).astype(np.int32),
             "condition": rng.integers(0, 2, G).astype(np.int32),
             "alert_level": rng.integers(0, 4, G).astype(np.int32),
             "alert_type_idx": rng.integers(0, 5, G).astype(np.int32)}
    cols = random_cols(seed, B, "compact")
    cols.update(lat=lat, lon=lon,
                event_type=rng.choice([0, 1, 1, 2], B).astype(np.int32),
                tenant_idx=rng.choice([0, 1, 2], B).astype(np.int32))
    jb, tb = cols_to_batches(cols)
    ref = jax.jit(functools.partial(jgeo.eval_geofence_rules, impl="xla"))(
        jb, jgeo.ZoneTable(**zones), jgeo.GeofenceRuleTable(**rules))
    got = tgeo.eval_geofence_rules(
        tb, tgeo.ZoneTable(**{k: torch.from_numpy(v)
                              for k, v in zones.items()}),
        tgeo.GeofenceRuleTable(**{k: torch.from_numpy(v)
                                  for k, v in rules.items()}))
    assert set(got) == set(ref)
    for key in ref:
        assert_bits_equal(ref[key], got[key], key)
    assert np.asarray(ref["fired"]).any()


# -- keyed folds ---------------------------------------------------------------

def _fold_inputs(seed, B=160, n=24):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n + 3, B).astype(np.int32)   # some >= n: dropped
    ts = rng.integers(-5, 5, B).astype(np.int32)        # many equal-ts ties
    valid = rng.random(B) < 0.8
    state_ts = rng.choice([-(2 ** 31), -3, 0, 4], n).astype(np.int32)
    states = (rng.normal(size=(n, 3)).astype(np.float32),
              rng.integers(0, 9, n).astype(np.int32))
    values = (rng.normal(size=(B, 3)).astype(np.float32),
              rng.integers(0, 9, B).astype(np.int32))
    return keys, ts, valid, state_ts, states, values


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_last_by_key_matches(seed):
    keys, ts, valid, state_ts, states, values = _fold_inputs(seed)
    n = state_ts.shape[0]
    ref_ts, ref_states = jax.jit(jseg.last_by_key, static_argnums=3)(
        keys, ts, valid, n, state_ts, states, values)
    t = torch.from_numpy
    got_ts, got_states = tseg.last_by_key(
        t(keys), t(ts), t(valid), n, t(state_ts),
        tuple(t(s) for s in states), tuple(t(v) for v in values))
    assert_bits_equal(ref_ts, got_ts, "state_ts")
    for i, (r, g) in enumerate(zip(ref_states, got_states)):
        assert_bits_equal(r, g, f"state {i}")


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_max_and_count_by_key_match(seed):
    keys, ts, valid, state_ts, _, _ = _fold_inputs(seed)
    n = state_ts.shape[0]
    t = torch.from_numpy
    assert_bits_equal(
        jax.jit(jseg.scatter_max_by_key, static_argnums=3)(
            keys, ts, valid, n, state_ts),
        tseg.scatter_max_by_key(t(keys), t(ts), t(valid), n, t(state_ts)),
        "scatter_max")
    assert_bits_equal(
        jax.jit(jseg.count_by_key, static_argnums=2)(keys, valid, n),
        tseg.count_by_key(t(keys), t(valid), n), "count")


# -- alert-lane compaction -----------------------------------------------------

@pytest.mark.parametrize("fire_rate,capacity", [(0.05, 16), (0.6, 16),
                                                (1.0, 8), (0.0, 4)])
def test_compact_alert_lanes_match(fire_rate, capacity):
    rng = np.random.default_rng(int(fire_rate * 100) + capacity)
    B = 100

    def family(rate):
        fired = rng.random(B) < rate
        return {"fired": fired,
                "first_rule": np.where(fired, rng.integers(0, 300, B),
                                       -1).astype(np.int32),
                "alert_level": np.where(fired, rng.integers(0, 4, B),
                                        -1).astype(np.int32)}

    thr, geo = family(fire_rate), family(fire_rate / 2)
    prog = {"fired": np.zeros(B, bool),
            "first_rule": np.full(B, -1, np.int32),
            "alert_level": np.full(B, -1, np.int32)}
    model = {"fired": np.zeros(B, bool),
             "first_model": np.full(B, -1, np.int32)}
    ref = jax.jit(jcompact.compact_alert_lanes, static_argnums=2)(
        thr, geo, capacity, prog, model)

    def tt(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    got = tcompact.compact_alert_lanes(tt(thr), tt(geo), capacity,
                                       tt(prog), tt(model))
    assert_bits_equal(ref, got, "lanes")
    dec_ref = jcompact.decode_alert_lanes(np.asarray(ref))
    dec = tcompact.decode_alert_lanes(got.numpy())
    for name in ("rows", "thr_fired", "geo_fired", "thr_rule", "geo_rule",
                 "thr_level", "geo_level", "prog_fired", "prog_rule",
                 "prog_level", "model_fired", "model_slot"):
        assert_bits_equal(getattr(dec_ref, name), getattr(dec, name), name)
    for name in ("fired_rows", "dropped_alerts", "total_alerts",
                 "route_dropped"):
        assert getattr(dec, name) == getattr(dec_ref, name), name
    if fire_rate >= 0.6:   # an alert storm: more fired rows than K
        assert dec.fired_rows > capacity and dec.dropped_alerts > 0
