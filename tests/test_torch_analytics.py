"""The port's windowed analytics (sitewhere_tpu_torch/analytics/) held
against the JAX package's, on the CPU.

`windowed_stats` and `event_type_histogram` must be bit-equal to the
jitted JAX functions (every count, every f32 cell as a bit pattern) on
seeded random rows and on the adversarial fixture of chip_smoke.py:
signed zeros, quiet and signalling NaNs of both signs, infinities,
denormals, sums that cancel into denormals, keys and buckets out of range,
invalid rows, a hot cell of thousands of rows, and single-row calls (XLA
stores a lone row as it is). Then `compact_keys` in both regimes, the
replay engine over the same appends (idx-0 rows, histogram, long span,
empty tenant, mm filter), the bus replay over the same records, and the
reference's own scenarios (tests/test_analytics.py) with their names
rebound to the port's classes. Tolerance: none.
"""

import functools
import inspect
import zlib

import numpy as np
import pytest
import torch

import sitewhere_tpu.analytics.engine as jengine
import sitewhere_tpu.analytics.windows as jwindows
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.ops.pack as jpack
import sitewhere_tpu.persist.eventlog as jeventlog
import sitewhere_tpu.pipeline.enrichment as jenrich
import sitewhere_tpu.registry.interning as jinterning
import sitewhere_tpu.runtime.bus as jbus
import test_analytics as ref_analytics
from chip_smoke import adversarial_window_rows
from sitewhere_tpu_torch import analytics as tanalytics
from sitewhere_tpu_torch import model as tmodel
from sitewhere_tpu_torch.analytics import engine as tengine
from sitewhere_tpu_torch.analytics import windows as twindows
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.persist import event_management as tem
from sitewhere_tpu_torch.persist import eventlog as teventlog
from sitewhere_tpu_torch.pipeline import enrichment as tenrich
from sitewhere_tpu_torch.registry import interning as tinterning
from sitewhere_tpu_torch.registry import store as tstore
from sitewhere_tpu_torch.runtime import bus as tbus

T0 = 1_700_000_000_000
GRIDS = ("count", "sum", "mean", "min", "max")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_stats_bits_equal(port, ref, what=""):
    for name in GRIDS:
        got, want = _bits(getattr(port, name)), _bits(getattr(ref, name))
        assert got.shape == want.shape, (what, name)
        bad = np.nonzero(got != want)
        assert not len(bad[0]), (
            f"{what} {name}: {len(bad[0])} cells differ, first at "
            f"{tuple(int(b[0]) for b in bad)}: port "
            f"{int(got[bad][0]) & 0xFFFFFFFF:#010x} vs JAX "
            f"{int(want[bad][0]) & 0xFFFFFFFF:#010x}")


def assert_reports_equal(port, ref):
    assert port.t0_ms == ref.t0_ms and port.window_ms == ref.window_ms
    assert port.n_windows == ref.n_windows
    assert port.key_tokens == ref.key_tokens
    np.testing.assert_array_equal(np.asarray(port.key_ids, object),
                                  np.asarray(ref.key_ids, object))
    assert_stats_bits_equal(port.stats, ref.stats, "report")
    if ref.type_counts is None:
        assert port.type_counts is None
    else:
        np.testing.assert_array_equal(port.type_counts, ref.type_counts)
        assert port.type_counts.dtype == np.asarray(ref.type_counts).dtype


# -- the device ops --------------------------------------------------------------

def _rows(name):
    """(keys, ts_rel, value, valid, window_ms, K, W) of one named fixture."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "random":
        n, K, W, win = 20_000, 256, 64, 100
        return (rng.integers(-3, K + 3, n).astype(np.int32),
                rng.integers(-500, W * win + 500, n),
                rng.normal(0, 50, n).astype(np.float32),
                rng.random(n) > 0.1, win, K, W)
    if name == "adversarial":
        return adversarial_window_rows(7, 8000, 64, 16, 10) + (10, 64, 16)
    if name == "hot_cell":
        return adversarial_window_rows(8, 8000, 64, 16, 10,
                                       hot_rows=3000) + (10, 64, 16)
    if name == "cancelling_tiny":   # partial sums pass through denormals
        n = 4000
        value = (rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 1.3, n)
                 * 1.1754944e-38).astype(np.float32)
        return (rng.integers(0, 16, n).astype(np.int32),
                rng.integers(0, 80, n), value, np.ones(n, bool), 10, 16, 8)
    if name == "denormal_mean":     # a quotient below FLT_MIN is flushed
        value = np.array([0x00800001, 0, 0, 0], np.uint32).view(np.float32)
        return (np.zeros(4, np.int32), np.zeros(4, np.int64), value,
                np.ones(4, bool), 1, 16, 8)
    if name == "int32_cast":        # int64 ts wrap as jnp.asarray wraps
        return (np.zeros(3, np.int32), np.array([2**32 + 5, -2**40 + 7, 3]),
                np.ones(3, np.float32), np.ones(3, bool), 1, 16, 8)
    if name.startswith("single_"):  # XLA stores a lone row as it is
        bits = {"neg_zero": 0x80000000, "snan": 0x7F800001,
                "neg_denormal": 0x800116C2, "nan": 0x7FC00000,
                "out_of_range": 0x80000000}[name[len("single_"):]]
        key = 99 if name.endswith("out_of_range") else 3
        return (np.array([key], np.int32), np.zeros(1, np.int64),
                np.array([bits], np.uint32).view(np.float32),
                np.ones(1, bool), 1, 16, 8)
    raise KeyError(name)


STATS_FIXTURES = ["random", "adversarial", "hot_cell", "cancelling_tiny",
                  "denormal_mean", "int32_cast", "single_neg_zero",
                  "single_snan", "single_neg_denormal", "single_nan",
                  "single_out_of_range"]


@pytest.mark.parametrize("name", STATS_FIXTURES)
def test_windowed_stats_bit_equal_to_jax(name):
    keys, ts, value, valid, win, K, W = _rows(name)
    ref = jwindows.windowed_stats(keys, ts, value, valid, window_ms=win,
                                  num_keys=K, n_windows=W)
    got = twindows.windowed_stats(keys, ts, value, valid, window_ms=win,
                                  num_keys=K, n_windows=W, device="cpu")
    assert got.count.dtype == torch.int32 and got.sum.dtype == torch.float32
    assert_stats_bits_equal(got, ref, name)


def test_the_fixtures_reach_every_special_case():
    """The cases the fixtures exist for do occur in them."""
    ref = {n: jwindows.windowed_stats(*_rows(n)[:4], window_ms=_rows(n)[4],
                                      num_keys=_rows(n)[5],
                                      n_windows=_rows(n)[6])
           for n in ("adversarial", "hot_cell")}
    s = ref["adversarial"]
    bits = _bits(s.sum)
    assert (bits == np.int32(-0x00400000)).any()          # inf + -inf
    assert (np.isnan(np.asarray(s.sum)) & (bits != np.int32(-0x00400000))
            & (bits != 0x7FC00000)).any()                 # a NaN's payload
    assert (_bits(s.min) == np.int32(-2**31)).any()       # -0.0 min
    assert np.asarray(ref["hot_cell"].count).max() >= 3000
    assert np.isfinite(np.asarray(ref["hot_cell"].sum)[32, 1])
    # partial sums through denormals: window 0 of keys 0-3 holds only
    # near-FLT_MIN normals, and some of its sums are flushed
    assert (np.asarray(s.count)[:4, 0] > 10).all()
    assert (np.abs(np.asarray(s.sum)[:4, 0]) < 1e-36).all()


@pytest.mark.parametrize("name", ["random", "adversarial"])
def test_event_type_histogram_equal_to_jax(name):
    keys, ts, _, valid, win, K, W = _rows(name)
    ref = np.asarray(jwindows.event_type_histogram(
        keys, ts, valid, window_ms=win, n_types=8, n_windows=W))
    got = twindows.event_type_histogram(keys, ts, valid, window_ms=win,
                                        n_types=8, n_windows=W,
                                        device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_windowed_stats_takes_device_tensors():
    keys, ts, value, valid, win, K, W = _rows("adversarial")
    ref = twindows.windowed_stats(keys, ts, value, valid, window_ms=win,
                                  num_keys=K, n_windows=W, device="cpu")
    got = twindows.windowed_stats(
        torch.from_numpy(keys), torch.from_numpy(ts.astype(np.int32)),
        torch.from_numpy(value), torch.from_numpy(valid), window_ms=win,
        num_keys=K, n_windows=W, device="cpu")
    assert_stats_bits_equal(got, ref, "tensors")


@pytest.mark.parametrize("regime", ["dense", "huge_range", "float",
                                    "all_invalid", "two_far_rows"])
def test_compact_keys_equal_to_jax(regime):
    rng = np.random.default_rng(3)
    raw, valid = {
        "dense": (rng.integers(-5, 300, 500), rng.random(500) > 0.2),
        "huge_range": (rng.integers(-2**40, 2**40, 300),
                       rng.random(300) > 0.2),
        "float": (np.array([1.5, 2.5, 1.5]), np.ones(3, bool)),
        "all_invalid": (np.array([5, 6, 7]), np.zeros(3, bool)),
        "two_far_rows": (np.array([-1, 3_000_000]), np.ones(2, bool)),
    }[regime]
    for got, want in zip(twindows.compact_keys(raw, valid),
                         jwindows.compact_keys(raw, valid)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- the replay engines against the JAX engines on the same appends ----------------

class _Interner:
    def __init__(self):
        self._map = {}

    def lookup(self, token):
        return self._map.setdefault(token, len(self._map) + 1)


def _twin_logs(seed=0):
    """The same appends into a JAX log and a port log: hot-path batches
    through each package's packer, control-plane rows with and without an
    interned index (idx 0 for dev-2, which the hot path also writes, and
    for two tokens it never does), across several sealed segments and a
    buffered tail."""
    rng = np.random.default_rng(seed)
    logs = {}
    for pkg, ev, pack, interning, elog in (
            ("jax", jevent, jpack, jinterning, jeventlog),
            ("port", tevent, tpack, tinterning, teventlog)):
        interner = interning.TokenInterner(64, "devices")
        for i in range(12):
            interner.intern(f"dev-{i}")
        packer = pack.EventPacker(256, interner, epoch_base_ms=T0)
        packer.measurements.intern("temp")
        packer.measurements.intern("rpm")
        logs[pkg] = (elog.ColumnarEventLog(segment_rows=64), packer, ev)
    for seg in range(5):
        n = 200
        cols = dict(
            device_idx=rng.integers(1, 13, n).astype(np.int32),
            event_type=rng.choice([0, 1, 2], n).astype(np.int32),
            ts_ms_abs=T0 + seg * 120_000 + rng.integers(0, 120_000, n),
            mm_idx=rng.integers(1, 3, n).astype(np.int32),
            value=rng.normal(20, 5, n).astype(np.float32))
        ctl = [(f"dev-{2 if i % 3 else 20 + i % 2}",
                T0 + seg * 120_000 + int(rng.integers(0, 120_000)),
                float(rng.normal())) for i in range(9)]
        for log, packer, ev in logs.values():
            log.append_batch("t", packer.pack_columns(**cols), packer)
            log.append_events("t", [ev.DeviceMeasurement(
                name="temp", value=v, device_id=tok, event_date=d)
                for tok, d, v in ctl])
            if seg < 4:
                log.flush_tenant("t")
    return {k: v[0] for k, v in logs.items()}


QUERIES = {
    "open_range_histogram": dict(window_ms=60_000, with_type_histogram=True),
    "explicit_range": dict(window_ms=30_000, start_ms=T0 + 60_000,
                           end_ms=T0 + 400_000),
    "mm_filter": dict(window_ms=60_000, mm_name="rpm"),
    "few_windows": dict(window_ms=10_000, max_windows=5),
    "no_match": dict(window_ms=60_000, mm_name="nothing",
                     with_type_histogram=True),
}


@pytest.fixture(scope="module")
def twin_logs():
    return _twin_logs()


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_measurement_windows_equal_to_jax(twin_logs, query):
    kw = QUERIES[query]
    ref = jengine.WindowedAnalyticsEngine(twin_logs["jax"]) \
        .measurement_windows("t", **kw)
    got = tengine.WindowedAnalyticsEngine(twin_logs["port"], device="cpu") \
        .measurement_windows("t", **kw)
    assert_reports_equal(got, ref)
    assert set(got.timings) == {"scan", "compact", "h2d", "device", "d2h",
                                "report"}


def test_measurement_windows_long_span_and_empty_tenant():
    day = 86_400_000
    reports = {}
    for pkg, ev, elog, eng in (
            ("jax", jevent, jeventlog, jengine.WindowedAnalyticsEngine),
            ("port", tevent, teventlog, functools.partial(
                tengine.WindowedAnalyticsEngine, device="cpu"))):
        log = elog.ColumnarEventLog(segment_rows=16)
        interner = _Interner()
        log.append_events("t", [ev.DeviceMeasurement(
            name="t", value=float(i), device_id=f"d{i % 3}",
            event_date=i * day) for i in range(30)], interner)
        engine = eng(log)
        reports[pkg] = (
            engine.measurement_windows("t", window_ms=day, start_ms=0,
                                       end_ms=30 * day - 1),
            engine.measurement_windows("nobody",
                                       with_type_histogram=True))
    for got, ref in zip(reports["port"], reports["jax"]):
        assert_reports_equal(got, ref)
    assert reports["port"][0].n_windows == 30
    assert reports["port"][1].totals()["events"] == 0


def _publish_twins(n=600, seed=5):
    """The same enriched records on a JAX bus and a port bus: measurements
    (a NaN among them), locations the replay must skip, and one record
    that is not msgpack at all."""
    rng = np.random.default_rng(seed)
    out = {}
    for pkg, ev, enrich, bus_mod in (("jax", jevent, jenrich, jbus),
                                     ("port", tevent, tenrich, tbus)):
        out[pkg] = (bus_mod.EventBus(partitions=2), bus_mod.TopicNaming())
    for i in range(n):
        tok = f"dev-{int(rng.integers(0, 12))}"
        value = float("nan") if i % 50 == 3 else float(rng.normal(0, 30))
        kind = "location" if i % 9 == 0 else "measurement"
        for pkg, ev, enrich in (("jax", jevent, jenrich),
                                ("port", tevent, tenrich)):
            bus, naming = out[pkg]
            ctx = ev.DeviceEventContext(device_id=tok, device_token=tok,
                                        tenant_id="t1")
            event = (ev.DeviceLocation(latitude=1.0, longitude=2.0,
                                       device_id=tok, event_date=T0 + i)
                     if kind == "location" else ev.DeviceMeasurement(
                         name="temp", value=value, device_id=tok,
                         event_date=T0 + 7 * i))
            payload = (b"\xc1 not msgpack" if i == 17
                       else enrich.pack_enriched(ctx, event))
            bus.publish(naming.inbound_enriched_events("t1"), tok.encode(),
                        payload)
    return out


def test_bus_replay_equal_to_jax():
    buses = _publish_twins()
    ref = jengine.BusReplayAnalytics(*buses["jax"]).replay_measurements(
        "t1", window_ms=100)
    got = tengine.BusReplayAnalytics(*buses["port"], device="cpu") \
        .replay_measurements("t1", window_ms=100)
    assert_reports_equal(got, ref)
    empty = tengine.BusReplayAnalytics(*buses["port"], device="cpu") \
        .replay_measurements("nobody")
    assert empty.num_keys == 0 and empty.totals()["events"] == 0


def test_mesh_is_refused_not_answered_on_one_device(twin_logs):
    """An explicit mesh, and a mesh the planner chooses, take sharded
    analytics on the port as on the JAX package: each report equals the
    JAX engine's over a JAX mesh of as many shards, bit for bit (the name
    is the refusal's this test replaced)."""
    import sitewhere_tpu.serving as jserving
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from sitewhere_tpu_torch.serving import QueryPlanner

    jax_engine = jengine.WindowedAnalyticsEngine(twin_logs["jax"])
    engine = tengine.WindowedAnalyticsEngine(twin_logs["port"],
                                             device="cpu")
    assert_reports_equal(
        engine.measurement_windows("t", mesh=make_mesh(4, device="cpu"),
                                   combine="ring"),
        jax_engine.measurement_windows("t", mesh=jax_mesh(4),
                                       combine="ring"))
    jax_engine.planner = jserving.QueryPlanner(
        twin_logs["jax"], mesh_provider=lambda: jax_mesh(8),
        mesh_row_threshold=1)
    engine.planner = QueryPlanner(
        twin_logs["port"], mesh_provider=lambda: make_mesh(8, device="cpu"),
        mesh_row_threshold=1)
    assert_reports_equal(engine.measurement_windows("t"),
                         jax_engine.measurement_windows("t"))


@pytest.mark.parametrize("entry", ["windowed_stats", "event_type_histogram",
                                   "engine", "bus_replay"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    one = np.zeros(1, np.int32)
    call = {
        "windowed_stats": lambda: twindows.windowed_stats(
            one, one, one.astype(np.float32), one.astype(bool),
            window_ms=1, num_keys=8, n_windows=8),
        "event_type_histogram": lambda: twindows.event_type_histogram(
            one, one, one.astype(bool), window_ms=1, n_types=8,
            n_windows=8),
        "engine": lambda: tengine.WindowedAnalyticsEngine(
            teventlog.ColumnarEventLog()),
        "bus_replay": lambda: tengine.BusReplayAnalytics(tbus.EventBus()),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# -- the reference's scenarios on the port -----------------------------------------

class _CPUEngine(tengine.WindowedAnalyticsEngine):
    def __init__(self, event_log, planner=None, device="cpu"):
        super().__init__(event_log, planner, device)

    @staticmethod
    def _build_report(*args, device="cpu", **kw):
        return tengine.WindowedAnalyticsEngine._build_report(
            *args, device=device, **kw)


class _CPUBusReplay(tengine.BusReplayAnalytics):
    def __init__(self, bus, naming=None, device="cpu"):
        super().__init__(bus, naming, device)


def _cpu(fn):
    return functools.partial(fn, device="cpu")


def _port_world():
    """tests/test_analytics.py's `world` fixture, on the port's classes."""
    dm = tstore.DeviceManagement()
    dtype = dm.create_device_type(tmodel.DeviceType(token="sensor"))
    area = dm.create_area(tmodel.Area(token="area-1"))
    for i in range(3):
        device = dm.create_device(tmodel.Device(token=f"dev-{i}",
                                                device_type_id=dtype.id))
        dm.create_device_assignment(tmodel.DeviceAssignment(
            token=f"as-{i}", device_id=device.id, area_id=area.id))
    return dm


ANALYTICS_NAMES = {
    "BusReplayAnalytics": _CPUBusReplay,
    "EventStreamReceiver": tanalytics.EventStreamReceiver,
    "WindowedAnalyticsEngine": _CPUEngine,
    "compact_keys": twindows.compact_keys,
    "event_type_histogram": _cpu(twindows.event_type_histogram),
    "windowed_stats": _cpu(twindows.windowed_stats),
    "DeviceEventContext": tevent.DeviceEventContext,
    "DeviceEventType": tevent.DeviceEventType,
    "DeviceLocation": tevent.DeviceLocation,
    "DeviceMeasurement": tevent.DeviceMeasurement,
    "ColumnarEventLog": teventlog.ColumnarEventLog,
    "DeviceEventManagement": tem.DeviceEventManagement,
    "pack_enriched": tenrich.pack_enriched,
    "EventBus": tbus.EventBus,
    "TopicNaming": tbus.TopicNaming,
}
ANALYTICS_SCENARIOS = sorted(
    (cls, name) for cls in ("TestWindowKernels", "TestLogReplay",
                            "TestBusReplay", "TestStreamReceiver",
                            "TestMixedPathKeys", "TestCompactKeysParity")
    for name in dir(getattr(ref_analytics, cls)) if name.startswith("test_")
) + [("", "test_compact_keys_float_and_tiny_inputs")]


def test_every_reference_scenario_is_covered():
    assert len(ANALYTICS_SCENARIOS) == 14


@pytest.mark.parametrize("cls,name", ANALYTICS_SCENARIOS)
def test_analytics_scenario_on_the_port(cls, name, monkeypatch):
    for attr, value in ANALYTICS_NAMES.items():
        monkeypatch.setattr(ref_analytics, attr, value)
    # names the scenarios import inside their bodies find the port's
    monkeypatch.setattr(jengine, "WindowedAnalyticsEngine", _CPUEngine)
    monkeypatch.setattr(jwindows, "compact_keys", twindows.compact_keys)
    monkeypatch.setattr(jevent, "DeviceMeasurement",
                        tevent.DeviceMeasurement)
    monkeypatch.setattr(jpack, "EventPacker", tpack.EventPacker)
    monkeypatch.setattr(jeventlog, "ColumnarEventLog",
                        teventlog.ColumnarEventLog)
    monkeypatch.setattr(jinterning, "TokenInterner",
                        tinterning.TokenInterner)
    fn = getattr(ref_analytics, name) if not cls else \
        getattr(getattr(ref_analytics, cls)(), name)
    fixtures = {"world": _port_world, "rng": lambda: np.random.default_rng(
        42)}
    fn(**{p: fixtures[p]() for p in inspect.signature(fn).parameters})
