"""The port's query serving tier (sitewhere_tpu_torch/serving/) held against
the JAX package's, on the CPU.

The reference's own scenarios (tests/test_serving.py: planner routing, the
window cache cold / warm / delta / retention / idx-0 / LRU / invalidation
cases, read admission with its structured 429, readers against a sealing
writer, the vectorized bus replay against its per-record loop) run with
their names rebound to the port's classes and a CPU engine. Then both
stacks serve the same query sequence over the same appends — cold, warm,
a sealed delta with an unsealed tail, retention, an uncacheable idx-0
range, an open range with a histogram — and every result (route, cache
info, report) must be identical, grids as bit patterns. Tolerance: none
between the packages; the reference's own rtol=1e-6, atol=1e-6 where a
scenario holds a cached (merged) grid against a monolithic rescan.
"""

import inspect

import numpy as np
import pytest

import sitewhere_tpu.analytics.engine as jengine
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.persist.eventlog as jeventlog
import sitewhere_tpu.pipeline.enrichment as jenrich
import sitewhere_tpu.runtime.bus as jbus
import sitewhere_tpu.serving as jserving
import test_serving as ref_serving
from sitewhere_tpu_torch import serving as tserving
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.persist import eventlog as teventlog
from sitewhere_tpu_torch.pipeline import enrichment as tenrich
from sitewhere_tpu_torch.runtime import bus as tbus
from sitewhere_tpu_torch.serving import executor as texecutor
from sitewhere_tpu_torch.serving import planner as tplanner
from test_torch_analytics import _CPUBusReplay, _CPUEngine, \
    assert_reports_equal

SERVING_NAMES = {
    "WindowedAnalyticsEngine": _CPUEngine,
    "DeviceEventContext": tevent.DeviceEventContext,
    "DeviceLocation": tevent.DeviceLocation,
    "DeviceMeasurement": tevent.DeviceMeasurement,
    "ColumnarEventLog": teventlog.ColumnarEventLog,
    "QueryExecutor": tserving.QueryExecutor,
    "QueryPlanner": tserving.QueryPlanner,
    "WindowGridCache": tserving.WindowGridCache,
    "QueryShedError": texecutor.QueryShedError,
    "QueryPlan": tplanner.QueryPlan,
    "WindowQuery": tplanner.WindowQuery,
}
SERVING_SCENARIOS = sorted(
    (cls, name) for cls in ("TestPlanner", "TestWindowGridCache",
                            "TestExecutorAdmission", "TestConcurrentServing",
                            "TestVectorizedReplay")
    for name in dir(getattr(ref_serving, cls)) if name.startswith("test_"))


class _CPUCache(tserving.WindowGridCache):
    """The cache's delta folds on the CPU (the scenarios call `query`
    without a device; the executor passes its engine's)."""

    def query(self, tlog, *, device="cpu", **kw):
        return super().query(tlog, device=device, **kw)


# where the port departs from the reference on purpose: the scenario's body
# runs as it is and must raise this instead. A mesh provider that fails
# reaches the caller; the port never answers a would-be mesh query on one
# device in its place.
DIVERGES = {("TestPlanner", "test_mesh_provider_failure_degrades_to_host"):
            (RuntimeError, "no devices")}


def test_every_reference_scenario_is_covered():
    assert len(SERVING_SCENARIOS) == 18


@pytest.mark.parametrize("cls,name", SERVING_SCENARIOS)
def test_serving_scenario_on_the_port(cls, name, monkeypatch):
    for attr, value in SERVING_NAMES.items():
        monkeypatch.setattr(ref_serving, attr, value)
    monkeypatch.setattr(ref_serving, "WindowGridCache", _CPUCache)
    # names the scenarios import inside their bodies find the port's
    monkeypatch.setattr(jengine, "BusReplayAnalytics", _CPUBusReplay)
    monkeypatch.setattr(jenrich, "pack_enriched", tenrich.pack_enriched)
    monkeypatch.setattr(jenrich, "unpack_enriched", tenrich.unpack_enriched)
    monkeypatch.setattr(jbus, "EventBus", tbus.EventBus)
    monkeypatch.setattr(jbus, "TopicNaming", tbus.TopicNaming)
    monkeypatch.setattr(jevent, "DeviceEventType", tevent.DeviceEventType)
    fn = getattr(getattr(ref_serving, cls)(), name)
    assert not inspect.signature(fn).parameters
    if (cls, name) in DIVERGES:
        error, match = DIVERGES[cls, name]
        with pytest.raises(error, match=match):
            fn()
    else:
        fn()


# -- both stacks over the same appends -------------------------------------------

T0 = ref_serving.T0
WINDOW_MS = ref_serving.WINDOW_MS
SPAN_MS = ref_serving.SPAN_MS


class _Stack:
    """One package's log + engine + executor, fed the same appends."""

    def __init__(self, pkg):
        if pkg == "jax":
            self.ev, elog, srv = jevent, jeventlog, jserving
            self.engine = jengine.WindowedAnalyticsEngine
        else:
            self.ev, elog, srv = tevent, teventlog, tserving
            self.engine = _CPUEngine
        self.log = elog.ColumnarEventLog()
        self.interner = ref_serving._Interner()
        self.engine = self.engine(self.log)
        self.executor = srv.QueryExecutor(
            self.engine, srv.QueryPlanner(self.log), srv.WindowGridCache(),
            workers=2)

    def append(self, rows, flush=True, interned=True):
        self.log.append_events("t1", [self.ev.DeviceMeasurement(
            name="temp", value=float(v), device_id=tok,
            event_date=T0 + int(dt)) for tok, dt, v in rows],
            self.interner if interned else None)
        if flush:
            self.log.flush_tenant("t1")

    def query(self, **kw):
        kw.setdefault("window_ms", WINDOW_MS)
        out = self.executor.query(
            (jserving if self.ev is jevent else tserving).WindowQuery(
                tenant="t1", **kw), timeout=30.0)
        return out["span"]["route"], out["info"], out["report"]


def test_served_results_equal_the_jax_stack():
    stacks = {pkg: _Stack(pkg) for pkg in ("jax", "port")}
    rng = np.random.default_rng(9)

    def both(fn):
        return [fn(stacks[pkg]) for pkg in ("port", "jax")]

    def append(n, **kw):
        rows = [(f"dev-{int(rng.integers(0, 24))}",
                 int(rng.integers(0, SPAN_MS)),
                 float(rng.normal(0, 30))) for _ in range(n)]
        both(lambda s: s.append(rows, **kw))

    ranged = dict(start_ms=T0, end_ms=T0 + SPAN_MS)
    try:
        for _ in range(3):
            append(300)
        steps = ["cold", "warm"]
        results = [both(lambda s: s.query(**ranged)),
                   both(lambda s: s.query(**ranged))]
        append(200)                       # one sealed delta segment
        append(41, flush=False)           # and an unsealed tail
        steps.append("delta")
        results.append(both(lambda s: s.query(**ranged)))
        both(lambda s: s.log.retain_max_segments("t1", 2))
        steps.append("retention")
        results.append(both(lambda s: s.query(**ranged)))
        steps.append("open_range_histogram")
        results.append(both(lambda s: s.query(with_type_histogram=True)))
        append(5, interned=False)         # idx-0 rows: not cacheable
        steps.append("idx0_fallback")
        results.append(both(lambda s: s.query(**ranged)))
        for step, (got, ref) in zip(steps, results):
            assert got[0] == ref[0], step
            assert got[1] == ref[1], step
            assert_reports_equal(got[2], ref[2])
        routes = [r[0][0] for r in results]
        assert routes == ["cache"] * 4 + ["host", "host"]
        assert [r[0][1].get("cache_hit") for r in results[:4]] == \
            [False, True, True, False]
    finally:
        both(lambda s: s.executor.stop())


def test_mesh_route_raises_through_the_executor():
    """A planner with a mesh provider routes a large scan to "mesh"; the
    port's engine refuses it and the error reaches the caller."""
    log = teventlog.ColumnarEventLog()
    ref_serving._append(log, "t1", ref_serving._Interner(),
                        [("dev-1", 10, 1.0), ("dev-2", 20, 2.0)])
    ex = tserving.QueryExecutor(
        _CPUEngine(log), tserving.QueryPlanner(
            log, mesh_provider=lambda: "MESH", mesh_row_threshold=1),
        workers=1)
    try:
        with pytest.raises(NotImplementedError, match="sharded path"):
            ex.query(tplanner.WindowQuery(tenant="t1"), timeout=10.0)
        # without a provider the same query is served on the engine
        ex.planner = tserving.QueryPlanner(log)
        out = ex.query(tplanner.WindowQuery(tenant="t1"), timeout=10.0)
        assert out["plan"].route == "host"
        assert out["report"].totals()["events"] == 2
    finally:
        ex.stop()


def test_a_failing_mesh_provider_reaches_the_caller():
    """The planner does not swallow a mesh provider's error: plan,
    choose_mesh, the engine's planner-decided mesh and the executor all
    raise it, for a scan large enough to go to the mesh."""
    log = teventlog.ColumnarEventLog()
    ref_serving._append(log, "t1", ref_serving._Interner(),
                        [("dev-1", 10, 1.0), ("dev-2", 20, 2.0)])

    def boom():
        raise RuntimeError("mesh provider down")

    planner = tserving.QueryPlanner(log, mesh_provider=boom,
                                    mesh_row_threshold=1)
    query = tplanner.WindowQuery(tenant="t1")
    with pytest.raises(RuntimeError, match="mesh provider down"):
        planner.plan(query)
    with pytest.raises(RuntimeError, match="mesh provider down"):
        planner.choose_mesh("t1", query.filter())
    with pytest.raises(RuntimeError, match="mesh provider down"):
        _CPUEngine(log, planner=planner).measurement_windows("t1")
    ex = tserving.QueryExecutor(_CPUEngine(log), planner, workers=1)
    try:
        with pytest.raises(RuntimeError, match="mesh provider down"):
            ex.query(query, timeout=10.0)
        # below the threshold the provider is not asked
        planner.mesh_row_threshold = 10**9
        assert ex.query(query, timeout=10.0)["plan"].route == "host"
    finally:
        ex.stop()
