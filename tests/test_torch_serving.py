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


def _mesh_stacks():
    """Both packages' log, engine and executor over the same rows (values
    spanning decades), each planner's provider answering an 8-shard mesh
    of its own package for every scan."""
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    rows = [(f"dev-{i % 13}", 7 * i, 1.37 ** (i % 29) - 11.0)
            for i in range(600)]
    out = {}
    for pkg, ev, elog, srv, engine, mesh in (
            ("jax", jevent, jeventlog, jserving,
             jengine.WindowedAnalyticsEngine, lambda: jax_mesh(8)),
            ("port", tevent, teventlog, tserving, _CPUEngine,
             lambda: make_mesh(8, device="cpu"))):
        log = elog.ColumnarEventLog()
        log.append_events("t1", [ev.DeviceMeasurement(
            name="temp", value=v, device_id=tok, event_date=T0 + dt)
            for tok, dt, v in rows], ref_serving._Interner())
        log.flush_tenant("t1")
        planner = srv.QueryPlanner(log, mesh_provider=mesh,
                                   mesh_row_threshold=1)
        out[pkg] = srv.QueryExecutor(engine(log), planner, workers=1)
    return out


QUERY_CLASSES = {"jax": jserving.WindowQuery, "port": tplanner.WindowQuery}


def test_mesh_route_equals_jax_through_the_executor():
    """A planner with a mesh provider routes a large scan to "mesh" and the
    executor counts it; the report equals the JAX executor's over a JAX
    mesh, bit for bit, under both combines."""
    stacks = _mesh_stacks()
    routed = {pkg: ex.report()["mesh_routed_total"]
              for pkg, ex in stacks.items()}
    try:
        for combine in ("psum", "ring"):
            out = {pkg: ex.query(QUERY_CLASSES[pkg](
                tenant="t1", window_ms=500, combine=combine), timeout=30.0)
                for pkg, ex in stacks.items()}
            for pkg in out:
                assert out[pkg]["plan"].route == "mesh", pkg
            assert_reports_equal(out["port"]["report"],
                                 out["jax"]["report"])
        for pkg, ex in stacks.items():
            assert ex.report()["mesh_routed_total"] == routed[pkg] + 2
    finally:
        for ex in stacks.values():
            ex.stop()


def test_a_planner_mesh_on_another_device_fails_the_query():
    """A provider that answers a mesh on another device than the engine's:
    the query raises ValueError naming both devices, and nothing moves the
    engine's grids there (a sharded instance answers its own engine's
    mesh; `live_mesh` answers None)."""
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    ex = _mesh_stacks()["port"]
    try:
        ex.planner.mesh_provider = lambda: make_mesh(8, device="meta")
        query = tplanner.WindowQuery(tenant="t1", window_ms=500)
        assert ex.planner.plan(query).route == "mesh"
        with pytest.raises(ValueError, match="mesh on meta, engine on cpu"):
            ex.query(query, timeout=30.0)
    finally:
        ex.stop()


def test_a_failing_mesh_provider_routes_host_as_jax_does():
    """A mesh provider that raises routes the scan "host" on both packages
    (plan, choose_mesh, the engine's planner-decided mesh and the
    executor), and the host answers equal, bit for bit."""
    stacks = _mesh_stacks()

    def boom():
        raise RuntimeError("mesh provider down")

    try:
        reports = {}
        for pkg, ex in stacks.items():
            routed = ex.report()["mesh_routed_total"]
            ex.planner.mesh_provider = boom
            query = QUERY_CLASSES[pkg](tenant="t1", window_ms=500)
            assert ex.planner.plan(query).route == "host"
            assert ex.planner.choose_mesh("t1", query.filter()) is None
            ex.engine.planner = ex.planner
            direct = ex.engine.measurement_windows("t1", window_ms=500)
            out = ex.query(query, timeout=30.0)
            assert out["plan"].route == "host"
            assert ex.report()["mesh_routed_total"] == routed
            reports[pkg] = (direct, out["report"])
        for direct, served in reports.values():
            assert_reports_equal(direct, served)
        assert_reports_equal(reports["port"][1], reports["jax"][1])
    finally:
        for ex in stacks.values():
            ex.stop()
