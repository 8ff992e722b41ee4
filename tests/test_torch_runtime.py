"""The port's host runtime modules held against the JAX package's, on the CPU.

Each module of `sitewhere_tpu_torch/runtime/` is a copy of its reference in
`sitewhere_tpu/runtime/`; the same call sequence through both must give the
same result:
  - metrics: the same report() and Prometheus text (meters on one fake
    clock), and every metric name the port registers is in the
    docs/OBSERVABILITY.md inventory and sanitizes to a legal name;
  - faults: the same seeded firing pattern, per point, under one plan;
  - health: the same ladder of transitions;
  - flight: the same export() and rollups for records marked on explicit
    timestamps;
  - eventage: the same summaries, quantiles and wire forms;
  - lifecycle: the same status tree through the same transitions, failures
    included; the port's engine is a LifecycleComponent;
  - hbmledger: the same per-table bytes for the same engine world.
Tolerance: none.
"""

import pathlib
import re
import time

import pytest

from sitewhere_tpu.runtime import eventage as j_age
from sitewhere_tpu.runtime import faults as j_faults
from sitewhere_tpu.runtime import flight as j_flight
from sitewhere_tpu.runtime import health as j_health
from sitewhere_tpu.runtime import lifecycle as j_life
from sitewhere_tpu.runtime import metrics as j_metrics
from sitewhere_tpu_torch.runtime import eventage as t_age
from sitewhere_tpu_torch.runtime import faults as t_faults
from sitewhere_tpu_torch.runtime import flight as t_flight
from sitewhere_tpu_torch.runtime import health as t_health
from sitewhere_tpu_torch.runtime import lifecycle as t_life
from sitewhere_tpu_torch.runtime import metrics as t_metrics

from test_torch_pipeline import world  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _always_disarm():
    j_faults.disarm()
    t_faults.disarm()
    yield
    j_faults.disarm()
    t_faults.disarm()


class FakeClock:
    def __init__(self, start=100.0, step=0.25):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return self.t


# -- metrics ------------------------------------------------------------------

def _drive_metrics(mod, monkeypatch):
    monkeypatch.setattr(time, "monotonic", FakeClock())
    reg = mod.MetricsRegistry()
    reg.counter("a.count").inc()
    reg.counter("a.count").inc(4)
    scoped = reg.scoped("pipeline.eng-1")
    scoped.counter("step_retries").inc(2)
    for n in (10, 20, 5):
        scoped.meter("events").mark(n)
    for s in (0.004, 0.001, 0.03, 0.0002, 0.9):
        scoped.timer("pack").update(s)
    hist = reg.histogram("pipeline.step_stage_seconds")
    for i, s in enumerate((0.0001, 0.003, 0.02, 0.7, 3.0, 0.001)):
        hist.observe(s, engine="e", stage=("pack", "dispatch")[i % 2])
    tenants = reg.histogram("pipeline.step_tenant_events",
                            buckets=(1.0, 8.0, 64.0))
    tenants.observe(7.0, engine="e", tenant="1")
    tenants.observe(100.0, engine="e", tenant="2")
    ages = mod.Histogram(buckets=(0.1, 1.0), max_children=2)
    for i in range(4):     # past the cap: spills into the _overflow child
        ages.observe(0.5, engine=f"e{i}")
    ages.observe_buckets([1, 2, 3], 2.5, 6, engine="e0")
    reg._histograms["capped"] = ages
    text = reg.prometheus_text(extra_gauges={
        'hbm.table_bytes{table="device_state"}': 128,
        'hbm.table_bytes{table="rule_state"}': 64, "hbm.total_bytes": 192})
    return reg.report(), text, ages.snapshot()


def test_metrics_report_and_prometheus_text_match(monkeypatch):
    ref = _drive_metrics(j_metrics, monkeypatch)
    got = _drive_metrics(t_metrics, monkeypatch)
    assert got == ref
    assert "swtpu_pipeline_eng_1_step_retries_total 2" in got[1]
    assert '_overflow' in got[1]


_REG_CALL = re.compile(
    r"\.(counter|meter|timer|histogram)\(\s*\"([^\"{]+)\"", re.S)
_PROM_LEGAL = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def test_port_metric_names_are_in_the_reference_inventory():
    names = set()
    for path in sorted((REPO / "sitewhere_tpu_torch").rglob("*.py")):
        names.update(n for _, n in _REG_CALL.findall(path.read_text()))
    names.update(re.findall(r"\"(hbm\.[a-z_.0-9]+)\"", (
        REPO / "sitewhere_tpu_torch/runtime/hbmledger.py").read_text()))
    assert {"pipeline.step_stage_seconds", "step_retries",
            "health_transitions", "staging_ring.full_waits", "events",
            "alerts.dropped", "hbm.table_bytes"} <= names, sorted(names)
    docs = (REPO / "docs" / "OBSERVABILITY.md").read_text()
    assert not sorted(n for n in names if f"`{n}`" not in docs)
    assert not sorted(n for n in names
                      if not _PROM_LEGAL.match(t_metrics._prom_name(n)))
    for name in names | {"9lives.x-y"}:
        assert t_metrics._prom_name(name) == j_metrics._prom_name(name)


# -- faults -------------------------------------------------------------------

def _fire_pattern(mod, seed):
    plan = mod.FaultPlan(seed=seed, rules=[
        mod.FaultRule("h2d_error", p=0.3),
        mod.FaultRule("dispatch_error", p=0.5, after=3, times=4),
        mod.FaultRule("lane_fetch_error", times=2, after=1),
        mod.FaultRule("busnet_drop", p=0.6)])
    pattern = []
    for i in range(60):
        point = ("h2d_error", "dispatch_error", "lane_fetch_error",
                 "busnet_drop", "pack_fail")[i % 5]
        pattern.append((point, plan.check(point) is not None))
    return pattern, plan.report()


@pytest.mark.parametrize("seed", [0, 7, 20260101])
def test_fault_plan_fires_at_the_same_calls(seed):
    ref = _fire_pattern(j_faults, seed)
    got = _fire_pattern(t_faults, seed)
    assert got == ref
    assert any(fired for _, fired in got[0])
    assert t_faults.FAULT_POINTS == j_faults.FAULT_POINTS


def test_fault_point_arms_raises_and_round_trips():
    doc = {"seed": 3, "rules": [{"point": "dispatch_error", "times": 2},
                                {"point": "busnet_drop", "p": 0.5}]}
    outcomes = {}
    for mod in (j_faults, t_faults):
        plan = mod.FaultPlan.from_json(doc)
        mod.arm(plan)
        seen = []
        for point in ("dispatch_error",) * 3 + ("busnet_drop",) * 6:
            try:
                rule = mod.fault_point(point)
                seen.append("rule" if rule is not None else None)
            except mod.FaultError as exc:
                seen.append(exc.point)
        mod.disarm()
        assert mod.fault_point("dispatch_error") is None
        outcomes[mod] = (seen, plan.report())
    assert outcomes[t_faults] == outcomes[j_faults]
    with pytest.raises(ValueError, match="unknown fault point"):
        t_faults.FaultRule("no_such_point")
    draws = [t_faults.jittered(0.8) for _ in range(200)]
    assert all(0.4 <= d <= 0.8 for d in draws) and len(set(draws)) > 1


# -- health -------------------------------------------------------------------

def _health_trace(mod):
    metrics = (t_metrics if mod is t_health else j_metrics).MetricsRegistry()
    h = mod.EngineHealth("eng", metrics=metrics.scoped("p"), recover_after=3)
    trace = []
    for event in ("retry", "success", "retry", "success", "success",
                  "success", "poison", "success", "shed", "success",
                  "success", "success", "fatal", "success", "poison",
                  "reset", "retry"):
        if event in ("retry", "shed", "poison", "fatal"):
            getattr(h, f"note_{event}")()
        elif event == "success":
            h.note_success()
        else:
            h.reset()
        trace.append((h.state, h.code, h.transitions, h.last_cause))
    doc = h.to_json()
    recent = [(r["state"], r["cause"]) for r in doc.pop("recent")]
    doc.pop("last_transition_ms")
    return trace, doc, recent, metrics.report()["counters"]


def test_health_ladder_matches():
    assert _health_trace(t_health) == _health_trace(j_health)


# -- flight -------------------------------------------------------------------

def _flight_export(mod, age_mod):
    fr = mod.FlightRecorder(capacity=4)
    for k in range(6):            # wraps the ring: the oldest two drop
        rec = fr.begin_step(engine=f"eng-{k % 2}")
        t = 10.0 * k
        rec.mark("pack", t - 7.0, t + 1.0)   # under the previous dispatch
        rec.mark("h2d", t + 1.0, t + 1.5)
        rec.mark("dispatch", t + 1.5, t + 4.0 + k)
        if k % 2:
            rec.mark("guard", t + 0.2, t + 0.4)
            rec.mark("lane_fetch", t + 4.0, t + 4.25)
            rec.tenant_mix = (0, k, 2 * k)
        rec.events = 100 + k
        rec.ring = (k % 3, 3)
        sidecar = age_mod.AgeSidecar()
        sidecar.add(t - 0.5, 3)
        sidecar.add(t - 0.001 * k, 2)
        rec.age = sidecar.close(now_s=t + 0.05)
    return fr.export(last_n=8)


def test_flight_export_and_rollups_match():
    ref = _flight_export(j_flight, j_age)
    got = _flight_export(t_flight, t_age)
    assert t_flight.STAGES == j_flight.STAGES
    assert got == ref
    assert got["count"] == 4 and got["rollups"]["steps"] == 4
    assert 0.0 < got["rollups"]["h2d_overlap_fraction"] <= 1.0
    assert "event_age" in got["rollups"]


# -- eventage -----------------------------------------------------------------

def _ages(mod):
    sidecar = mod.AgeSidecar()
    for i in range(mod.AGE_MAX_ENTRIES + 5):      # spills past the cap
        sidecar.add(50.0 - 0.37 * i, 1 + i % 4)
    other = mod.AgeSidecar()
    other.add(49.0, 7)
    sidecar.merge(other)
    summary = sidecar.close(now_s=51.0)
    wire = mod.sidecar_to_wire(sidecar, now_s=51.0)
    back = mod.sidecar_from_wire(wire, now_s=80.0).close(now_s=80.0)
    reg = (j_metrics if mod is j_age else t_metrics).MetricsRegistry()
    mod.observe_summary(mod.age_histogram(reg), summary, engine="e",
                        edge="materialize")
    return (summary.export(), back.export(),
            [summary.quantile_s(q) for q in (0.1, 0.5, 0.9, 0.99, 1.0)],
            [mod.bucket_index(a) for a in (0.0, 1e-4, 3e-4, 0.5, 1e9)],
            wire, reg.prometheus_text())


def test_age_summaries_quantiles_and_wire_match():
    assert t_age.AGE_BUCKET_EDGES_S == j_age.AGE_BUCKET_EDGES_S
    assert _ages(t_age) == _ages(j_age)


# -- lifecycle ----------------------------------------------------------------

def _lifecycle_tree(mod):
    class Node(mod.LifecycleComponent):
        def __init__(self, name, fail_start=False, fail_stop=False):
            super().__init__(name)
            self.fail_start, self.fail_stop = fail_start, fail_stop
            self.calls = []

        def on_start(self, monitor):
            self.calls.append("start")
            if self.fail_start:
                raise RuntimeError(f"{self.name} cannot start")

        def on_stop(self, monitor):
            self.calls.append("stop")
            if self.fail_stop:
                raise RuntimeError(f"{self.name} cannot stop")

    root = Node("root")
    root.tenant_id = "t1"
    ok = root.add_nested(Node("ok"))
    root.add_nested(Node("bad-start", fail_start=True))
    ok.add_nested(Node("leaf", fail_stop=True))
    trees = []
    root.start()
    trees.append(root.state_tree())
    root.stop()
    trees.append(root.state_tree())
    root.restart()
    trees.append(root.state_tree())
    root.terminate()
    trees.append(root.state_tree())
    errors = []
    broken = Node("broken", fail_start=True)
    try:
        broken.start()
    except mod.LifecycleError as exc:
        errors.append(str(exc))
    errors.append(broken.status.value)
    return trees, errors, root.find("leaf").calls, root.is_running()


def test_lifecycle_state_tree_matches():
    assert [s.value for s in t_life.LifecycleStatus] == \
        [s.value for s in j_life.LifecycleStatus]
    assert _lifecycle_tree(t_life) == _lifecycle_tree(j_life)


def test_engine_is_a_lifecycle_component(world):
    from sitewhere_tpu_torch.pipeline.engine import PipelineEngine

    teng = world["teng"]
    assert isinstance(teng, t_life.LifecycleComponent)
    jtree = world["jeng"].state_tree()
    ttree = teng.state_tree()
    assert (ttree["status"], ttree["nested"]) == \
        (jtree["status"], jtree["nested"]) == ("Started", [])
    fresh = PipelineEngine(world["treg"], batch_size=8, device="cpu",
                           name="lifecycle-probe")
    assert fresh.status == t_life.LifecycleStatus.STOPPED
    fresh.start()
    assert fresh.is_running() and fresh.state is not None
    fresh.stop()
    assert fresh.status == t_life.LifecycleStatus.STOPPED


# -- hbmledger ----------------------------------------------------------------

def test_hbm_ledger_tables_match(world):
    from sitewhere_tpu.runtime import hbmledger as j_hbm
    from sitewhere_tpu_torch.runtime import hbmledger as t_hbm

    jeng, teng = world["jeng"], world["teng"]
    jeng._ensure_params()
    teng._ensure_params()
    ref = j_hbm.table_bytes(jeng)
    got = t_hbm.table_bytes(teng)
    assert sorted(got) == sorted(ref) + ["step_graphs"]
    for table in ("device_state", "rule_state", "model_state",
                  "rule_tables", "model_weights", "registry_params",
                  "alert_lanes", "route_lanes", "staging_buffers"):
        assert got[table] == ref[table], table
    assert got["device_state"] > 0 and got["step_graphs"] == 0
    doc = t_hbm.ledger(teng)
    assert doc["total_bytes"] == sum(got.values()) and "device" not in doc
    gauges = t_hbm.export_gauges(teng)
    assert gauges['hbm.table_bytes{table="device_state"}'] == \
        got["device_state"]
    assert gauges["hbm.total_bytes"] == doc["total_bytes"]
