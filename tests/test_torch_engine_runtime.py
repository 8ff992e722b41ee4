"""The port engine's host runtime held against the JAX package's engine, on
the CPU.

  - fault drills: the same seeded plans of `h2d_error`, `dispatch_error` and
    `lane_fetch_error` on both engines are absorbed by the bounded retries
    with the same `step_retries` delta, the same health transitions and
    identical state; a retry budget run out raises, the consumer parks the
    batch and marks the engine draining, and the engine keeps stepping and
    recovers;
  - flight records: a synchronous submit's segments sum to its wall within
    the reference's bounds (tests/test_flight.py), a pipelined step's record
    carries pack, h2d, dispatch, lane_fetch and materialize, the tenant mix
    is sampled every 16th step as the reference samples it, and the age
    sidecar closes at materialize;
  - the static-buffer step: the function the engine captures into a graph
    on the card (`_step_into_state`), run eagerly here with every family
    installed, is bit-equal to the jitted JAX step and leaves every state
    group and the params in the same storage — across steps, a presence
    sweep, a params refresh and the load_canonical_* paths.
Tolerance: none, but the per-row anomaly score (rtol=1e-4, atol=1e-5, the
reference's own).
"""

import dataclasses
import statistics
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.pipeline import engine as jengine
from sitewhere_tpu.runtime import faults as j_faults
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.pipeline.feed import PipelinedSubmitter
from sitewhere_tpu_torch.runtime import faults as t_faults
from sitewhere_tpu_torch.runtime.eventage import AgeSidecar, AgeSummary
from sitewhere_tpu_torch.runtime.flight import STAGES, FlightRecorder
from sitewhere_tpu_torch.runtime.health import DRAINING, HEALTHY
from sitewhere_tpu_torch.tree import tree_leaves

from test_torch_pipeline import (  # noqa: F401 (fixture)
    B, K, M, RULES, T, _alert_key, _blob_for, make_cols, world)
from test_torch_pipeline_stateful import (
    BUCKETS, MODELS, POLICIES, PROGRAMS, assert_engines_equal,
    assert_outputs_equal)
from test_torch_staging import (
    assert_same_state, jax_engine, measurement_batches, port_engine)


@pytest.fixture(autouse=True)
def _always_disarm():
    j_faults.disarm()
    t_faults.disarm()
    yield
    j_faults.disarm()
    t_faults.disarm()


def _pair(name):
    """A JAX engine and a port engine over the same small world, one
    packer epoch, health recovering after 3 clean steps."""
    jeng = jax_engine(f"{name}-ref")
    teng = port_engine(name, epoch_base_ms=jeng.packer.epoch_base_ms)
    for eng in (jeng, teng):
        eng.health.recover_after = 3
    return jeng, teng


def _consume(eng, batch, parked):
    """What the reference's consumer layer does with one batch
    (pipeline/inbound.py): submit and materialize; a step that runs out of
    retries parks the batch and marks the engine draining."""
    try:
        routed, out = eng.submit_routed(batch)
        return len(eng.materialize_alerts(routed, out))
    except Exception as exc:
        parked.append((type(exc).__name__, str(exc)))
        eng.health.note_poison()
        return None


def _health(eng):
    doc = eng.health.to_json()
    return (doc["state"], doc["transitions"], doc["last_cause"],
            [(r["state"], r["cause"]) for r in doc["recent"]])


DRILLS = {
    "h2d_error": [{"point": "h2d_error", "times": 2, "after": 1}],
    "dispatch_error": [{"point": "dispatch_error", "p": 0.5, "times": 5}],
    "lane_fetch_error": [{"point": "lane_fetch_error", "times": 2,
                          "after": 2}],
    "mixed": [{"point": "h2d_error", "p": 0.3},
              {"point": "dispatch_error", "p": 0.2},
              {"point": "lane_fetch_error", "p": 0.3}],
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_fault_drill_absorbed_like_the_reference(drill):
    jeng, teng = _pair(f"torch-drill-{drill}")
    jbatches = measurement_batches(jeng, 8)
    tbatches = measurement_batches(teng, 8)
    doc = {"seed": 20260101, "rules": DRILLS[drill]}
    trace = {}
    for eng, batches, faults in ((jeng, jbatches, j_faults),
                                 (teng, tbatches, t_faults)):
        retries0 = eng._retry_counter.value
        plan = faults.FaultPlan.from_json(doc)
        faults.arm(plan)
        parked, alerts = [], []
        for batch in batches:
            alerts.append(_consume(eng, batch, parked))
        faults.disarm()
        trace[eng] = (alerts, parked, eng._retry_counter.value - retries0,
                      plan.report(), _health(eng))
    assert trace[teng] == trace[jeng]
    alerts, parked, retries, report, _ = trace[teng]
    assert not parked and retries > 0        # absorbed by the retries
    assert sum(r["fires"] for r in report["rules"]) > 0
    assert_same_state(jeng, teng)


def test_exhausted_retries_park_drain_and_recover():
    jeng, teng = _pair("torch-drill-exhaust")
    doc = {"seed": 5, "rules": [{"point": "dispatch_error", "times": 3,
                                 "after": 2}]}
    trace = {}
    for eng, faults in ((jeng, j_faults), (teng, t_faults)):
        batches = measurement_batches(eng, 8)
        faults.arm(faults.FaultPlan.from_json(doc))
        parked, alerts, states = [], [], []
        for batch in batches:
            alerts.append(_consume(eng, batch, parked))
            states.append(eng.health.state)
        faults.disarm()
        trace[eng] = (alerts, parked, states, _health(eng),
                      eng.batches_processed)
    assert trace[teng] == trace[jeng]
    alerts, parked, states, health, _ = trace[teng]
    assert parked == [("FaultError", "injected fault: dispatch_error")]
    assert alerts[2] is None and states[2] == DRAINING
    assert states[-1] == HEALTHY            # kept stepping and recovered
    assert_same_state(jeng, teng)


# -- flight -------------------------------------------------------------------

def test_sync_submit_segments_sum_to_wall():
    eng = port_engine("torch-flight-sync")
    eng.flight = FlightRecorder(capacity=64)
    batches = measurement_batches(eng, 18)
    for batch in batches[:3]:
        eng.submit(batch)
    ratios = []
    for batch in batches[3:]:
        t0 = time.perf_counter()
        eng.submit(batch)
        wall = time.perf_counter() - t0
        rec = eng._flight_last
        ratios.append(sum(rec.stage_s(s) for s in STAGES) / wall)
        assert rec.stage_s("pack") > 0 and rec.stage_s("dispatch") > 0
    assert 0.5 <= statistics.median(ratios) <= 1.05, ratios


def test_pipelined_record_carries_every_stage():
    eng = port_engine("torch-flight-piped")
    eng.flight = FlightRecorder(capacity=16)
    sub = PipelinedSubmitter(eng, depth=3, stagers=2)
    batch = measurement_batches(eng, 1)[0]
    out = sub.submit(batch).result(timeout=60)
    sub.flush()
    sub.close()
    eng.materialize_alerts(batch, out)
    rec = eng.flight.export(last_n=1)["records"][-1]
    assert {"pack", "h2d", "dispatch", "lane_fetch", "materialize",
            "actuate"} <= set(rec["stages"]), rec["stages"]
    assert rec["events"] == 16 and rec["ring"]["depth"] == 3


def test_tenant_mix_sampled_every_16th_step(world):
    from sitewhere_tpu.runtime.flight import FlightRecorder as JRecorder

    kwargs = dict(batch_size=B, measurement_slots=M, max_tenants=T,
                  max_threshold_rules=16, max_geofence_rules=8,
                  alert_lane_capacity=K)
    jeng = jengine.PipelineEngine(world["jreg"], name="torch-mix-ref",
                                  **kwargs)
    teng = tengine.PipelineEngine(world["treg"], device="cpu",
                                  name="torch-mix", **kwargs)
    jeng.flight, teng.flight = JRecorder(capacity=64), FlightRecorder(64)
    mixes = {}
    for eng in (jeng, teng):
        eng.packer.epoch_base_ms = jeng.packer.epoch_base_ms
        eng.start()
        for step in range(33):
            cols = make_cols(900 + step, "compact")
            args = (cols["device_idx"], cols["event_type"],
                    eng.packer.epoch_base_ms + cols["ts"].astype(np.int64))
            eng.submit(eng.packer.pack_columns(*args))
        mixes[eng] = [r.get("tenant_mix")
                      for r in eng.flight.export(64)["records"]]
    assert mixes[teng] == mixes[jeng]
    sampled = [i for i, mix in enumerate(mixes[teng]) if mix is not None]
    assert sampled == [15, 31] and sum(mixes[teng][15]) > 0


def test_age_sidecar_closes_at_materialize():
    from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

    eng = port_engine("torch-age-close")
    hist = GLOBAL_METRICS.histogram("pipeline.event_age_seconds")
    child = hist.child(engine=eng.name, edge="materialize")
    before = child.count
    sidecar = AgeSidecar()
    sidecar.add(time.perf_counter() - 0.01, 10)
    sidecar.add(None, 6)
    batch = measurement_batches(eng, 1)[0]
    routed, out = eng.submit_routed(batch, age=sidecar)
    rec = eng._flight_last
    assert rec.age is sidecar
    eng.materialize_alerts(routed, out)
    assert isinstance(rec.age, AgeSummary) and rec.age.count == 16
    assert rec.age.max_s >= 0.01
    assert child.count == before + 16
    assert eng.flight.export(last_n=1)["records"][-1]["age"]["count"] == 16


# -- the static-buffer step -----------------------------------------------------

def _storage(eng):
    return [t.data_ptr() for group in (eng._state, eng._rule_state,
                                       eng._model_state, eng._actuation_state,
                                       eng._params)
            for t in tree_leaves(group)]


@pytest.fixture(scope="module")
def stateful_pair(world):
    kwargs = dict(batch_size=B, measurement_slots=M, max_tenants=T,
                  max_threshold_rules=16, max_geofence_rules=8,
                  alert_lane_capacity=K,
                  presence_missing_interval_ms=500, **BUCKETS)
    jeng = jengine.PipelineEngine(world["jreg"], name="torch-static-ref",
                                  **kwargs)
    teng = tengine.PipelineEngine(world["treg"], device="cpu",
                                  name="torch-static", **kwargs)
    for eng, mod in ((jeng, jengine), (teng, tengine)):
        eng.packer.epoch_base_ms = jeng.packer.epoch_base_ms
        for name in ("m1", "m2", "m3"):
            eng.packer.measurements.intern(name)
        for spec in RULES:
            eng.upsert_rule(*mod.rule_from_dict(dict(spec)))
        for spec in PROGRAMS:
            eng.upsert_rule_program(dict(spec))
        for spec in MODELS:
            eng.upsert_anomaly_model(dict(spec))
        for spec in POLICIES:
            eng.upsert_actuation_policy(dict(spec))
        eng.start()
    return jeng, teng


def test_captured_function_is_bit_equal_and_keeps_storage(stateful_pair,
                                                          monkeypatch):
    jeng, teng = stateful_pair
    jparams = jeng._ensure_params()
    tparams = teng._ensure_params()
    storage = _storage(teng)
    js = [jeng._state, jeng._rule_state, jeng._model_state,
          jeng._actuation_state]
    for step, (variant, seed) in enumerate([("compact", 800),
                                            ("full", 801), ("packed", 802),
                                            ("compact", 803)]):
        cols = make_cols(seed, variant)
        cols["ts"] = cols["ts"] + np.int32(1000 * step)
        blob = _blob_for(cols, variant)
        *js, jout = jeng._step_blob(jparams, *js, jnp.asarray(blob))
        tout = teng._step_into_state(torch.from_numpy(blob))
        assert_outputs_equal(jout, tout, f"step {step}")
        assert _storage(teng) == storage, f"step {step}"
        assert teng._ensure_params() is tparams
    jeng._state, jeng._rule_state, jeng._model_state, \
        jeng._actuation_state = js
    assert_engines_equal((jeng, teng))
    assert teng.graph_captures == 0         # the CPU never captures

    # presence sweep: the new presence columns go into the same buffers
    base = jeng.packer.epoch_base_ms
    monkeypatch.setattr(time, "time", lambda: (base + 5000) / 1000.0)
    missing = teng.presence_sweep()
    assert missing == jeng.presence_sweep() and missing
    assert _storage(teng) == storage
    assert_engines_equal((jeng, teng))

    # a params refresh (a rule edit) copies into the resident tables
    for eng, mod in ((jeng, jengine), (teng, tengine)):
        eng.upsert_rule(*mod.rule_from_dict(dict(RULES[0], threshold=10.0)))
    args, kw = _columns(base + 9000, 804)
    tb = teng.packer.pack_columns(*args, **kw)
    jb = jeng.packer.pack_columns(*args, **kw)
    tout, jout = teng.submit(tb), jeng.submit(jb)
    assert_outputs_equal(jout, tout, "after a rule edit")
    assert [_alert_key(a) for a in teng.materialize_alerts(tb, tout)] == \
        [_alert_key(a) for a in jeng.materialize_alerts(jb, jout)]
    assert _storage(teng) == storage

    # the load_canonical_* paths copy into the same buffers
    teng.load_canonical_state(convert.state_from_numpy(
        dataclasses.asdict(jeng.canonical_state()), "cpu"))
    for group in ("rule", "model", "actuation"):
        getattr(teng, f"load_canonical_{group}_state")(
            getattr(convert, f"{group}_state_from_numpy")(
                getattr(convert, f"{group}_state_to_numpy")(
                    getattr(jeng, f"canonical_{group}_state")()), "cpu"))
    assert _storage(teng) == storage
    assert_engines_equal((jeng, teng))


def _columns(base, seed):
    cols = make_cols(seed, "compact")
    args = (cols["device_idx"], cols["event_type"],
            base + cols["ts"].astype(np.int64))
    kw = {k: cols[k] for k in ("mm_idx", "value", "lat", "lon", "elevation",
                               "alert_type_idx", "alert_level")}
    return args, kw
