"""The port's pipelined feeder (sitewhere_tpu_torch/pipeline/feed.py) held
against serial submission and the JAX package's engine, on the CPU.

  - PipelinedSubmitter (depth 3, 2 stagers) over seeded traffic in all three
    wire layouts, with rule programs, anomaly models and actuation policies
    installed: every step's alerts (order included) and command fires, and
    every state group and counter at the end, are bit-identical to the
    port's serial `submit` and to the JAX engine's serial `submit`;
  - a staging error (h2d_error past the retry budget, a stager's death)
    surfaces in that step's future, and later steps go on;
  - AdaptiveBatcher keeps the linger, fill, coalesce, chunking and close
    semantics of the reference (tests/test_feed.py, TestAdaptiveBatcher and
    TestAdaptiveLinger).
Tolerance: none, but for the per-row anomaly score (not compared here).
"""

import time

import numpy as np
import pytest

from sitewhere_tpu_torch.model.event import DeviceMeasurement
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.pipeline.feed import (
    AdaptiveBatcher, PipelinedSubmitter)
from sitewhere_tpu_torch.runtime.faults import (
    FaultError, FaultPlan, FaultRule, arm, disarm)

from test_torch_pipeline import _alert_key, make_cols, world  # noqa: F401
from test_torch_pipeline import B, K, M, RULES, T
from test_torch_pipeline_stateful import (
    BUCKETS, MODELS, POLICIES, PROGRAMS, assert_engines_equal)
from test_torch_staging import measurement_batches, port_engine

TRACE = [("compact", 700), ("packed", 701), ("full", 702), ("compact", 703),
         ("packed", 704), ("full", 705), ("compact", 706)]


@pytest.fixture(autouse=True)
def _always_disarm():
    disarm()
    yield
    disarm()


def _columns(base, variant, seed):
    cols = make_cols(seed, variant)
    cols["ts"] = cols["ts"] + np.int32(1000 * (seed % 7))
    args = (cols["device_idx"], cols["event_type"],
            base + cols["ts"].astype(np.int64))
    kw = {k: cols[k] for k in ("mm_idx", "value", "lat", "lon", "elevation",
                               "alert_type_idx", "alert_level")}
    return args, kw


@pytest.fixture(scope="module")
def feed_engines(world):
    """A JAX engine, a port engine fed serially and a port engine fed by
    the pipelined submitter, over the world's registry with its rules and
    every stateful family installed."""
    from sitewhere_tpu.pipeline import engine as jengine

    kwargs = dict(batch_size=B, measurement_slots=M, max_tenants=T,
                  max_threshold_rules=16, max_geofence_rules=8,
                  alert_lane_capacity=K, **BUCKETS)
    jeng = jengine.PipelineEngine(world["jreg"], name="torch-feed-ref",
                                  **kwargs)
    serial = tengine.PipelineEngine(world["treg"], device="cpu",
                                    name="torch-feed-serial", **kwargs)
    piped = tengine.PipelineEngine(world["treg"], device="cpu",
                                   name="torch-feed-piped", **kwargs)
    for eng, mod in ((jeng, jengine), (serial, tengine), (piped, tengine)):
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
    return jeng, serial, piped


def test_pipelined_equals_serial_and_reference(feed_engines):
    jeng, serial, piped = feed_engines
    base = jeng.packer.epoch_base_ms
    batches, ref_alerts, ref_fires = [], [], []
    for variant, seed in TRACE:
        args, kw = _columns(base, variant, seed)
        jb, jout = jeng.submit_routed(jeng.packer.pack_columns(*args, **kw))
        ref_alerts.append([_alert_key(a)
                           for a in jeng.materialize_alerts(jb, jout)])
        ref_fires.append(jeng.take_command_fires())
        tb = serial.packer.pack_columns(*args, **kw)
        out = serial.submit(tb)
        assert [_alert_key(a) for a in serial.materialize_alerts(tb, out)] \
            == ref_alerts[-1]
        assert serial.take_command_fires() == ref_fires[-1]
        batches.append(piped.packer.pack_columns(*args, **kw))
    sub = PipelinedSubmitter(piped, depth=3, stagers=2)
    futs = [sub.submit(b) for b in batches]
    sub.flush()
    for i, (b, fut) in enumerate(zip(batches, futs)):
        got = piped.materialize_alerts(b, fut.result(timeout=60))
        assert [_alert_key(a) for a in got] == ref_alerts[i], i
        assert piped.take_command_fires() == ref_fires[i], i
    sub.close()
    assert sum(map(len, ref_alerts)) > 0 and sum(map(len, ref_fires)) > 0
    assert_engines_equal((jeng, piped))
    assert_engines_equal((jeng, serial))
    assert piped.batches_processed == serial.batches_processed == len(TRACE)
    assert piped.staging_ring.occupancy() == 0


# the stager's death is the drill: its thread ends on the injected error
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_staging_error_surfaces_in_the_future():
    eng = port_engine("torch-feed-errors", depth=3)
    batches = measurement_batches(eng, 4)
    sub = PipelinedSubmitter(eng, depth=3, stagers=2)
    arm(FaultPlan(seed=11, rules=[FaultRule("h2d_error", times=3)]))
    first = sub.submit(batches[0])
    with pytest.raises(FaultError, match="h2d_error"):
        first.result(timeout=60)
    disarm()
    assert int(sub.submit(batches[1]).result(timeout=60).processed) == 16
    arm(FaultPlan(seed=11, rules=[FaultRule("feeder_thread_death",
                                            times=1)]))
    dead = sub.submit(batches[2])
    with pytest.raises(FaultError, match="feeder_thread_death"):
        dead.result(timeout=60)
    disarm()
    # one stager died; the other carries on
    assert int(sub.submit(batches[3]).result(timeout=60).processed) == 16
    sub.flush()
    sub.close()
    assert eng.batches_processed == 2
    assert eng.staging_ring.occupancy() == 0
    with pytest.raises(RuntimeError, match="closed"):
        sub.submit(batches[0])


# -- AdaptiveBatcher (tests/test_feed.py TestAdaptiveBatcher) -----------------

def _batcher(name, linger_ms=30.0, batch_size=32, **kw):
    engine = port_engine(name, batch_size=batch_size)
    return engine, AdaptiveBatcher(engine, linger_ms=linger_ms, **kw)


def _measurements(values):
    return [DeviceMeasurement(name="m", value=v) for v in values]


def test_batcher_linger_flush_and_alerts():
    engine, batcher = _batcher("torch-feed-linger", linger_ms=20.0)
    t0 = time.perf_counter()
    fut = batcher.offer(_measurements([150.0 + i for i in range(4)]),
                        [f"d{i}" for i in range(4)])
    pairs = fut.result(timeout=120.0)
    waited = time.perf_counter() - t0
    assert waited >= 0.015     # a partial batch flushes at the deadline
    [(batch, outputs)] = pairs
    assert len(engine.materialize_alerts(batch, outputs)) == 4
    batcher.close()


def test_batcher_empty_offer_resolves_immediately():
    _, batcher = _batcher("torch-feed-empty", linger_ms=10_000.0)
    assert batcher.offer([], []).result(timeout=1.0) == []
    batcher.close()


def test_batcher_overflow_flush_covers_every_chunk():
    engine, batcher = _batcher("torch-feed-chunks", linger_ms=20.0,
                               batch_size=8)
    fut = batcher.offer(_measurements([150.0 + i for i in range(20)]),
                        [f"d{i % 16}" for i in range(20)])
    pairs = fut.result(timeout=120.0)
    assert len(pairs) == 3     # 20 events / batch 8
    alerts = [a for batch, outputs in pairs
              for a in engine.materialize_alerts(batch, outputs)]
    assert len(alerts) == 20
    batcher.close()


def test_batcher_fill_flushes_before_linger():
    _, batcher = _batcher("torch-feed-fill", linger_ms=10_000.0,
                          batch_size=8)
    t0 = time.perf_counter()
    batcher.offer(_measurements([1.0] * 8),
                  [f"d{i}" for i in range(8)]).result(timeout=120.0)
    assert time.perf_counter() - t0 < 60.0   # never waits out 10 s
    batcher.close()


def test_batcher_offers_coalesce_into_one_flush():
    engine, batcher = _batcher("torch-feed-coalesce", linger_ms=60.0)
    f1 = batcher.offer(_measurements([1.0]), ["d0"])
    f2 = batcher.offer(_measurements([2.0]), ["d1"])
    [(_, o1)] = f1.result(timeout=120.0)
    [(_, o2)] = f2.result(timeout=120.0)
    assert o1 is o2            # one step covered both offers
    assert engine.batches_processed == 1
    batcher.close()


def test_batcher_close_flushes_pending_then_refuses():
    _, batcher = _batcher("torch-feed-close", linger_ms=10_000.0)
    fut = batcher.offer(_measurements([1.0]), ["d0"])
    batcher.close()            # pending rows flush, not vanish
    [(_, outputs)] = fut.result(timeout=5.0)
    assert outputs is not None
    with pytest.raises(RuntimeError):
        batcher.offer(_measurements([1.0]), ["d0"])


def test_adaptive_burst_dispatches_without_sleeping_out_linger():
    engine, batcher = _batcher("torch-feed-adaptive", linger_ms=5_000.0,
                               adaptive=True)
    assert batcher.warm(_measurements([150.0]), ["d0"]) == 2
    t0 = time.perf_counter()
    fut = batcher.offer(_measurements([150.0 + i for i in range(4)]),
                        [f"d{i}" for i in range(4)])
    [(batch, outputs)] = fut.result(timeout=120.0)
    assert time.perf_counter() - t0 < 4.0
    assert len(engine.materialize_alerts(batch, outputs)) == 4
    assert batcher.steady_flushes == 1
    batcher.close()


def test_adaptive_alerts_and_close_semantics_unchanged():
    engine, batcher = _batcher("torch-feed-adaptive-close",
                               linger_ms=10_000.0, adaptive=True)
    fut = batcher.offer(_measurements([150.0]), ["d0"])
    [(batch, outputs)] = fut.result(timeout=120.0)
    assert len(engine.materialize_alerts(batch, outputs)) == 1
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.offer(_measurements([1.0]), ["d0"])
