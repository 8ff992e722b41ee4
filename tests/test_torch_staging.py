"""The port's H2D staging ring (sitewhere_tpu_torch/pipeline/staging.py) held
against the JAX package's (sitewhere_tpu/pipeline/staging.py), on the CPU.

The same acquire/release/order scripts run through both rings and must
give the same grants, grant order, `full_waits`, occupancy and guard waits
(guard-free release on error paths included). Then the ring inside the
port's engine, mirroring the single-device cases of tests/test_staging_ring.py:
pipelined feeding at ring depth 3 and depth 1 gives the state and outputs
of plain sequential submits, and of the JAX engine's; explicit stage_blob;
backpressure; a stalled dispatch keeps order; h2d_error retries and, past
the budget, releases the slot without disturbing its neighbour; flight
records carry the ring snapshot; the HBM ledger and the full-waits counter
see the ring. Tolerance: none.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu.pipeline import staging as j_staging
from sitewhere_tpu.runtime import faults as j_faults
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.ops.pack import batch_to_blob
from sitewhere_tpu_torch.pipeline import staging as t_staging
from sitewhere_tpu_torch.pipeline.engine import PipelineEngine, ThresholdRule
from sitewhere_tpu_torch.pipeline.feed import PipelinedSubmitter
from sitewhere_tpu_torch.runtime.faults import (
    FaultError, FaultPlan, FaultRule, arm, disarm)

RINGS = (j_staging, t_staging)
N_DEVICES = 16


@pytest.fixture(autouse=True)
def _always_disarm():
    disarm()
    j_faults.disarm()
    yield
    disarm()
    j_faults.disarm()


# -- small worlds, shared with the port's feed and engine-runtime tests ------

def jax_world(n_devices=N_DEVICES, capacity=64):
    """The reference tests' world: n devices d0.. of one type, each with an
    active assignment, in one tenant."""
    from sitewhere_tpu.model import Device, DeviceAssignment, DeviceType
    from sitewhere_tpu.registry import DeviceManagement, RegistryTensors

    dm = DeviceManagement()
    dtype = dm.create_device_type(DeviceType(token="t"))
    tensors = RegistryTensors(capacity, 4, 4)
    for i in range(n_devices):
        device = dm.create_device(Device(token=f"d{i}",
                                         device_type_id=dtype.id))
        dm.create_device_assignment(
            DeviceAssignment(token=f"a{i}", device_id=device.id))
    tensors.attach(dm, "tenant")
    return tensors


def port_registry(jreg):
    """The port's registry mirror of a JAX registry (same indices)."""
    return convert.registry_from_snapshot(
        dataclasses.asdict(jreg.snapshot()), jreg.devices.snapshot(),
        jreg.tenants.snapshot(),
        device_type_tokens=jreg.device_types.snapshot(),
        zone_tokens=jreg.zones_interner.snapshot(),
        area_tokens=jreg.areas.snapshot(),
        assignment_tokens=jreg.assignments.snapshot())


def port_engine(name, batch_size=32, depth=3, epoch_base_ms=None, **kw):
    """A started port engine over a fresh small world with the reference
    tests' threshold rule (m > 100)."""
    eng = PipelineEngine(port_registry(jax_world()), batch_size=batch_size,
                         h2d_buffer_depth=depth, device="cpu", name=name,
                         **kw)
    if epoch_base_ms is not None:
        eng.packer.epoch_base_ms = epoch_base_ms
    eng.start()
    eng.add_threshold_rule(ThresholdRule(
        token="r", measurement_name="m", operator=">", threshold=100.0))
    return eng


def jax_engine(name, batch_size=32, depth=3, **kw):
    from sitewhere_tpu.pipeline.engine import PipelineEngine as JEngine
    from sitewhere_tpu.pipeline.engine import ThresholdRule as JRule

    eng = JEngine(jax_world(), batch_size=batch_size, h2d_buffer_depth=depth,
                  name=name, **kw)
    eng.start()
    eng.add_threshold_rule(JRule(token="r", measurement_name="m",
                                 operator=">", threshold=100.0))
    return eng


def measurement_batches(engine, n_batches, n_devices=N_DEVICES, k0=0):
    """The reference tests' traffic: batch k carries m = 100k + i for
    device i, dated 1000 + 50k + i."""
    from sitewhere_tpu.model import DeviceMeasurement as JM
    from sitewhere_tpu_torch.model.event import DeviceMeasurement as TM

    cls = TM if isinstance(engine, PipelineEngine) else JM
    out = []
    for k in range(k0, k0 + n_batches):
        events = [cls(name="m", value=float(k * 100 + i),
                      event_date=1000 + k * 50 + i)
                  for i in range(n_devices)]
        out.append(engine.packer.pack_events(
            events, [f"d{i}" for i in range(n_devices)])[0])
    return out


def assert_same_state(ref, got):
    """Canonical device state bit-equal (either engine kind)."""
    a, b = ref.canonical_state(), got.canonical_state()
    for f in dataclasses.fields(a):
        x = np.asarray(getattr(a, f.name))
        y = np.asarray(getattr(b, f.name))
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(y, x, err_msg=f.name)


# -- the ring alone, both packages -------------------------------------------

class Guard:
    """A guard the test can see waited on: the reference's ring blocks with
    block_until_ready(), the port's with synchronize()."""

    def __init__(self, log):
        self.log = log

    def block_until_ready(self):
        self.log.append("waited")

    synchronize = block_until_ready


def _script_clamp_and_nonblocking(mod):
    ring = mod.StagingRing(0)
    out = [ring.depth]
    ring = mod.StagingRing(2)
    out.append(ring.state())
    a, b = ring.acquire(), ring.acquire()
    out.append(ring.acquire(blocking=False) is None)
    ring.release(a)
    out.append(ring.acquire(blocking=False) is a)
    out.append(ring.state())
    return out


def _script_ordered_grant(mod):
    ring = mod.StagingRing(1)
    held = ring.acquire(order=0)
    got = []

    def _waiter(seq):
        slot = ring.acquire(order=seq)
        got.append(seq)
        ring.release(slot)

    late = threading.Thread(target=_waiter, args=(7,))
    late.start()
    time.sleep(0.05)            # the later sequence queues FIRST
    early = threading.Thread(target=_waiter, args=(3,))
    early.start()
    time.sleep(0.05)
    ring.release(held)
    early.join(timeout=5)
    late.join(timeout=5)
    assert not early.is_alive() and not late.is_alive()
    return got, ring.full_waits, ring.occupancy(), ring.acquires


def _script_unordered_never_starves(mod):
    ring = mod.StagingRing(1)
    held = ring.acquire()
    got = []

    def _take(order, tag):
        slot = ring.acquire(order=order)
        got.append(tag)
        ring.release(slot)

    t1 = threading.Thread(target=_take, args=(None, "unordered"))
    t1.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=_take, args=(5, "ordered"))
    t2.start()
    time.sleep(0.05)
    ring.release(held)
    t2.join(timeout=5)
    t1.join(timeout=5)
    assert not t1.is_alive() and not t2.is_alive()
    return got, ring.full_waits, ring.occupancy()


def _script_guard_and_idempotent_release(mod):
    ring = mod.StagingRing(1)
    slot = ring.acquire()
    log = []
    ring.release(slot, guard=Guard(log))
    ring.release(slot)          # double release: no-op
    out = [ring.occupancy(), ring.acquire(blocking=False) is slot, list(log)]
    ring.release(slot)          # error-path release: no guard
    out += [ring.acquire(blocking=False) is slot, list(log), ring.state()]
    return out


def _script_resident_bytes(mod):
    ring = mod.StagingRing(2)
    slot = ring.acquire()
    slot.device_blob = np.zeros((5, 8), np.int32)
    out = [ring.resident_bytes(), ring.state()]
    ring.release(slot)
    ring.acquire()              # the other slot
    ring.acquire()              # the parked slot: its transfer dropped
    out.append(ring.resident_bytes())
    return out


def _script_full_waits_metrics(mod):
    from sitewhere_tpu.runtime.metrics import MetricsRegistry as JR
    from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry as TR

    reg = (JR if mod is j_staging else TR)()
    ring = mod.StagingRing(1, metrics=reg.scoped("pipeline.x"))
    held = ring.acquire(order=0)
    th = threading.Thread(
        target=lambda: ring.release(ring.acquire(order=1)))
    th.start()
    time.sleep(0.05)
    ring.release(held)
    th.join(timeout=5)
    assert not th.is_alive()
    return reg.report()["counters"], ring.state()


@pytest.mark.parametrize("script", [
    _script_clamp_and_nonblocking, _script_ordered_grant,
    _script_unordered_never_starves, _script_guard_and_idempotent_release,
    _script_resident_bytes, _script_full_waits_metrics],
    ids=lambda f: f.__name__[len("_script_"):])
def test_ring_scripts_match_reference(script):
    ref, got = (script(mod) for mod in RINGS)
    assert got == ref


def test_port_slot_keeps_its_fixed_buffer():
    """A slot's fixed device buffer (the card's staging destination) stays
    across reuse and counts as resident; the parked view is dropped."""
    ring = t_staging.StagingRing(1)
    slot = ring.acquire()
    slot.buffers = [torch.zeros((5, 8), dtype=torch.int32)]
    slot.device_blob = slot.buffers[0][:4]
    assert ring.resident_bytes() == 5 * 8 * 4
    ring.release(slot)
    assert ring.acquire() is slot
    assert slot.device_blob is None and slot.buffers
    assert ring.resident_bytes() == 5 * 8 * 4


# -- the ring inside the port's engine ----------------------------------------

def test_pipelined_depth3_and_depth1_equal_sequential_and_reference():
    jeng = jax_engine("torch-staging-ref")
    base = jeng.packer.epoch_base_ms
    seq = port_engine("torch-staging-seq", epoch_base_ms=base)
    d1 = port_engine("torch-staging-d1", depth=1, epoch_base_ms=base)
    d3 = port_engine("torch-staging-d3", depth=3, epoch_base_ms=base)
    batches = measurement_batches(seq, 12)
    ref_outs = [jeng.submit(b) for b in measurement_batches(jeng, 12)]
    seq_outs = [seq.submit(b) for b in batches]
    for eng in (d1, d3):
        sub = PipelinedSubmitter(eng, depth=3, stagers=2)
        futs = [sub.submit(b) for b in batches]
        sub.flush()
        outs = [f.result(timeout=60) for f in futs]
        sub.close()
        for got, want, ref in zip(outs, seq_outs, ref_outs):
            for name in ("valid", "threshold_fired", "alert_lanes",
                         "command_lanes", "processed", "alerts"):
                assert torch.equal(getattr(got, name), getattr(want, name))
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(),
                    np.asarray(getattr(ref, name)), err_msg=name)
        assert_same_state(seq, eng)
        assert eng.staging_ring.occupancy() == 0
    assert_same_state(jeng, seq)
    assert (d1.staging_ring.depth, d3.staging_ring.depth) == (1, 3)


def test_explicit_stage_blob_roundtrip():
    eng = port_engine("torch-staging-explicit", depth=2)
    staged = eng.stage_blob(batch_to_blob(measurement_batches(eng, 1)[0]))
    assert isinstance(staged, t_staging.StagedBlob)
    assert eng.staging_ring.occupancy() == 1
    out = eng.submit_blob(staged)
    assert int(out.processed) == N_DEVICES
    assert eng.staging_ring.occupancy() == 0


def test_feeder_order_preserved_under_slow_dispatch_stall():
    ref = port_engine("torch-staging-stall-ref")
    eng = port_engine("torch-staging-stall", depth=2,
                      epoch_base_ms=ref.packer.epoch_base_ms)
    batches = measurement_batches(ref, 16)
    for b in batches:
        ref.submit(b)
    real = eng.submit_blob

    def slow(blob, n_events=None, flight_rec=None):
        time.sleep(0.02)        # dispatch is the slow stage
        return real(blob, n_events=n_events, flight_rec=flight_rec)

    eng.submit_blob = slow
    sub = PipelinedSubmitter(eng, depth=4, stagers=3)
    last = None
    for b in batches:
        last = sub.submit(b)
    sub.flush()
    last.result(timeout=60)
    sub.close()
    assert_same_state(ref, eng)
    assert eng.staging_ring.full_waits > 0
    assert eng.staging_ring.occupancy() == 0


def test_backpressure_bounds_in_flight_transfers():
    eng = port_engine("torch-staging-bp", depth=2)
    blob = batch_to_blob(measurement_batches(eng, 1)[0])
    s1, s2 = eng.stage_blob(blob), eng.stage_blob(blob)
    assert eng.staging_ring.occupancy() == 2
    staged3 = []
    th = threading.Thread(target=lambda: staged3.append(eng.stage_blob(blob)))
    th.start()
    time.sleep(0.1)
    assert not staged3          # blocked: ring full
    assert eng.staging_ring.full_waits >= 1
    out = eng.submit_blob(s1)   # dispatch frees slot 1
    th.join(timeout=10)
    assert not th.is_alive() and len(staged3) == 1
    assert int(out.processed) == N_DEVICES
    eng.submit_blob(s2)
    eng.submit_blob(staged3[0])
    assert eng.staging_ring.occupancy() == 0


def test_h2d_error_in_slot_retries_with_backoff():
    eng = port_engine("torch-staging-retry", depth=2)
    blob = batch_to_blob(measurement_batches(eng, 1)[0])
    retries0 = eng._retry_counter.value
    arm(FaultPlan(seed=29, rules=[FaultRule("h2d_error", times=1)]))
    t0 = time.perf_counter()
    staged = eng.stage_blob(blob)
    elapsed = time.perf_counter() - t0
    disarm()
    assert eng._retry_counter.value == retries0 + 1
    assert elapsed >= 0.005     # the retry backed off before re-issuing
    assert int(eng.submit_blob(staged).processed) == N_DEVICES


def test_exhaustion_releases_slot_and_spares_neighbors():
    ref = port_engine("torch-staging-exh-ref")
    eng = port_engine("torch-staging-exh", depth=3,
                      epoch_base_ms=ref.packer.epoch_base_ms)
    batches = measurement_batches(ref, 3)
    ref_outs = [ref.submit(b) for b in batches]
    neighbor = eng.stage_blob(batch_to_blob(batches[0]), order=0)
    arm(FaultPlan(seed=29, rules=[FaultRule("h2d_error", times=8)]))
    with pytest.raises(FaultError):
        eng.stage_blob(batch_to_blob(batches[1]), order=1)
    disarm()
    assert eng.staging_ring.occupancy() == 1     # only the neighbor
    out0 = eng.submit_blob(neighbor)
    assert torch.equal(out0.threshold_fired, ref_outs[0].threshold_fired)
    for i in (1, 2):
        out = eng.submit_blob(eng.stage_blob(batch_to_blob(batches[i])))
        assert int(out.processed) == int(ref_outs[i].processed)
    assert_same_state(ref, eng)
    assert eng.staging_ring.occupancy() == 0


def test_flight_records_carry_ring_snapshot_and_rollup():
    from sitewhere_tpu_torch.runtime.flight import FlightRecorder

    eng = port_engine("torch-staging-flight", depth=2)
    eng.flight = FlightRecorder(capacity=16)
    sub = PipelinedSubmitter(eng, depth=3, stagers=2)
    last = None
    for b in measurement_batches(eng, 6):
        last = sub.submit(b)
    sub.flush()
    last.result(timeout=60)
    sub.close()
    export = eng.flight.export(last_n=6)
    ringed = [r for r in export["records"] if "ring" in r]
    assert len(ringed) == 6 and all(r["ring"]["depth"] == 2 for r in ringed)
    assert all({"pack", "h2d", "dispatch"} <= set(r["stages"])
               for r in ringed)
    roll = export["rollups"]["staging_ring"]
    assert roll["depth"] == 2 and 0 < roll["mean_occupancy"] <= 2
    assert 1 <= roll["max_occupancy"] <= 2


def test_hbm_ledger_counts_parked_ring_bytes():
    from sitewhere_tpu_torch.runtime.hbmledger import table_bytes

    eng = port_engine("torch-staging-hbm", depth=2)
    assert table_bytes(eng)["staging_ring"] == 0      # ring unused
    staged = eng.stage_blob(batch_to_blob(measurement_batches(eng, 1)[0]))
    assert table_bytes(eng)["staging_ring"] == int(staged.blob.nbytes)
    eng.submit_blob(staged)


def test_full_waits_counted_in_engine_metrics():
    eng = port_engine("torch-staging-waits", depth=1)
    counter = eng._metrics.counter("staging_ring.full_waits")
    before = counter.value
    blob = batch_to_blob(measurement_batches(eng, 1)[0])
    held = eng.stage_blob(blob)
    th = threading.Thread(
        target=lambda: eng.submit_blob(eng.stage_blob(blob, order=1)))
    th.start()
    time.sleep(0.1)
    eng.submit_blob(held)
    th.join(timeout=10)
    assert not th.is_alive() and counter.value > before
