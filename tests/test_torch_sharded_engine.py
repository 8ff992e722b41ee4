"""The port's ShardedPipelineEngine held against the JAX package's on the CPU.

The JAX engine runs on `make_mesh(S)` of the virtual CPU devices
(tests/conftest.py); the port's on `make_mesh(S, device="cpu")`, every
shard on the one torch device. Both get the world of
tests/test_torch_pipeline.py (two tenants, registered and unassigned
devices, zones, threshold and geofence rules), the same epoch base and the
same seeded traffic, at S in {2, 8} with host and with device routing, on
all three wire layouts. Per step they must agree on: alerts (order
included), the alert and command lanes, the route counters
(device-routed steps, host fallbacks, route drops), the overflow backlog,
and every canonical state group (f32 compared as bit patterns). Two runs
(2 shards host-routed, 8 device-routed) have rule programs, anomaly
models and actuation policies installed (the anomaly score channel
carries the reference's tolerance, rtol=1e-4, atol=1e-5); one feeds a
skewed batch that spills to the host route and requeues. The port's sharded engine also equals the port's single engine in
state and sorted alerts (the contract of tests/test_parallel.py:221).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.parallel import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from sitewhere_tpu_torch.pipeline import engine as tengine

from test_torch_pipeline import (
    B, D, K, M, RULES, T, _alert_key, assert_bits_equal,
    assert_dataclass_bits_equal, make_cols, world)  # noqa: F401 (fixture)
from test_torch_pipeline_stateful import (
    BUCKETS, MODELS, POLICIES, PROGRAMS, install)

VARIANTS = ("full", "compact", "packed")
ROUTE_COUNTERS = ("device_route_steps", "device_route_fallbacks",
                  "device_route_dropped", "drain_steps", "alerts_dropped")


def _kwargs(**extra):
    return {**dict(measurement_slots=M, max_tenants=T,
                   max_threshold_rules=16, max_geofence_rules=8,
                   alert_lane_capacity=K), **extra}


def sharded_pair(world, S, device_routing, name, **extra):
    """A JAX and a port sharded engine over the world's registry (the port
    on its CPU copy), per-shard batch B / S, same rules and epoch base."""
    from sitewhere_tpu.parallel import ShardedPipelineEngine as JSharded
    from sitewhere_tpu.parallel import make_mesh as j_make_mesh
    from sitewhere_tpu.pipeline import engine as jengine

    jeng = JSharded(world["jreg"], mesh=j_make_mesh(S), per_shard_batch=B // S,
                    device_routing=device_routing, name=f"{name}-ref",
                    **_kwargs(**extra))
    teng = ShardedPipelineEngine(
        world["treg"], mesh=t_make_mesh(S, device="cpu"),
        per_shard_batch=B // S, device_routing=device_routing, name=name,
        **_kwargs(**extra))
    teng.packer.epoch_base_ms = jeng.packer.epoch_base_ms
    for eng, mod in ((jeng, jengine), (teng, tengine)):
        for mm in ("m1", "m2", "m3"):
            eng.packer.measurements.intern(mm)
        for spec in RULES:
            eng.upsert_rule(*mod.rule_from_dict(dict(spec)))
        eng.start()
    return jeng, teng


def spread_cols(seed, variant, S, n=B - 5, oob=False):
    """make_cols traffic whose devices are dealt round robin over the
    shards (each chunk of B / S rows holds about B / S^2 rows a shard), so
    the device route's lanes take it; `oob` adds rows past the device
    capacity (inside the wire field)."""
    cols = make_cols(seed, variant, n=n)
    rng = np.random.default_rng(seed + 1000)
    lane = np.arange(n) % S
    dev = (lane + S * rng.integers(0, D // S, n)).astype(np.int32)
    dev[(rng.random(n) < 0.3) & (lane == 0)] = 0
    if oob:
        # past the capacity, each on its row's shard
        far = np.array([D, 4000, 2 ** 22 - S, D + S])
        dev[:4] = far - far % S + lane[:4]
    cols["device_idx"] = dev
    return cols


def pack(eng, cols, shift_ms=0):
    base = eng.packer.epoch_base_ms
    kw = {k: cols[k] for k in ("mm_idx", "value", "lat", "lon", "elevation",
                               "alert_type_idx", "alert_level")}
    return eng.packer.pack_columns(
        cols["device_idx"], cols["event_type"],
        base + cols["ts"].astype(np.int64) + shift_ms, **kw)


def overflow_cols(eng):
    batch = eng.pending_overflow_batch()
    if batch is None:
        return None
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch) if f.name != "tenant_idx"}


def assert_outputs_equal(jout, tout, what):
    for name in ("alert_lanes", "command_lanes", "processed", "alerts",
                 "tenant_counts", "valid", "unregistered",
                 "threshold_fired", "geofence_fired", "program_fired",
                 "model_fired"):
        assert_bits_equal(np.asarray(getattr(jout, name)),
                          getattr(tout, name), f"{what}.{name}")
    np.testing.assert_allclose(tout.model_score.numpy(),
                               np.asarray(jout.model_score), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}.model_score")


def assert_engines_equal(jeng, teng, what=""):
    assert_dataclass_bits_equal(jeng.canonical_state(),
                                teng.canonical_state(), f"{what} state")
    for group in ("rule", "model", "actuation"):
        assert_dataclass_bits_equal(
            getattr(jeng, f"canonical_{group}_state")(),
            getattr(teng, f"canonical_{group}_state")(), f"{what} {group}")
    for name in ROUTE_COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), f"{what} {name}"
    jo, to = overflow_cols(jeng), overflow_cols(teng)
    assert (jo is None) == (to is None), f"{what} overflow backlog"
    if jo is not None:
        for name in jo:
            assert_bits_equal(jo[name], to[name], f"{what} overflow.{name}")
    for counters in ("rule_program_counters", "anomaly_model_counters",
                     "actuation_policy_counters"):
        assert getattr(teng, counters)() == getattr(jeng, counters)()
    assert teng.stats()["tenant_event_count"] == \
        jeng.stats()["tenant_event_count"]


def step_both(jeng, teng, cols, what, shift_ms=0):
    jv, jout = jeng.submit(pack(jeng, cols, shift_ms))
    tv, tout = teng.submit(pack(teng, cols, shift_ms))
    assert_outputs_equal(jout, tout, what)
    try:
        ja = jeng.materialize_alerts(jv, jout)
    except IndexError:
        # a row past the device capacity fired under the clamped row's
        # tenant and its alert names no token: the reference raises
        # (ROADMAP queue C), and so must the port
        with pytest.raises(IndexError):
            teng.materialize_alerts(tv, tout)
        assert_engines_equal(jeng, teng, what)
        return []
    ta = teng.materialize_alerts(tv, tout)
    assert [_alert_key(a) for a in ta] == [_alert_key(a) for a in ja], what
    assert teng.take_command_fires() == jeng.take_command_fires(), what
    assert_engines_equal(jeng, teng, what)
    return ta


@pytest.mark.parametrize("S,device_routing", [
    (2, False), (2, True), (8, False), (8, True)])
def test_sharded_engine_bit_equal_to_jax(world, S, device_routing):
    """Every wire layout, with rows past the device capacity, unknown
    devices and presence: the two packages agree step by step."""
    jeng, teng = sharded_pair(world, S, device_routing,
                              f"torch-sharded-{S}-{int(device_routing)}")
    assert teng.device_routing == jeng.device_routing == device_routing
    n_alerts = 0
    for i, variant in enumerate(VARIANTS * 2):
        cols = spread_cols(10 * S + i, variant, S, oob=(i == 4))
        alerts = step_both(jeng, teng, cols, f"S={S} step {i}",
                           shift_ms=100 * i)
        assert alerts or i == 4
        n_alerts += len(alerts)
    if device_routing:
        assert teng.device_route_steps > 0
    # the sweep reports the same devices in the same (shard-major) order
    assert teng.presence_sweep() == jeng.presence_sweep()
    assert_engines_equal(jeng, teng, "after the sweep")


def test_skewed_batch_spills_to_the_host_route(world):
    """A batch whose rows all own one shard overflows the lanes: both
    engines count a host fallback, route the same rows, requeue the same
    overflow and fold it on the next submit."""
    S = 4
    jeng, teng = sharded_pair(world, S, True, "torch-sharded-skew")
    skew = make_cols(71, "compact", n=B)
    skew["device_idx"] = np.full(B, 8 + S * 3, np.int32)
    skew["device_idx"][::7] = 5 * S + 1
    step_both(jeng, teng, skew, "skew")
    assert teng.device_route_fallbacks == 1
    assert teng.pending_overflow > 0
    step_both(jeng, teng, spread_cols(72, "packed", S), "after skew",
              shift_ms=500)
    teng.drain_pending()
    jeng.drain_pending()
    assert_engines_equal(jeng, teng, "drained")
    assert [_alert_key(a) for a in teng._pending_alerts] == \
        [_alert_key(a) for a in jeng._pending_alerts]


@pytest.mark.parametrize("S,device_routing", [(2, False), (8, True)])
def test_stateful_sharded_engine_bit_equal_to_jax(world, S, device_routing):
    """Rule programs, anomaly models and actuation policies installed, on
    every wire layout: alerts, command fires, every state group and
    counter (the anomaly score within the reference's tolerance)."""
    jeng, teng = sharded_pair(world, S, device_routing,
                              f"torch-sharded-stateful-{S}", **BUCKETS)
    install((jeng, teng), PROGRAMS, MODELS, POLICIES)
    for i, variant in enumerate(("compact", "packed", "full", "compact")):
        step_both(jeng, teng, spread_cols(300 + i, variant, S),
                  f"stateful step {i}", shift_ms=1000 * i)
    assert sum(c["fires"] for c in teng.rule_program_counters().values())


def test_sharded_equals_the_single_engine(world):
    """The port's sharded engine and its single engine over the same
    traffic: the same canonical state and the same alerts, sorted."""
    S = 8
    teng = ShardedPipelineEngine(
        world["treg"], mesh=t_make_mesh(S, device="cpu"),
        per_shard_batch=B // S, name="torch-sharded-vs-single",
        **_kwargs(alert_lane_capacity=B))
    # lanes as wide as the batch: neither engine drops an alert
    single = tengine.PipelineEngine(world["treg"], batch_size=B,
                                    device="cpu", name="torch-single-ref",
                                    **_kwargs(alert_lane_capacity=B))
    for eng in (teng, single):
        eng.packer.epoch_base_ms = world["jeng"].packer.epoch_base_ms
        for mm in ("m1", "m2", "m3"):
            eng.packer.measurements.intern(mm)
        for spec in RULES:
            eng.upsert_rule(*tengine.rule_from_dict(dict(spec)))
        eng.start()
    got, want = [], []
    for i, variant in enumerate(VARIANTS):
        cols = spread_cols(500 + i, variant, S)
        v, out = teng.submit(pack(teng, cols, 100 * i))
        got += teng.materialize_alerts(v, out)
        b, sout = single.submit_routed(pack(single, cols, 100 * i))
        want += single.materialize_alerts(b, sout)
    assert teng.pending_overflow == 0
    assert sorted(map(_alert_key, got)) == sorted(map(_alert_key, want))
    assert_dataclass_bits_equal(single.canonical_state(),
                                teng.canonical_state(), "state")
    assert sorted(teng.presence_sweep()) == sorted(single.presence_sweep())
    # a device's state reads back through its (d % S, d // S) row
    token = world["treg"].devices.token_of(17)
    assert teng.get_device_state(token) == single.get_device_state(token)


def test_cuda_default_and_no_cpu_fallback():
    """The mesh defaults to the card and raises without it; a device that
    is not the mesh's is refused."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_make_mesh(2)
    from sitewhere_tpu_torch.registry.tensors import RegistryTensors

    reg = RegistryTensors(max_devices=64, max_zones=4, max_zone_vertices=4)
    with pytest.raises(ValueError, match="not the mesh"):
        ShardedPipelineEngine(reg, mesh=t_make_mesh(2, device="cpu"),
                              device="meta")
    with pytest.raises(ValueError, match="divisible"):
        ShardedPipelineEngine(
            RegistryTensors(max_devices=66, max_zones=4,
                            max_zone_vertices=4),
            mesh=t_make_mesh(4, device="cpu"))
