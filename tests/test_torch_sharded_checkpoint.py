"""Checkpoints of the sharded engine across packages and topologies.

The world of tests/test_torch_checkpoint.py over shard-congruent registries
(a device's index `crc32(token) % S` mod S), every family installed and
caught mid-window; the traffic names devices by token, so engines whose
interners lay tokens out differently get the same events:
  - JAX S=8 saves; the port restores into S=4 (a layout congruent with 8,
    restored verbatim) and into a single engine (its sequential interner
    takes the snapshot, its registry mirror re-mirrors every row); all
    three continue equal;
  - the port S=8 saves; a JAX engine over the same layout (S=4 shards)
    restores; both continue equal;
  - the port S=4 saves; the port S=8 restores: the snapshot is not
    congruent with 8, so every token re-interns and every group's
    device-major rows follow the permutation (the elastic restore), and
    the two continue equal device by device;
  - a parked overflow backlog drains into state before a save.
Alerts compare as sorted keys, fires by (device, policy), state groups bit
for bit (f32 as bit patterns), by index where the layouts agree and by
token where they do not. Tolerance: none.
"""

import dataclasses

import numpy as np

from sitewhere_tpu.persist import checkpoint as jckpt
from sitewhere_tpu.pipeline import engine as jengine
from sitewhere_tpu_torch.parallel import ShardedPipelineEngine, make_mesh
from sitewhere_tpu_torch.persist import checkpoint as tckpt
from sitewhere_tpu_torch.pipeline import engine as tengine

from test_torch_checkpoint import (
    AFTER, CUT, KWARGS, _SEQ, _setup, assert_same_engines, jax_registry,
    port_engine, step)
from test_torch_pipeline import B, assert_bits_equal

N = 120                      # devices of the world (8 classes hold them)
LANES = dict(alert_lane_capacity=8 * B, command_lane_capacity=8 * B)
SHARDED_KW = {k: v for k, v in dict(KWARGS, **LANES).items()
              if k != "batch_size"}


def jax_sharded(S, classes):
    from sitewhere_tpu.parallel import ShardedPipelineEngine as JSharded
    from sitewhere_tpu.parallel import make_mesh as j_make_mesh

    eng = JSharded(jax_registry(N, shard_classes=classes),
                   mesh=j_make_mesh(S), per_shard_batch=B,
                   name=f"ckpt-jsharded-{next(_SEQ)}", **SHARDED_KW)
    return _setup(eng, jengine, stateful=True)


def port_sharded(S, classes, epoch_base_ms):
    from sitewhere_tpu_torch import convert

    jreg = jax_registry(N, shard_classes=classes)
    reg = convert.registry_from_snapshot(
        dataclasses.asdict(jreg.snapshot()), jreg.devices.snapshot(),
        jreg.tenants.snapshot(),
        device_type_tokens=jreg.device_types.snapshot(),
        zone_tokens=jreg.zones_interner.snapshot(),
        area_tokens=jreg.areas.snapshot(),
        assignment_tokens=jreg.assignments.snapshot(),
        shard_classes=classes)
    eng = ShardedPipelineEngine(reg, mesh=make_mesh(S, device="cpu"),
                                per_shard_batch=B,
                                name=f"ckpt-tsharded-{next(_SEQ)}",
                                **SHARDED_KW)
    eng.packer.epoch_base_ms = epoch_base_ms
    return _setup(eng, tengine, stateful=True)


def continue_equal(engines, seed, start=CUT):
    """Every engine takes the same AFTER steps: sorted alerts and fires
    (by device and policy) equal to the first engine's, step by step."""
    key = lambda f: (f["device"], f["policy"])  # noqa: E731
    fired = 0
    for k in range(start, start + AFTER):
        results = [step(eng, seed + k, k) for eng in engines]
        want_alerts, want_fires = results[0]
        fired += len(want_alerts) + len(want_fires)
        for alerts, fires in results[1:]:
            assert sorted(alerts) == sorted(want_alerts), f"step {k}"
            assert sorted(fires, key=key) == sorted(want_fires, key=key)
    return fired


def rows_by_token(eng):
    """{token: (every device-major field's row, as bytes)} of the
    canonical state and each group's slab."""
    groups = [eng.canonical_state()] + [
        getattr(eng, f"canonical_{g}_state")()
        for g in ("rule", "model", "actuation")]
    tokens = eng.registry.devices.snapshot()
    out = {}
    for idx, token in enumerate(tokens):
        if not idx or token is None:
            continue
        out[token] = tuple(
            np.asarray(getattr(g, f.name))[idx].tobytes()
            for g in groups for f in dataclasses.fields(g)
            if f.name not in ("tenant_event_count", "tenant_alert_count",
                              "gen", "fire_count", "suppress_count",
                              "eval_count", "debounce_count"))
    return out


def test_jax_8_shards_restore_into_port_4_shards_and_single(tmp_path):
    src = jax_sharded(8, classes=8)
    for k in range(CUT):
        step(src, 800 + k, k)
    path = jckpt.PipelineCheckpointer(str(tmp_path)).save(src)
    epoch = src.packer.epoch_base_ms
    four = port_sharded(4, classes=4, epoch_base_ms=epoch + 777)
    single = port_engine(jax_registry(N), epoch, **LANES)
    for eng in (four, single):
        tckpt.PipelineCheckpointer(str(tmp_path)).restore(eng, path)
        assert eng.packer.epoch_base_ms == epoch
        assert eng.registry.devices.snapshot() == \
            src.registry.devices.snapshot()
        assert_same_engines(src, eng, "restored")
    assert continue_equal([src, four, single], 800) > 0
    assert_same_engines(src, four, "continued")
    assert_same_engines(src, single, "continued")


def test_port_8_shards_restore_into_jax(tmp_path):
    src = port_sharded(8, classes=8, epoch_base_ms=1_700_000_000_000)
    for k in range(CUT):
        step(src, 820 + k, k)
    path = tckpt.PipelineCheckpointer(str(tmp_path)).save(src)
    dst = jax_sharded(4, classes=8)
    jckpt.PipelineCheckpointer(str(tmp_path)).restore(dst, path)
    assert dst.packer.epoch_base_ms == src.packer.epoch_base_ms
    assert_same_engines(dst, src, "restored")
    assert continue_equal([dst, src], 820) > 0
    assert_same_engines(dst, src, "continued")


def test_elastic_restore_permutes_every_group(tmp_path):
    src = port_sharded(4, classes=4, epoch_base_ms=1_700_000_000_000)
    for k in range(CUT):
        step(src, 840 + k, k)
    path = tckpt.PipelineCheckpointer(str(tmp_path)).save(src)
    dst = port_sharded(8, classes=8, epoch_base_ms=0)
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(dst, path)
    moved = sum(src.registry.devices.lookup(t) != dst.registry.devices
                .lookup(t) for t in src.registry.devices.snapshot()[1:]
                if t is not None)
    assert moved > 0                       # the layouts differ
    assert rows_by_token(dst) == rows_by_token(src)
    assert continue_equal([src, dst], 840) > 0
    assert rows_by_token(dst) == rows_by_token(src)
    for name in ("rule_program_counters", "anomaly_model_counters",
                 "actuation_policy_counters"):
        assert getattr(dst, name)() == getattr(src, name)()
    assert_bits_equal(src.canonical_state().tenant_event_count,
                      dst.canonical_state().tenant_event_count)


def test_overflow_backlog_drains_before_the_save(tmp_path):
    """A skewed step leaves a backlog; the port's save folds it into state
    first, as the reference's does, and the JAX engine restores the
    result."""
    src = port_sharded(8, classes=8, epoch_base_ms=1_700_000_000_000)
    ref = jax_sharded(8, classes=8)
    ref.packer.epoch_base_ms = src.packer.epoch_base_ms
    for eng in (src, ref):
        token = "dev-17"
        idx = eng.packer.devices.lookup(token)
        n = 3 * B // 2
        batch = eng.packer.pack_columns(
            np.full(n, idx, np.int32), np.zeros(n, np.int32),
            eng.packer.epoch_base_ms + np.arange(n, dtype=np.int64),
            mm_idx=np.full(n, 1, np.int32),
            value=np.arange(n, dtype=np.float32))
        eng.materialize_alerts(*eng.submit(batch))
        assert eng.pending_overflow == n - B
    path = tckpt.PipelineCheckpointer(str(tmp_path)).save(src)
    assert src.pending_overflow == 0
    ref.drain_pending()
    assert_same_engines(ref, src, "drained")
    dst = jax_sharded(8, classes=8)
    jckpt.PipelineCheckpointer(str(tmp_path)).restore(dst, path)
    assert_same_engines(ref, dst, "restored")
    assert len(src._pending_alerts) == len(ref._pending_alerts)
