"""The checkpoint's per-host `host-shards` layout (a cluster host's
gang-restart checkpoint), on one process.

The world of tests/test_torch_sharded_checkpoint.py (every family
installed and caught mid-window) over a 4-shard congruent registry. A
single-controller 4-shard engine steps; its shard blocks load into engines
of the multi-process layout built without a world (a `ShardMesh` of 4
shards, 2 a process, process 0 or 1 of 2: nothing steps, so no collective
runs) through `load_local_state_shards` and the `load_local_*_blocks`
pairs:
  - host 1's engine saves (`layout: host-shards`, its shard ids, the shard
    count, its process id, its parked overflow backlog verbatim, no
    drain); a fresh host-1 engine restores it bit for bit (every group's
    blocks, the backlog, the interners); host 0's engine and a single
    engine refuse it;
  - both hosts save; `write_assembled` of the two restores onto a
    single-controller 4-shard engine and a single engine, each with the
    device state of the engine the blocks came from (as far as the
    reference's assembly carries it: see the test), and the JAX package's
    `write_assembled` of the port's host checkpoints restores onto the JAX
    4-shard engine equal to them; all three continue equal;
  - a host-shards checkpoint in the JAX package's on-disk format (its
    blocks from the JAX 4-shard engine fed the same steps) restores onto
    the port's host engine, bit-equal to the JAX blocks;
  - an instance with cluster hooks checkpoints the foreign-rows consumer
    group's offsets beside the inbound groups.
Tolerance: none.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sitewhere_tpu.persist import checkpoint as jckpt
from sitewhere_tpu.pipeline import engine as jengine
from sitewhere_tpu_torch.ops.pack import EventBatch
from sitewhere_tpu_torch.parallel import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.mesh import ShardMesh
from sitewhere_tpu_torch.persist import checkpoint as tckpt
from sitewhere_tpu_torch.pipeline import engine as tengine

from test_torch_checkpoint import (
    CUT, EPOCH, _SEQ, _setup, assert_same_engines, jax_registry, step)
from test_torch_pipeline import B, assert_bits_equal
from test_torch_sharded_checkpoint import (
    N, SHARDED_KW, continue_equal, jax_sharded, port_sharded)

GROUPS = ("rule", "model", "actuation")


def host_engine(process_index):
    """A started port engine of host `process_index`'s layout: shards
    [2p, 2p + 1] of 4, every family installed, no world joined."""
    src = port_sharded(4, 4, EPOCH)          # the same registry mirror
    eng = ShardedPipelineEngine(
        src.registry, mesh=ShardMesh(4, torch.device("cpu"), n_processes=2,
                                     process_index=process_index),
        per_shard_batch=B, name=f"host-{next(_SEQ)}", **SHARDED_KW)
    eng.packer.epoch_base_ms = EPOCH
    eng = _setup(eng, tengine, stateful=True)
    assert eng.is_multiprocess and not eng.device_routing
    return eng


def stepped_source():
    src = port_sharded(4, 4, EPOCH)
    for k in range(CUT):
        step(src, 940 + k, k)
    return src


def give_blocks(src, host):
    """`src`'s blocks of `host`'s shards, loaded into `host`; the packer's
    interners follow (the cluster's hosts intern congruently)."""
    lo, hi = host.local_shards[0], host.local_shards[-1] + 1
    _, blocks = src.local_state_shards()
    host.load_local_state_shards(host.local_shards,
                                 {k: v[lo:hi] for k, v in blocks.items()})
    for group in GROUPS:
        g = getattr(src, f"local_{group}_state_blocks")()
        getattr(host, f"load_local_{group}_state_blocks")(
            {k: v[lo:hi] for k, v in g.items()})
    for name in ("measurements", "alert_types"):
        getattr(host.packer, name).restore(
            getattr(src.packer, name).snapshot())


def blocks_of(eng):
    out = dict(eng.local_state_shards()[1])
    for group in GROUPS:
        out.update({f"{group}.{k}": v for k, v in
                    getattr(eng, f"local_{group}_state_blocks")().items()})
    return out


def backlog(eng, n=5):
    devs = [eng.packer.devices.lookup(f"dev-{i}") for i in range(2, 2 + n)]
    return EventBatch(
        device_idx=np.array(devs, np.int32),
        tenant_idx=np.zeros(n, np.int32), event_type=np.zeros(n, np.int32),
        ts=np.full(n, 1500, np.int32), mm_idx=np.full(n, 1, np.int32),
        value=np.linspace(1, 2, n).astype(np.float32),
        lat=np.zeros(n, np.float32), lon=np.zeros(n, np.float32),
        elevation=np.zeros(n, np.float32),
        alert_type_idx=np.zeros(n, np.int32),
        alert_level=np.zeros(n, np.int32), valid=np.ones(n, bool))


def test_host_shards_round_trip_on_a_2_of_4_layout(tmp_path):
    src = stepped_source()
    host = host_engine(1)
    give_blocks(src, host)
    host.set_pending_overflow_batch(backlog(host))
    path = tckpt.PipelineCheckpointer(str(tmp_path)).save(host)
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert (manifest["layout"], manifest["shard_ids"], manifest["n_shards"],
            manifest["process_id"]) == ("host-shards", [2, 3], 4, 1)
    assert host.pending_overflow == 5          # saved verbatim, not drained
    fresh = host_engine(1)
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(fresh)
    want, got = blocks_of(host), blocks_of(fresh)
    assert sorted(want) == sorted(got)
    for name in want:
        assert_bits_equal(want[name], got[name], name)
    for f in ("device_idx", "ts", "value", "valid"):
        assert_bits_equal(np.asarray(getattr(backlog(host), f)),
                          np.asarray(getattr(
                              fresh.pending_overflow_batch(), f)), f)
    assert fresh.packer.devices.snapshot() == host.packer.devices.snapshot()
    assert fresh.packer.epoch_base_ms == EPOCH
    with pytest.raises(tckpt.SiteWhereCheckpointError, match="host-shards"):
        tckpt.PipelineCheckpointer(str(tmp_path)).restore(host_engine(0))
    with pytest.raises(tckpt.SiteWhereCheckpointError, match="host-shards"):
        tckpt.PipelineCheckpointer(str(tmp_path)).restore(
            port_sharded(4, 4, EPOCH))


def test_a_host_engine_refuses_the_canonical_gathers():
    from sitewhere_tpu_torch.errors import SiteWhereError

    host = host_engine(0)
    for call in (host.canonical_state, host.canonical_rule_state,
                 host.drain_pending):
        with pytest.raises((SiteWhereError, RuntimeError)) as err:
            call()
        assert "single-controller" in str(err.value) \
            or "live cluster" in str(err.value)


def _host_checkpoints(tmp_path, src):
    paths = []
    for p in range(2):
        host = host_engine(p)
        give_blocks(src, host)
        paths.append(tckpt.PipelineCheckpointer(
            str(tmp_path / f"h{p}")).save(host))
    return paths


def test_assembled_host_checkpoints_restore_like_a_single_controller(
        tmp_path):
    """The assembled checkpoint restores onto a single-controller 4-shard
    engine and a single engine alike, with the device state of the engine
    the blocks came from. Two parts of it follow the reference's assembly,
    not the source (ROADMAP C): the unnamed measurement's column (slot 0)
    comes back empty, and the families' windows restart fresh (per-host
    slots are host-local, so their state is not merged). The JAX package's
    `write_assembled` of the same host checkpoints restores onto the JAX
    engine equal to the port's, and all three continue equal."""
    src = stepped_source()
    paths = _host_checkpoints(tmp_path, src)
    out = tckpt.write_assembled(paths, str(tmp_path / "assembled"))
    jout = jckpt.write_assembled(paths, str(tmp_path / "jax"))
    sharded = port_sharded(4, 4, EPOCH)
    single = tengine.PipelineEngine(
        sharded.registry, device="cpu", name=f"single-{next(_SEQ)}",
        **dict(SHARDED_KW, batch_size=4 * B))
    single = _setup(single, tengine, stateful=True)
    ref = jax_sharded(4, 4)
    want = {f: np.array(getattr(src.canonical_state(), f).numpy())
            for f in ("last_measurement", "last_measurement_ts")}
    assert (want["last_measurement_ts"][:, 0] > -2 ** 31).any()
    want["last_measurement"][:, 0] = 0.0
    want["last_measurement_ts"][:, 0] = -2 ** 31
    for eng in (sharded, single):
        tckpt.PipelineCheckpointer(str(tmp_path / "assembled")).restore(
            eng, out)
        got = eng.canonical_state()
        for f in dataclasses.fields(got):
            expect = want.get(f.name, getattr(src.canonical_state(),
                                              f.name).numpy())
            assert_bits_equal(expect, getattr(got, f.name).numpy(), f.name)
    jckpt.PipelineCheckpointer(str(tmp_path / "jax")).restore(ref, jout)
    assert_bits_equal(np.asarray(ref.canonical_state().last_measurement),
                      sharded.canonical_state().last_measurement, "jax")
    assert continue_equal([sharded, single, ref], 950) > 0
    assert_same_engines(ref, sharded, "jax-assembled")
    assert_same_engines(sharded, single, "assembled")


def test_a_jax_host_checkpoint_restores_onto_the_port_host(tmp_path):
    """The blocks of a JAX 4-shard engine fed the same steps, written in
    the JAX package's host-shards format (its save's manifest and arrays
    for process 1 of 2, shards [2, 3])."""
    from test_assemble_checkpoint import _write_host_ckpt

    ref = jax_sharded(4, 4)
    ref.packer.epoch_base_ms = EPOCH
    for k in range(CUT):
        step(ref, 940 + k, k)
    _, blocks = ref.local_state_shards()
    arrays = {k: np.asarray(v)[2:4] for k, v in blocks.items()}
    path = _write_host_ckpt(
        tmp_path / "ckpt-00000001", [2, 3], 4, arrays,
        {"devices": ref.packer.devices.snapshot(),
         "measurements": ref.packer.measurements.snapshot(),
         "alert_types": ref.packer.alert_types.snapshot(),
         "tenants": ref.registry.tenants.snapshot()},
        EPOCH, process_id=1,
        rules=[jengine.rule_to_dict(kind, r) for kind, rs in
               ref.list_rules().items() for r in rs])
    host = host_engine(1)
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(host, path)
    got = host.local_state_shards()[1]
    for name, want in arrays.items():
        assert_bits_equal(want, got[name], name)


def test_the_foreign_rows_cursor_rides_an_instance_checkpoint(tmp_path):
    from sitewhere_tpu_torch.parallel.cluster import (
        FOREIGN_ROWS_GROUP, foreign_rows_topic)

    from test_torch_scenarios import CPUInstance

    inst = CPUInstance(instance_id="foreign-cursor", enable_pipeline=True,
                       data_dir=str(tmp_path), max_devices=64, max_zones=4,
                       max_zone_vertices=4, batch_size=16,
                       measurement_slots=4, max_tenants=4)
    manager = inst.checkpoint_manager
    names = {(g.topic.name, g.group_id) for g in manager._inbound_groups()}
    foreign = (foreign_rows_topic(inst.naming), FOREIGN_ROWS_GROUP)
    assert foreign not in names
    inst.cluster_hooks = object()
    names = {(g.topic.name, g.group_id) for g in manager._inbound_groups()}
    assert foreign in names
    inst.bus.close()
