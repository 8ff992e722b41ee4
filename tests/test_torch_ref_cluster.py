"""The reference's tests/test_cluster.py single-process units on the port
(parallel/cluster.py): the lockstep step loop's fold tickets, alerts,
presence cadence and stop (`TestStepLoop`), the foreign-row codec
(`TestForeignCodec`) and heartbeat topology (`TestTopology`), on a 4-shard
mesh on the CPU. Then the codec against the JAX package's: the msgpack
bytes of the same rows are identical, and each package decodes the
other's payload into the same batch (a mixed-version peer reads them).
The file's two-process drills run in tests/test_torch_cluster_drills.py
(marked slow).
"""

import numpy as np
import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(
    globals(), "test_cluster",
    replacements=[("mesh=make_mesh(shards, devices=jax.devices(\"cpu\")"
                   "[:shards]),", "mesh=make_mesh(shards, device=\"cpu\"),")],
    only=("TestStepLoop", "TestForeignCodec", "TestTopology"))


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_unit_runs():
    assert REFERENCE_TESTS == [
        "TestForeignCodec.test_roundtrip_by_token",
        "TestForeignCodec.test_unknown_token_folds_unregistered",
        "TestStepLoop.test_fold_ticket_and_alerts",
        "TestStepLoop.test_presence_cadence",
        "TestStepLoop.test_stop_unblocks_pending_tickets",
        "TestTopology.test_heartbeat_aggregation_and_staleness"]


def _engines():
    """The same 4-shard world in both packages, one epoch base."""
    import sitewhere_tpu.parallel as jparallel
    import sitewhere_tpu.registry as jregistry
    import sitewhere_tpu.model as jmodel
    import sitewhere_tpu_torch.model as tmodel
    import sitewhere_tpu_torch.parallel as tparallel
    import sitewhere_tpu_torch.registry as tregistry
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    out = []
    for model, registry, parallel, mesh in (
            (jmodel, jregistry, jparallel, jparallel.make_mesh(4)),
            (tmodel, tregistry, tparallel, make_mesh(4, device="cpu"))):
        dm = registry.DeviceManagement()
        dt = dm.create_device_type(model.DeviceType(token="t"))
        rt = registry.RegistryTensors(64, 4, 4, shard_classes=4)
        for i in range(16):
            d = dm.create_device(model.Device(token=f"d{i}",
                                              device_type_id=dt.id))
            dm.create_device_assignment(model.DeviceAssignment(
                token=f"a{i}", device_id=d.id))
        rt.attach(dm, "tenant")
        engine = parallel.ShardedPipelineEngine(rt, mesh=mesh,
                                                per_shard_batch=8)
        engine.packer.epoch_base_ms = 1_700_000_000_000
        engine.start()
        out.append((model, engine))
    return out


def _batch(model, engine, rng):
    from sitewhere_tpu.model.event import AlertLevel

    events, tokens = [], []
    for i in range(20):
        date = 1_700_000_000_000 + int(rng.integers(-5000, 5000))
        kind = i % 3
        if kind == 0:
            events.append(model.DeviceMeasurement(
                name=f"m{i % 4}", value=float(rng.standard_normal() * 1e3),
                event_date=date))
        elif kind == 1:
            events.append(model.DeviceLocation(
                latitude=float(rng.uniform(-90, 90)),
                longitude=float(rng.uniform(-180, 180)),
                elevation=float(rng.uniform(0, 500)), event_date=date))
        else:
            events.append(model.DeviceAlert(
                type=f"al{i % 2}", level=int(AlertLevel.WARNING),
                event_date=date))
        tokens.append(f"d{int(rng.integers(0, 16))}" if i != 7
                      else "never-registered")
    return engine.packer.pack_events(events, tokens)[0]


def test_codec_bytes_equal_the_jax_packages():
    import sitewhere_tpu.parallel.cluster as jcluster
    import sitewhere_tpu_torch.parallel.cluster as tcluster

    (jmodel, jeng), (tmodel, teng) = _engines()
    jb = _batch(jmodel, jeng, np.random.default_rng(5))
    tb = _batch(tmodel, teng, np.random.default_rng(5))
    for name in ("device_idx", "event_type", "ts", "value", "lat", "lon",
                 "valid"):
        assert np.array_equal(np.asarray(getattr(jb, name)),
                              np.asarray(getattr(tb, name))), name
    sel = np.nonzero(np.asarray(tb.valid))[0]
    assert jcluster.encode_rows(jeng, jb, sel) == \
        tcluster.encode_rows(teng, tb, sel)
    jgroups = jcluster.encode_foreign_rows(jeng, jb)
    tgroups = tcluster.encode_foreign_rows(teng, tb)
    assert jgroups == tgroups and set(tgroups) == {0}
    payload, n = tgroups[0]
    assert n == int(np.asarray(tb.valid).sum())
    # each package reads the other's payload into the same batch
    for (dec_cluster, engine), (_, other_engine) in (
            ((tcluster, teng), (jcluster, jeng)),
            ((jcluster, jeng), (tcluster, teng))):
        (mine,) = dec_cluster.decode_foreign_rows(engine, payload)
        other_cluster = jcluster if dec_cluster is tcluster else tcluster
        (theirs,) = other_cluster.decode_foreign_rows(other_engine, payload)
        for name in ("device_idx", "event_type", "ts", "mm_idx", "value",
                     "lat", "lon", "elevation", "alert_type_idx",
                     "alert_level", "valid"):
            a = np.asarray(getattr(mine, name))
            b = np.asarray(getattr(theirs, name))
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


def test_vote_on_one_controller_counts_every_shard():
    from sitewhere_tpu_torch.parallel.cluster import ClusterControl
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    control = ClusterControl(make_mesh(4, device="cpu"))
    assert control.vote(False) == 0
    assert control.vote(True) == 4 == control.n_shards


def test_the_loop_counts_its_ticks_and_processed_rows():
    """The step loop's own counters (what chip_smoke reads a tick's wall
    and `processed` from): one history record a tick, the fed rows on the
    tick that stepped them, and a `processed` total equal to the JAX
    engine's over the same batch and its overflow drain."""
    from sitewhere_tpu.ops.pack import empty_batch as jempty
    from sitewhere_tpu_torch.parallel.cluster import ClusterStepLoop

    (jmodel, jeng), (tmodel, teng) = _engines()
    jb = _batch(jmodel, jeng, np.random.default_rng(9))
    tb = _batch(tmodel, teng, np.random.default_rng(9))
    _, jout = jeng.submit(jb)
    want = int(jout.processed)
    while jeng.pending_overflow:
        _, jout = jeng.submit(jempty(1))
        want += int(jout.processed)
    loop = ClusterStepLoop(teng, idle_interval_s=0.001)
    loop.start()
    try:
        assert loop.feed(tb).wait(30)
    finally:
        loop.stop()
    assert loop.fatal is None
    assert loop.processed == want > 0
    assert len(loop.history) == loop.tick_count >= 1
    assert sum(t.processed for t in loop.history) == loop.processed
    (fed,) = [t for t in loop.history if t.batches]
    assert fed.batches == 1 and fed.rows == int(np.asarray(tb.valid).sum())
    assert all(t.wall_s >= 0 for t in loop.history)
    # one controller votes without a collective
    assert loop.control.votes == 0 and teng.sum_reduces == 0
