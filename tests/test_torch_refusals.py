"""What the port once refused, answered now, each held to the reference.

The whole sharded path is ported. The tests here replaced the refusals of
the slices that lifted them, with the count kept:
  - a mesh handed to the windowed-analytics engine is answered
    (`test_a_mesh_query_names_sharded_analytics`, which kept the name of
    the refusal it replaced);
  - the multi-host data plane: `initialize` joins a configured world over
    gloo and reads the reference's settings; the instance takes a
    multi-process mesh and builds its host's block of the sharded engine;
    a data-plane cluster's hooks reach the inbound service, which routes a
    record by its device's owner as the JAX package's does (the
    two-process drills are tests/test_torch_multiprocess_*.py and
    tests/test_torch_cluster_cli.py).
"""

import msgpack
import pytest
import torch

from sitewhere_tpu_torch.analytics.engine import WindowedAnalyticsEngine
from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog

from test_torch_scenarios import CPUInstance


def test_a_mesh_query_names_sharded_analytics():
    """A mesh query takes sharded analytics: its report equals the JAX
    engine's over a JAX mesh of as many shards, bit for bit (the name is
    the refusal's this test replaced)."""
    import sitewhere_tpu.analytics.engine as jengine
    import sitewhere_tpu.model.event as jevent
    import sitewhere_tpu.persist.eventlog as jeventlog
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
    from sitewhere_tpu_torch.model import event as tevent
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from test_torch_analytics import assert_reports_equal

    def log_of(ev, log):
        log.append_events("t", [ev.DeviceMeasurement(
            name="m", value=0.1 * i - 3.3,
            event_date=1_700_000_000_000 + 37_000 * i) for i in range(201)],
            [f"d{i % 7}" for i in range(201)])
        return log

    want = jengine.WindowedAnalyticsEngine(
        log_of(jevent, jeventlog.ColumnarEventLog())).measurement_windows(
        "t", mesh=jax_mesh(4))
    got = WindowedAnalyticsEngine(
        log_of(tevent, ColumnarEventLog()), device="cpu").measurement_windows(
        "t", mesh=make_mesh(4, device="cpu"))
    assert_reports_equal(got, want)
    assert int(got.stats.count.sum()) == 201


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_reads_the_reference_settings_and_joins_over_gloo(
        monkeypatch):
    """As the JAX package's `initialize`: False without a coordinator in
    the arguments or SWTPU_COORDINATOR / SWTPU_NUM_PROCESSES /
    SWTPU_PROCESS_ID; with one, True once the world is joined (here a
    world of one process over gloo, with its two groups); an incomplete
    setting raises."""
    import torch.distributed as dist

    import sitewhere_tpu.parallel.distributed as jdist
    from sitewhere_tpu_torch.parallel import distributed as tdist

    for var in ("SWTPU_COORDINATOR", "SWTPU_NUM_PROCESSES",
                "SWTPU_PROCESS_ID", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize() is False is jdist.initialize()
    with pytest.raises(ValueError, match="process"):
        tdist.initialize("127.0.0.1:1234", num_processes=2)
    monkeypatch.setenv("SWTPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("SWTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("SWTPU_PROCESS_ID", "0")
    try:
        assert tdist.initialize() is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert tdist._WORLD["step_group"] is not None
        assert tdist._WORLD["query_group"] is not None
        with pytest.raises(RuntimeError, match="already joined"):
            tdist.initialize()
        # one process is no cluster: the single-controller answers
        assert tdist.live_mesh() is None
        mesh = tdist.make_global_mesh([torch.device("cpu")] * 2)
        assert not mesh.is_multiprocess and mesh.local_shards == [0, 1]
    finally:
        tdist.shutdown()
    assert not dist.is_initialized()


def test_an_instance_takes_a_multi_process_mesh():
    """A mesh of 4 shards, process 1 of 2, builds this host's block of the
    sharded engine (shards 2 and 3, the host route, the full wire layout);
    the planner gets no mesh (a query would enter the collective alone);
    anything that is not a ShardMesh is refused."""
    from sitewhere_tpu_torch.ops.pack import WIRE_ROWS
    from sitewhere_tpu_torch.parallel.mesh import ShardMesh

    mesh = ShardMesh(4, torch.device("cpu"), n_processes=2, process_index=1)
    assert list(mesh.process_of_shard) == [0, 0, 1, 1]
    inst = CPUInstance(instance_id="host-1-of-2", enable_pipeline=True,
                       mesh=mesh, max_devices=64, max_zones=4,
                       max_zone_vertices=4, batch_size=16,
                       measurement_slots=4, max_tenants=4)
    engine = inst.pipeline_engine
    assert engine.is_multiprocess and engine.local_shards == [2, 3]
    assert engine.n_shards == 4 and not engine.device_routing
    assert engine.router.fixed_wire_rows == WIRE_ROWS
    assert inst.registry_tensors.devices.shard_classes == 4
    assert inst._serving_mesh() is None
    with pytest.raises(TypeError, match="ShardMesh"):
        CPUInstance(instance_id="not-a-mesh", enable_pipeline=True,
                    mesh=object())


class _Hooks:
    """A data-plane cluster host's hooks, recording their calls: host 0
    of 2, owning the devices whose token ends in an even digit."""

    data_plane = True
    process_id = 0

    def __init__(self):
        self.forwarded, self.fed = [], []

    def owner_process(self, token):
        return int(token[-1]) % 2

    def forward_decoded(self, groups, tenant):
        self.forwarded.append({pid: [r.key for r in records]
                               for pid, records in groups.items()})

    def feed_hot(self, events, tokens):
        self.fed.append(list(tokens))
        return []


def _drive(model, tenant_engine_cls, bus_mod, log):
    hooks = _Hooks()
    bus = bus_mod.EventBus(partitions=1)
    te = tenant_engine_cls(model.Tenant(token="t"), bus, log, cluster=hooks)
    dt = te.registry.create_device_type(model.DeviceType(token="dt"))
    for i in range(4):
        d = te.registry.create_device(model.Device(token=f"dev{i}",
                                                   device_type_id=dt.id))
        te.registry.create_device_assignment(model.DeviceAssignment(
            token=f"as{i}", device_id=d.id))

    def record(offset, token, forwarded=False):
        batch = model.DeviceEventBatch(device_token=token, measurements=[
            model.DeviceMeasurement(name="m", value=1.5 + offset,
                                    event_date=1_700_000_000_000 + offset)])
        data = {"sourceId": "s", "deviceToken": token,
                "kind": "DeviceEventBatch", "metadata": {},
                "request": model.common._asdict(batch)}
        if forwarded:
            data["fwdFrom"] = 1
        return bus_mod.Record("decoded", 0, offset, token.encode(),
                              msgpack.packb(data, use_bin_type=True), 0)

    te.inbound.process([record(0, "dev0"), record(1, "dev1"),
                        record(2, "dev2"), record(3, "dev3", forwarded=True)])
    parked = bus.consumer(
        te.naming.event_source_decoded_events("t") + ".misrouted",
        "probe").poll(max_records=10)
    out = (hooks.forwarded, hooks.fed, [r.key for r in parked],
           te.inbound.failed_counter.value)
    bus.close()
    return out


def test_data_plane_hooks_route_inbound_records_to_their_owner():
    """A data-plane cluster's hooks reach the tenant's inbound service: a
    record of another host's device forwards before persist, this host's
    devices feed the step loop, and a record already forwarded once that
    this host still does not own parks on the misroute topic — the calls
    the JAX package's inbound makes on the same records."""
    import sitewhere_tpu.model as jmodel
    import sitewhere_tpu.multitenant.engine as jtenant
    import sitewhere_tpu.persist.eventlog as jeventlog
    import sitewhere_tpu.runtime.bus as jbus
    import sitewhere_tpu_torch.model as tmodel
    import sitewhere_tpu_torch.multitenant.engine as ttenant
    import sitewhere_tpu_torch.runtime.bus as tbus

    want = _drive(jmodel, jtenant.TenantEngine, jbus,
                  jeventlog.ColumnarEventLog())
    got = _drive(tmodel, ttenant.TenantEngine, tbus, ColumnarEventLog())
    assert got == want
    forwarded, fed, parked, failed = got
    assert forwarded == [{1: [b"dev1"]}]
    assert fed == [["dev0", "dev2"]]
    assert parked == [b"dev3"] and failed == 1
