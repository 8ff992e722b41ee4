"""What the port still refuses, each refusal naming the slice that lifts it.

The single-controller sharded path is ported, its analytics and the
feeders' sharded landing included; what is left of the reference's
sharded path raises and names its ROADMAP item:
  - A6d, the multi-host data plane: a mesh that is not a single-controller
    ShardMesh handed to the instance, data-plane cluster hooks on a tenant
    engine or on the inbound service, `initialize` asked to join a cluster
    (the CLI's `--cluster-coordinator` is tests/test_torch_cli.py's).
A mesh handed to the windowed-analytics engine is answered now
(`test_a_mesh_query_names_sharded_analytics`, which kept the name of the
refusal it replaced).
"""

import pytest

from sitewhere_tpu_torch.analytics.engine import WindowedAnalyticsEngine
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.multitenant.engine import TenantEngine
from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
from sitewhere_tpu_torch.pipeline.inbound import InboundProcessingService
from sitewhere_tpu_torch.runtime.bus import EventBus

from test_torch_scenarios import CPUInstance


class _DataPlaneCluster:
    """What a multi-host data-plane cluster hands a tenant engine."""

    data_plane = True


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


def test_joining_a_cluster_names_the_data_plane(monkeypatch):
    from sitewhere_tpu_torch.parallel.distributed import initialize

    for var in ("SWTPU_COORDINATOR", "SWTPU_NUM_PROCESSES",
                "SWTPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    with pytest.raises(NotImplementedError, match="ROADMAP A6d"):
        initialize("127.0.0.1:1234", num_processes=2, process_id=0)
    monkeypatch.setenv("SWTPU_COORDINATOR", "127.0.0.1:1234")
    with pytest.raises(NotImplementedError, match="ROADMAP A6d"):
        initialize()


def test_a_multi_host_mesh_names_the_data_plane():
    with pytest.raises(NotImplementedError, match="ROADMAP A6d"):
        CPUInstance(instance_id="refuse-global-mesh", mesh=object())


def test_data_plane_hooks_name_the_data_plane():
    bus = EventBus(partitions=1)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A6d"):
            TenantEngine(Tenant(token="t"), bus, ColumnarEventLog(),
                         cluster=_DataPlaneCluster())
        with pytest.raises(NotImplementedError, match="ROADMAP A6d"):
            InboundProcessingService(bus, registry=None,
                                     cluster=_DataPlaneCluster())
    finally:
        bus.close()
