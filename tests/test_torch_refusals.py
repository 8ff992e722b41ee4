"""What the port still refuses, each refusal naming the slice that lifts it.

The single-controller sharded path is ported; what is left of the
reference's sharded path raises and names its ROADMAP item:
  - A6c, sharded analytics: a mesh handed to the windowed-analytics engine;
  - A6d, the multi-host data plane: a mesh that is not a single-controller
    ShardMesh handed to the instance, data-plane cluster hooks on a tenant
    engine or on the inbound service (the CLI's `--cluster-coordinator` is
    tests/test_torch_cli.py's);
  - A6e, the feeders' sharded landing: tests/test_torch_feeders.py (the
    service and the worker) and tests/test_torch_cli.py (`--feeders` with
    `--shards`).
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
    engine = WindowedAnalyticsEngine(ColumnarEventLog(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6c"):
        engine.measurement_windows("t", mesh="MESH")


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
