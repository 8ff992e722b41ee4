"""Scaling out: the shard axis on one card (`mesh`), the host router
(`router`), the sharded engine (`engine`), and the control-plane cluster
(`cluster.ControlPlaneCluster`, its gossip, leases and telemetry fan-in).
Sharded analytics (ROADMAP A6c) and the multi-host data plane (A6d) are
not here yet."""

from sitewhere_tpu_torch.parallel.cluster import (
    ControlPlaneCluster, RegistryGossip, TakeoverMonitor)
from sitewhere_tpu_torch.parallel.engine import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.mesh import make_mesh, shard_axis_size
from sitewhere_tpu_torch.parallel.router import ShardRouter

__all__ = ["ControlPlaneCluster", "RegistryGossip", "TakeoverMonitor",
           "ShardRouter", "ShardedPipelineEngine", "make_mesh",
           "shard_axis_size"]
