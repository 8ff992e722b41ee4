"""Scaling out: the shard axis on one card (`mesh`), the host router
(`router`), the sharded engine (`engine`), window-sharded analytics and
the cluster bootstrap (`distributed`), and the control-plane cluster
(`cluster.ControlPlaneCluster`, its gossip, leases and telemetry fan-in).
The multi-host data plane (ROADMAP A6d) is not here yet."""

from sitewhere_tpu_torch.parallel.cluster import (
    ControlPlaneCluster, RegistryGossip, TakeoverMonitor)
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, live_mesh, make_global_mesh, process_shard_indices,
    sharded_windowed_stats)
from sitewhere_tpu_torch.parallel.engine import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.mesh import make_mesh, shard_axis_size
from sitewhere_tpu_torch.parallel.router import ShardRouter

__all__ = ["ControlPlaneCluster", "RegistryGossip", "TakeoverMonitor",
           "ShardRouter", "ShardedPipelineEngine", "make_mesh",
           "shard_axis_size", "initialize", "live_mesh", "make_global_mesh",
           "process_shard_indices", "sharded_windowed_stats"]
