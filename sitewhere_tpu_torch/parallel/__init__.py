"""Scaling out: the shard axis (`mesh`), the host router (`router`), the
sharded engine (`engine`), window-sharded analytics and the cluster
bootstrap (`distributed`), and the clusters (`cluster`): the control plane
(`ControlPlaneCluster`, its gossip, leases and telemetry fan-in) and the
multi-host data plane (`ClusterService`, its lockstep step loop and
foreign-row forwarding)."""

from sitewhere_tpu_torch.parallel.cluster import (
    ClusterControl, ClusterService, ClusterStepLoop, ControlPlaneCluster,
    RegistryGossip, TakeoverMonitor)
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, live_mesh, make_global_mesh, process_shard_indices,
    sharded_windowed_stats)
from sitewhere_tpu_torch.parallel.engine import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.mesh import make_mesh, shard_axis_size
from sitewhere_tpu_torch.parallel.router import ShardRouter

__all__ = ["ClusterControl", "ClusterService", "ClusterStepLoop",
           "ControlPlaneCluster", "RegistryGossip", "TakeoverMonitor",
           "ShardRouter", "ShardedPipelineEngine", "make_mesh",
           "shard_axis_size", "initialize", "live_mesh", "make_global_mesh",
           "process_shard_indices", "sharded_windowed_stats"]
