"""Multi-host deployment: the control-plane cluster
(`cluster.ControlPlaneCluster`, its gossip, leases and telemetry fan-in).
The sharded engine, its router and the SPMD cluster are the sharded path
(ROADMAP A6)."""

from sitewhere_tpu_torch.parallel.cluster import (
    ControlPlaneCluster, RegistryGossip, TakeoverMonitor)

__all__ = ["ControlPlaneCluster", "RegistryGossip", "TakeoverMonitor"]
