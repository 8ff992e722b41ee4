"""Disaggregated feeder fleet: pack anywhere, step on the landing host.

The landing host's per-event work (decode -> intern -> pack)
is what caps the headline rate at a fraction of the device ceiling
(flight recorder + age waterfall diagnosis, docs/PERF.md). tf.data
service (Audibert et al.) makes the case for disaggregating input
processing onto a worker fleet; this package applies it to the event
pipeline with the platform's own primitives:

* feeders own TTL-leased source partitions (runtime/recovery.py
  LeaseTable + EpochFence — fenced takeover at epoch+1, exactly-once
  replay via per-partition watermarks),
* interner replicas stay bit-identical through an append-only token
  journal replicated over busnet (registry/interning.py journal ops),
* ready-to-stage wire blobs ship with their age sidecar and traceparent,
  and the landing host does only H2D-into-StagingRing + step.

See docs/FEEDERS.md for the architecture and protocol walkthrough.
"""

from sitewhere_tpu_torch.feeders.protocol import (
    blob_message, decode_blob, feeder_fence_key, partition_resource)
from sitewhere_tpu_torch.feeders.replica import ReplicaPacker
from sitewhere_tpu_torch.feeders.service import FeederService
from sitewhere_tpu_torch.feeders.worker import FeederWorker

__all__ = [
    "FeederService", "FeederWorker", "ReplicaPacker",
    "blob_message", "decode_blob", "feeder_fence_key",
    "partition_resource",
]
