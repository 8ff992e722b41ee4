"""Core runtime: lifecycle tree, config, metrics/tracing, event bus, engines.

Reference layer L1 (sitewhere-core-lifecycle, sitewhere-microservice,
sitewhere-configuration) rebuilt for an in-process deployment:
services are lifecycle components inside one process per host, the event data
plane is an in-proc/file-backed partitioned log instead of Kafka brokers, and
configuration is layered files/dicts with live-reload instead of ZooKeeper XML.
"""

from sitewhere_tpu_torch.runtime.lifecycle import (
    LifecycleComponent,
    LifecycleStatus,
    CompositeLifecycleStep,
    LifecycleProgressMonitor,
)
from sitewhere_tpu_torch.runtime.bus import EventBus, Topic, TopicNaming, ConsumerGroup
from sitewhere_tpu_torch.runtime.config import Configuration
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.tracing import Tracer, Span

__all__ = [name for name in dir() if not name.startswith("_")]
