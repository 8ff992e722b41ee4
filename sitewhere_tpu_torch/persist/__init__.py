"""Persistence tier: the columnar event log, the event-management API,
crash-safe writes and the engine's checkpoints."""

from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog, EventFilter
from sitewhere_tpu_torch.persist.event_management import (
    DeviceEventManagement, EventIndex, EventPersistenceTriggers)
from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer
from sitewhere_tpu_torch.persist.worker import AsyncEventPersister

__all__ = [
    "ColumnarEventLog", "EventFilter", "DeviceEventManagement", "EventIndex",
    "EventPersistenceTriggers", "PipelineCheckpointer", "AsyncEventPersister",
]
