"""Batch operation model (sitewhere-core-api spi/batch/IBatchOperation.java,
IBatchElement.java): bulk actions fanned out across many devices."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sitewhere_tpu_torch.model.common import PersistentEntity


class BatchOperationStatus(enum.Enum):
    UNPROCESSED = "Unprocessed"
    INITIALIZING = "Initializing"
    INITIALIZED_SUCCESSFULLY = "InitializedSuccessfully"
    INITIALIZED_WITH_ERRORS = "InitializedWithErrors"
    FINISHED_SUCCESSFULLY = "FinishedSuccessfully"
    FINISHED_WITH_ERRORS = "FinishedWithErrors"


class ElementProcessingStatus(enum.Enum):
    UNPROCESSED = "Unprocessed"
    INITIALIZED = "Initialized"
    PROCESSING = "Processing"
    FAILED = "Failed"
    SUCCEEDED = "Succeeded"


class BatchOperationTypes:
    """Well-known operation types (reference BatchOperationTypes)."""

    INVOKE_COMMAND = "InvokeCommand"


@dataclass
class BatchOperation(PersistentEntity):
    """Bulk operation over a device list (IBatchOperation)."""

    operation_type: str = BatchOperationTypes.INVOKE_COMMAND
    parameters: Dict[str, str] = field(default_factory=dict)
    device_tokens: List[str] = field(default_factory=list)
    processing_status: BatchOperationStatus = BatchOperationStatus.UNPROCESSED
    processing_started_date: Optional[int] = None
    processing_ended_date: Optional[int] = None


@dataclass
class BatchElement(PersistentEntity):
    """Per-device element of a batch operation (IBatchElement)."""

    batch_operation_id: str = ""
    device_id: str = ""
    processing_status: ElementProcessingStatus = ElementProcessingStatus.UNPROCESSED
    processed_date: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)
