"""Batch operations: bulk actions fanned out over device lists.

Reference: service-batch-operations — gRPC BatchManagementImpl (CRUD over
IBatchOperation/IBatchElement), BatchOperationManager.java:46 (throttled
executor :55 working through elements, updating per-element status), and
handler/BatchCommandInvocationHandler.java (one command invocation per
device, resolved against its active assignment).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Protocol

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.batch import (
    BatchElement, BatchOperation, BatchOperationStatus, BatchOperationTypes,
    ElementProcessingStatus)
from sitewhere_tpu_torch.model.common import (
    SearchCriteria, SearchResults, new_id, now_ms, page)
from sitewhere_tpu_torch.model.event import (
    CommandInitiator, CommandTarget, DeviceCommandInvocation)
from sitewhere_tpu_torch.registry.store import InMemoryStore, _Collection
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.batch")


def batch_command_invocation_request(
        command_token: str, parameters: Dict[str, str],
        device_tokens: List[str], token: str = "") -> BatchOperation:
    """Build an InvokeCommand batch operation
    (BatchSpecUtils.createBatchCommandInvocation)."""
    return BatchOperation(
        token=token or new_id(),
        operation_type=BatchOperationTypes.INVOKE_COMMAND,
        parameters={"commandToken": command_token,
                    **{f"param_{k}": v for k, v in parameters.items()}},
        device_tokens=list(device_tokens))


class BatchManagement:
    """Persistence API for batch operations (IBatchManagement)."""

    def __init__(self, store=None):
        store = store or InMemoryStore()
        self.operations: _Collection[BatchOperation] = _Collection(
            "batch_operation", BatchOperation, store,
            ErrorCode.INVALID_BATCH_OPERATION_TOKEN)
        self.elements: _Collection[BatchElement] = _Collection(
            "batch_element", BatchElement, store,
            ErrorCode.INVALID_BATCH_OPERATION_TOKEN)

    def create_batch_operation(self, operation: BatchOperation,
                               registry=None) -> BatchOperation:
        """Create the operation + one element per device
        (BatchManagementImpl.createBatchOperation)."""
        created = self.operations.create(operation)
        for token in operation.device_tokens:
            device_id = token
            if registry is not None:
                device = registry.get_device_by_token(token)
                # unknown token: keep the element with the unresolved token as
                # its device_id — the handler fails it, surfacing the missing
                # device in the operation's FINISHED_WITH_ERRORS status
                device_id = device.id if device is not None else token
            self.elements.create(BatchElement(
                token=new_id(), batch_operation_id=created.id,
                device_id=device_id, metadata={"deviceToken": token}))
        return created

    def get_batch_operation_by_token(self, token: str) -> BatchOperation:
        return self.operations.require_by_token(token)

    def list_batch_operations(self, criteria: Optional[SearchCriteria] = None
                              ) -> SearchResults[BatchOperation]:
        return self.operations.list(criteria)

    def list_batch_elements(self, operation_token: str,
                            criteria: Optional[SearchCriteria] = None
                            ) -> SearchResults[BatchElement]:
        operation = self.operations.require_by_token(operation_token)
        items = [e for e in self.elements.all()
                 if e.batch_operation_id == operation.id]
        return page(items, criteria or SearchCriteria())

    def update_operation_status(self, operation_id: str,
                                status: BatchOperationStatus) -> None:
        updates: Dict = {"processing_status": status}
        if status == BatchOperationStatus.INITIALIZING:
            updates["processing_started_date"] = now_ms()
        elif status in (BatchOperationStatus.FINISHED_SUCCESSFULLY,
                        BatchOperationStatus.FINISHED_WITH_ERRORS):
            updates["processing_ended_date"] = now_ms()
        self.operations.update(operation_id, updates)

    def update_element_status(self, element: BatchElement,
                              status: ElementProcessingStatus,
                              metadata: Optional[Dict[str, str]] = None) -> None:
        updates: Dict = {"processing_status": status,
                         "processed_date": now_ms()}
        if metadata:
            updates["metadata"] = {**element.metadata, **metadata}
        self.elements.update(element.id, updates)


class OperationHandler(Protocol):
    """Per-element work (IBatchOperationHandler): returns result metadata."""

    def process(self, operation: BatchOperation,
                element: BatchElement) -> Dict[str, str]: ...


class BatchCommandInvocationHandler:
    """Create one DeviceCommandInvocation per element, persisted through
    event management against the device's active assignment
    (BatchCommandInvocationHandler.java)."""

    def __init__(self, registry, events):
        self.registry = registry
        self.events = events

    def process(self, operation: BatchOperation,
                element: BatchElement) -> Dict[str, str]:
        command_token = operation.parameters.get("commandToken", "")
        command = self.registry.device_commands.get_by_token(command_token)
        if command is None:
            raise SiteWhereError(f"unknown command '{command_token}'",
                                 ErrorCode.INVALID_COMMAND_TOKEN)
        device = self.registry.devices.get(element.device_id)
        if device is None:
            raise SiteWhereError("unknown device in batch element")
        assignment = self.registry.get_active_assignment(device.id)
        if assignment is None:
            raise SiteWhereError(f"device '{device.token}' not assigned",
                                 ErrorCode.DEVICE_NOT_ASSIGNED)
        parameters = {k[len("param_"):]: v
                      for k, v in operation.parameters.items()
                      if k.startswith("param_")}
        invocation = DeviceCommandInvocation(
            initiator=CommandInitiator.BATCH_OPERATION,
            initiator_id=operation.token, target=CommandTarget.ASSIGNMENT,
            target_id=assignment.token, command_token=command.token,
            device_command_id=command.id, parameter_values=parameters)
        persisted = self.events.add_command_invocations(assignment.token,
                                                        invocation)
        return {"invocationId": persisted[0].id}


class BatchOperationManager(LifecycleComponent):
    """Works through batch operations with optional throttling
    (BatchOperationManager.java:46, throttle :55)."""

    def __init__(self, batch: BatchManagement,
                 throttle_delay_ms: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__("batch-operation-manager")
        self.batch = batch
        self.throttle_delay_ms = throttle_delay_ms
        self.handlers: Dict[str, OperationHandler] = {}
        m = (metrics or MetricsRegistry()).scoped("batch")
        self.processed_counter = m.counter("elements_processed")
        self.failed_counter = m.counter("elements_failed")

    def register_handler(self, operation_type: str,
                         handler: OperationHandler) -> None:
        self.handlers[operation_type] = handler

    def process(self, operation: BatchOperation) -> BatchOperation:
        """Process all elements synchronously; returns the finished op."""
        handler = self.handlers.get(operation.operation_type)
        if handler is None:
            raise SiteWhereError(
                f"no handler for operation type '{operation.operation_type}'")
        self.batch.update_operation_status(operation.id,
                                           BatchOperationStatus.INITIALIZING)
        elements = [e for e in self.batch.elements.all()
                    if e.batch_operation_id == operation.id]
        errors = 0
        for element in elements:
            self.batch.update_element_status(element,
                                             ElementProcessingStatus.PROCESSING)
            try:
                result = handler.process(operation, element)
                self.batch.update_element_status(
                    element, ElementProcessingStatus.SUCCEEDED, result)
                self.processed_counter.inc()
            except Exception as exc:
                errors += 1
                self.failed_counter.inc()
                self.batch.update_element_status(
                    element, ElementProcessingStatus.FAILED,
                    {"error": str(exc)})
            if self.throttle_delay_ms:
                time.sleep(self.throttle_delay_ms / 1000.0)
        status = (BatchOperationStatus.FINISHED_WITH_ERRORS if errors
                  else BatchOperationStatus.FINISHED_SUCCESSFULLY)
        self.batch.update_operation_status(operation.id, status)
        return self.batch.operations.get(operation.id)

    def submit(self, operation: BatchOperation) -> threading.Thread:
        """Async processing on a worker thread (the reference's executor)."""
        thread = threading.Thread(target=self.process, args=(operation,),
                                  name=f"batch-{operation.token}", daemon=True)
        thread.start()
        return thread
