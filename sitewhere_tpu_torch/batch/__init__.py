"""Bulk device operations (reference: service-batch-operations)."""

from sitewhere_tpu_torch.batch.manager import (
    BatchCommandInvocationHandler, BatchManagement, BatchOperationManager,
    batch_command_invocation_request)

__all__ = ["BatchCommandInvocationHandler", "BatchManagement",
           "BatchOperationManager", "batch_command_invocation_request"]
