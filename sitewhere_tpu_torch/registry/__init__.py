"""Registry mirror: interners and the device-indexed lookup columns."""

from sitewhere_tpu_torch.registry.interning import TokenInterner
from sitewhere_tpu_torch.registry.store import (
    DeviceManagement, InMemoryStore, SqliteStore)
from sitewhere_tpu_torch.registry.tensors import (
    RegistrySnapshot, RegistryTensors)

__all__ = ["DeviceManagement", "InMemoryStore", "RegistrySnapshot",
           "RegistryTensors", "SqliteStore", "TokenInterner"]
