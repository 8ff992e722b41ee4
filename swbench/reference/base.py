"""The few types the frozen reference modules share: the event batch, the
event and alert enums, the compilers' error type and the device helper.

Mirrors sitewhere_tpu_torch/ops/pack.py EventBatch, model/event.py
DeviceEventType / AlertLevel / AlertSource, errors.py ErrorCode.GENERIC /
SiteWhereError and device.py resolve_device, at commit f8b6811.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    return torch.device(device)


class DeviceEventType(enum.IntEnum):
    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5


class AlertSource(enum.IntEnum):
    DEVICE = 0
    SYSTEM = 1


class AlertLevel(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


class ErrorCode(enum.IntEnum):
    GENERIC = 9999


class SiteWhereError(Exception):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.GENERIC,
                 http_status: int = 400):
        super().__init__(message)
        self.code = code
        self.http_status = http_status


@dataclasses.dataclass
class EventBatch:
    """SoA columns, all [B] tensors, as the step sees them after the wire
    unpack: value/mm_idx only on measurement rows, lat/lon only on location
    rows, alert_type_idx only on alert rows, zeros elsewhere."""

    device_idx: torch.Tensor      # int32
    tenant_idx: torch.Tensor      # int32 (filled by validation)
    event_type: torch.Tensor      # int32 DeviceEventType
    ts: torch.Tensor              # int32 ms since the epoch base
    mm_idx: torch.Tensor          # int32
    value: torch.Tensor           # float32
    lat: torch.Tensor             # float32
    lon: torch.Tensor             # float32
    elevation: torch.Tensor       # float32
    alert_type_idx: torch.Tensor  # int32
    alert_level: torch.Tensor     # int32
    valid: torch.Tensor           # bool

    @property
    def batch_size(self) -> int:
        return self.device_idx.shape[0]

    def replace(self, **changes) -> "EventBatch":
        return dataclasses.replace(self, **changes)
