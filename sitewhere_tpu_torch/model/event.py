"""Device event model: the API view of the hot path's payloads.

Counterpart of `sitewhere_tpu/model/event.py` (reference surface:
sitewhere-core-api spi/device/event/). Only what the packer reads, the
alert materializer writes and the host families emit (presence state
changes, command invocations) is kept; events never exist as Python
objects on the hot path — they are packed into the SoA columns of
ops/pack.py.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict


def new_id() -> str:
    return str(uuid.uuid4())


def now_ms() -> int:
    return int(time.time() * 1000)


class DeviceEventType(enum.IntEnum):
    """Event discriminator; the same codes ride the packed `event_type`
    column on device."""

    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5
    STREAM_DATA = 6


class CommandInitiator(enum.IntEnum):
    REST = 0
    BATCH_OPERATION = 1
    SCRIPT = 2
    SCHEDULER = 3


class CommandTarget(enum.IntEnum):
    ASSIGNMENT = 0


class AlertSource(enum.IntEnum):
    DEVICE = 0
    SYSTEM = 1


class AlertLevel(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


@dataclass
class DeviceEvent:
    """Base event: identity, device and the two timestamps (event_date is
    when it happened on the device, received_date when it was ingested)."""

    id: str = field(default_factory=new_id)
    event_type: DeviceEventType = DeviceEventType.MEASUREMENT
    device_id: str = ""
    event_date: int = field(default_factory=now_ms)
    received_date: int = field(default_factory=now_ms)


@dataclass
class DeviceMeasurement(DeviceEvent):
    event_type: DeviceEventType = DeviceEventType.MEASUREMENT
    name: str = ""
    value: float = 0.0


@dataclass
class DeviceLocation(DeviceEvent):
    event_type: DeviceEventType = DeviceEventType.LOCATION
    latitude: float = 0.0
    longitude: float = 0.0
    elevation: float = 0.0


@dataclass
class DeviceAlert(DeviceEvent):
    """Alert raised by a device or by a rule (source SYSTEM)."""

    event_type: DeviceEventType = DeviceEventType.ALERT
    source: AlertSource = AlertSource.DEVICE
    level: AlertLevel = AlertLevel.INFO
    type: str = ""
    message: str = ""


@dataclass
class DeviceCommandInvocation(DeviceEvent):
    """Cloud->device command call (IDeviceCommandInvocation)."""

    event_type: DeviceEventType = DeviceEventType.COMMAND_INVOCATION
    initiator: CommandInitiator = CommandInitiator.REST
    initiator_id: str = ""
    target: CommandTarget = CommandTarget.ASSIGNMENT
    target_id: str = ""
    device_command_id: str = ""
    command_token: str = ""
    parameter_values: Dict[str, str] = field(default_factory=dict)


@dataclass
class DeviceStateChange(DeviceEvent):
    """Registration/presence/state transition (IDeviceStateChange)."""

    event_type: DeviceEventType = DeviceEventType.STATE_CHANGE
    attribute: str = ""  # e.g. "presence", "registration"
    type: str = ""
    previous_state: str = ""
    new_state: str = ""
