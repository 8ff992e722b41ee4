"""Device registry model.

Reference surface: sitewhere-core-api spi/device/ — IDevice, IDeviceType,
IDeviceAssignment, IDeviceCommand, IDeviceStatus, IDeviceGroup, IDeviceAlarm,
IDeviceElementMapping, DeviceAssignmentStatus.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sitewhere_tpu_torch.model.common import BrandedEntity, PersistentEntity


class DeviceContainerPolicy(enum.Enum):
    STANDALONE = "Standalone"
    COMPOSITE = "Composite"


@dataclass
class DeviceSlot:
    """Position where a child device may insert into a composite parent
    (spi/device/element/IDeviceSlot.java). `path` is the slot's segment
    within its containing unit."""

    name: str = ""
    path: str = ""


@dataclass
class DeviceUnit:
    """Logical group of related slots and subordinate units
    (spi/device/element/IDeviceUnit.java). `path` is this unit's segment
    within its parent."""

    name: str = ""
    path: str = ""
    device_slots: List[DeviceSlot] = field(default_factory=list)
    device_units: List["DeviceUnit"] = field(default_factory=list)


@dataclass
class DeviceElementSchema(DeviceUnit):
    """Root unit of a composite type's nesting schema
    (spi/device/element/IDeviceElementSchema.java — an IDeviceUnit whose
    own path is empty; slot paths address through nested unit segments,
    e.g. "bus/slot1")."""


def find_device_slot(schema: Optional[DeviceElementSchema],
                     path: str) -> Optional[DeviceSlot]:
    """Walk a '/'-separated schema path to its DeviceSlot, or None when
    any segment is missing (DeviceTypeUtils.getDeviceSlotByPath:62-90:
    every segment but the last names a nested unit; the last names a
    slot of the unit reached)."""
    if schema is None:
        return None
    segments = [s for s in path.split("/") if s]
    if not segments:
        return None
    unit: DeviceUnit = schema
    for segment in segments[:-1]:
        unit = next((u for u in unit.device_units if u.path == segment),
                    None)
        if unit is None:
            return None
    return next((s for s in unit.device_slots
                 if s.path == segments[-1]), None)


@dataclass
class DeviceType(BrandedEntity):
    """Hardware/firmware class of devices (IDeviceType)."""

    container_policy: DeviceContainerPolicy = DeviceContainerPolicy.STANDALONE
    # For COMPOSITE types: the unit/slot tree child devices map into
    # (None for standalone types).
    device_element_schema: Optional[DeviceElementSchema] = None


class ParameterType(enum.Enum):
    """Command parameter wire types (spi/device/command/ParameterType.java,
    mirroring protobuf scalar types)."""

    DOUBLE = "Double"
    FLOAT = "Float"
    INT32 = "Int32"
    INT64 = "Int64"
    UINT32 = "UInt32"
    UINT64 = "UInt64"
    SINT32 = "SInt32"
    SINT64 = "SInt64"
    FIXED32 = "Fixed32"
    FIXED64 = "Fixed64"
    SFIXED32 = "SFixed32"
    SFIXED64 = "SFixed64"
    BOOL = "Bool"
    STRING = "String"
    BYTES = "Bytes"


@dataclass
class CommandParameter:
    """One parameter of a device command (ICommandParameter)."""

    name: str = ""
    type: ParameterType = ParameterType.STRING
    required: bool = False


@dataclass
class DeviceCommand(PersistentEntity):
    """Command callable on devices of a type (IDeviceCommand)."""

    device_type_id: str = ""
    namespace: str = ""
    name: str = ""
    description: str = ""
    parameters: List[CommandParameter] = field(default_factory=list)


@dataclass
class DeviceStatus(PersistentEntity):
    """Named device status within a type's state machine (IDeviceStatus)."""

    device_type_id: str = ""
    code: str = ""
    name: str = ""
    background_color: str = ""
    foreground_color: str = ""
    border_color: str = ""
    icon: str = ""


@dataclass
class DeviceElementMapping:
    """Composite-device slot -> child device mapping (IDeviceElementMapping)."""

    device_element_schema_path: str = ""
    device_token: str = ""


@dataclass
class Device(PersistentEntity):
    """Registered device (IDevice)."""

    device_type_id: str = ""
    parent_device_id: str = ""  # set when mapped into a composite parent
    status: str = ""  # code of a DeviceStatus
    comments: str = ""
    device_element_mappings: List[DeviceElementMapping] = field(default_factory=list)


class DeviceAssignmentStatus(enum.IntEnum):
    """Assignment state machine (spi/device/DeviceAssignmentStatus.java).

    Integer-valued: mirrored into the registry lookup tensor
    (registry/tensors.py) so validation runs on device.
    """

    ACTIVE = 1
    MISSING = 2
    RELEASED = 3


@dataclass
class DeviceAssignment(PersistentEntity):
    """Binding of a device to customer/area/asset for a period (IDeviceAssignment).

    Events are always recorded against an assignment, not a raw device.
    """

    device_id: str = ""
    device_type_id: str = ""
    customer_id: str = ""
    area_id: str = ""
    asset_id: str = ""
    status: DeviceAssignmentStatus = DeviceAssignmentStatus.ACTIVE
    active_date: Optional[int] = None
    released_date: Optional[int] = None


class DeviceGroupRole:
    """Well-known group element roles (reference uses free-form role strings)."""

    GROUP = "group"
    DEVICE = "device"


@dataclass
class DeviceGroup(BrandedEntity):
    """Named set of devices/groups with roles (IDeviceGroup)."""

    roles: List[str] = field(default_factory=list)


@dataclass
class DeviceGroupElement(PersistentEntity):
    """Member of a device group (IDeviceGroupElement): device OR nested group."""

    group_id: str = ""
    device_id: str = ""
    nested_group_id: str = ""
    roles: List[str] = field(default_factory=list)


class DeviceAlarmState(enum.Enum):
    """Alarm lifecycle (spi/device/DeviceAlarmState.java)."""

    TRIGGERED = "Triggered"
    ACKNOWLEDGED = "Acknowledged"
    RESOLVED = "Resolved"


@dataclass
class DeviceAlarm(PersistentEntity):
    """Persistent alarm on a device (IDeviceAlarm), raised by rule processors."""

    device_id: str = ""
    device_assignment_id: str = ""
    customer_id: str = ""
    area_id: str = ""
    asset_id: str = ""
    alarm_message: str = ""
    triggering_event_id: str = ""
    state: DeviceAlarmState = DeviceAlarmState.TRIGGERED
    triggered_date: Optional[int] = None
    acknowledged_date: Optional[int] = None
    resolved_date: Optional[int] = None


@dataclass
class DeviceStream(PersistentEntity):
    """Binary stream declared by a device under an assignment (IDeviceStream,
    reference: sitewhere-core-api spi/device/streaming/IDeviceStream.java).
    `token` holds the stream id; chunks are DeviceStreamData events."""

    assignment_id: str = ""
    content_type: str = "application/octet-stream"
