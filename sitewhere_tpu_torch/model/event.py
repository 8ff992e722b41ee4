"""Device event model: the payloads of the hot path.

Reference surface: sitewhere-core-api spi/device/event/ — IDeviceEvent,
IDeviceMeasurement, IDeviceLocation, IDeviceAlert, IDeviceCommandInvocation,
IDeviceCommandResponse, IDeviceStateChange, IDeviceStreamData, DeviceEventType.

Design note: these dataclasses are the *control-plane/API* view.
On the hot path events never exist as Python objects per-event; they are packed
straight into the SoA tensor schema in sitewhere_tpu_torch.ops.pack (one fixed-width
column per field below) and only materialized back into dataclasses at the API
edge. Keep the two in sync: ops/pack.py cites this file.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sitewhere_tpu_torch.model.common import PersistentEntity, new_id, now_ms


class DeviceEventType(enum.IntEnum):
    """Event discriminator (spi/device/event/DeviceEventType.java).

    Integer-valued: the same codes are used in the packed `event_type` tensor
    column on device.
    """

    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5
    STREAM_DATA = 6


class AlertSource(enum.IntEnum):
    DEVICE = 0
    SYSTEM = 1


class AlertLevel(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


class CommandInitiator(enum.IntEnum):
    REST = 0
    BATCH_OPERATION = 1
    SCRIPT = 2
    SCHEDULER = 3


class CommandTarget(enum.IntEnum):
    ASSIGNMENT = 0


@dataclass
class DeviceEvent:
    """Base event (IDeviceEvent): identity + routing context + two timestamps.

    `event_date` is when the event happened on the device; `received_date` is
    when the platform ingested it (IDeviceEvent.getEventDate/getReceivedDate).
    """

    id: str = field(default_factory=new_id)
    alternate_id: str = ""  # client-supplied id used for deduplication
    event_type: DeviceEventType = DeviceEventType.MEASUREMENT
    device_id: str = ""
    device_assignment_id: str = ""
    customer_id: str = ""
    area_id: str = ""
    asset_id: str = ""
    event_date: int = field(default_factory=now_ms)
    received_date: int = field(default_factory=now_ms)
    metadata: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        from sitewhere_tpu_torch.model.common import _asdict
        d = _asdict(self)
        d["eventType"] = DeviceEventType(self.event_type).name
        return d


@dataclass
class DeviceMeasurement(DeviceEvent):
    """Named scalar sample (IDeviceMeasurement)."""

    event_type: DeviceEventType = DeviceEventType.MEASUREMENT
    name: str = ""
    value: float = 0.0


@dataclass
class DeviceLocation(DeviceEvent):
    """Geo fix (IDeviceLocation)."""

    event_type: DeviceEventType = DeviceEventType.LOCATION
    latitude: float = 0.0
    longitude: float = 0.0
    elevation: float = 0.0


@dataclass
class DeviceAlert(DeviceEvent):
    """Alert raised by device or system (IDeviceAlert)."""

    event_type: DeviceEventType = DeviceEventType.ALERT
    source: AlertSource = AlertSource.DEVICE
    level: AlertLevel = AlertLevel.INFO
    type: str = ""  # alert type code, e.g. "zone.violation"
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
class DeviceCommandResponse(DeviceEvent):
    """Device ack/response to an invocation (IDeviceCommandResponse)."""

    event_type: DeviceEventType = DeviceEventType.COMMAND_RESPONSE
    originating_event_id: str = ""
    response_event_id: str = ""
    response: str = ""


@dataclass
class DeviceStateChange(DeviceEvent):
    """Registration/presence/state transition (IDeviceStateChange)."""

    event_type: DeviceEventType = DeviceEventType.STATE_CHANGE
    attribute: str = ""  # e.g. "presence", "registration"
    type: str = ""
    previous_state: str = ""
    new_state: str = ""


@dataclass
class DeviceStreamData(DeviceEvent):
    """Chunk of a binary device stream (IDeviceStreamData)."""

    event_type: DeviceEventType = DeviceEventType.STREAM_DATA
    stream_id: str = ""
    sequence_number: int = 0
    data: bytes = b""


@dataclass
class DeviceEventBatch:
    """Decoded inbound batch for one device (IDeviceEventBatch): what a
    decoder yields from one wire payload."""

    device_token: str = ""
    measurements: List[DeviceMeasurement] = field(default_factory=list)
    locations: List[DeviceLocation] = field(default_factory=list)
    alerts: List[DeviceAlert] = field(default_factory=list)

    def all_events(self) -> List[DeviceEvent]:
        return [*self.measurements, *self.locations, *self.alerts]


@dataclass
class DeviceEventContext:
    """Enrichment envelope added after persistence (IDeviceEventContext /
    GDeviceEventContext in device-event-model.proto:288-321): the device &
    assignment fields rule processors and connectors need, resolved once."""

    device_id: str = ""
    device_token: str = ""
    device_type_id: str = ""
    assignment_id: str = ""
    customer_id: str = ""
    area_id: str = ""
    asset_id: str = ""
    tenant_id: str = ""


@dataclass
class DeviceRegistrationRequest:
    """Device self-registration payload (IDeviceRegistrationRequest)."""

    device_token: str = ""
    device_type_token: str = ""
    area_token: str = ""
    customer_token: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


EVENT_CLASS_BY_TYPE = {
    DeviceEventType.MEASUREMENT: DeviceMeasurement,
    DeviceEventType.LOCATION: DeviceLocation,
    DeviceEventType.ALERT: DeviceAlert,
    DeviceEventType.COMMAND_INVOCATION: DeviceCommandInvocation,
    DeviceEventType.COMMAND_RESPONSE: DeviceCommandResponse,
    DeviceEventType.STATE_CHANGE: DeviceStateChange,
    DeviceEventType.STREAM_DATA: DeviceStreamData,
}

_EVENT_ENUM_FIELDS = {
    "event_type": DeviceEventType,
    "source": AlertSource,
    "level": AlertLevel,
    "initiator": CommandInitiator,
    "target": CommandTarget,
}


_EVENT_HOOK_BY_TYPE = {
    DeviceEventType.MEASUREMENT: "on_measurement",
    DeviceEventType.LOCATION: "on_location",
    DeviceEventType.ALERT: "on_alert",
    DeviceEventType.COMMAND_INVOCATION: "on_command_invocation",
    DeviceEventType.COMMAND_RESPONSE: "on_command_response",
    DeviceEventType.STATE_CHANGE: "on_state_change",
    DeviceEventType.STREAM_DATA: "on_stream_data",
}


def dispatch_event(handler: Any, context: Any, event: DeviceEvent) -> None:
    """Route an event to the handler's typed `on_*` hook (the per-type switch
    of KafkaRuleProcessorHost.attemptToProcess / outbound connector
    processors). Missing hooks are no-ops."""
    hook = getattr(handler, _EVENT_HOOK_BY_TYPE.get(event.event_type, ""),
                   None)
    if hook is not None:
        hook(context, event)


def event_from_dict(data: Dict[str, Any]) -> DeviceEvent:
    """Rebuild a concrete DeviceEvent from its `to_dict()` form.

    The inverse of the proto->API conversion the reference does in
    EventModelConverter when a consumer pulls a payload off a Kafka topic.
    Unknown keys (like the redundant "eventType" name) are dropped so payloads
    stay forward-compatible.
    """
    import dataclasses as _dc

    etype = DeviceEventType(data["event_type"])
    cls = EVENT_CLASS_BY_TYPE[etype]
    names = {f.name for f in _dc.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        if key not in names:
            continue
        enum_cls = _EVENT_ENUM_FIELDS.get(key)
        if enum_cls is not None:
            value = enum_cls(value)
        kwargs[key] = value
    return cls(**kwargs)
