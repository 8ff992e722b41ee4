"""API-level model of the hot path (events, alerts, device state)."""

from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, CommandInitiator, DeviceAlert,
    DeviceCommandInvocation, DeviceEvent, DeviceEventType, DeviceLocation,
    DeviceMeasurement, DeviceStateChange)
from sitewhere_tpu_torch.model.state import DeviceState, PresenceState

__all__ = [
    "AlertLevel", "AlertSource", "CommandInitiator", "DeviceAlert",
    "DeviceCommandInvocation", "DeviceEvent", "DeviceEventType",
    "DeviceLocation", "DeviceMeasurement", "DeviceState",
    "DeviceStateChange", "PresenceState",
]
