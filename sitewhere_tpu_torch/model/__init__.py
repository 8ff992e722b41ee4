"""API-level model of the hot path (events, alerts, device state)."""

from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert, DeviceEvent, DeviceEventType,
    DeviceLocation, DeviceMeasurement)
from sitewhere_tpu_torch.model.state import DeviceState, PresenceState

__all__ = [
    "AlertLevel", "AlertSource", "DeviceAlert", "DeviceEvent",
    "DeviceEventType", "DeviceLocation", "DeviceMeasurement", "DeviceState",
    "PresenceState",
]
