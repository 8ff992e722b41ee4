"""Device state model: the API view of one device's row of the state tensors
(counterpart of `sitewhere_tpu/model/state.py`; the fields
`PipelineEngine.get_device_state` fills)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class PresenceState(enum.IntEnum):
    PRESENT = 1
    NOT_PRESENT = 0


@dataclass
class DeviceState:
    device_id: str = ""
    last_interaction_date: Optional[int] = None
    presence_missing_date: Optional[int] = None
    presence: PresenceState = PresenceState.PRESENT
    # measurement name -> (event_date, value)
    last_measurements: Dict[str, tuple] = field(default_factory=dict)
    # (event_date, lat, lon, elevation)
    last_location: Optional[tuple] = None
    # alert type -> (event_date, level, message)
    last_alerts: Dict[str, tuple] = field(default_factory=dict)
