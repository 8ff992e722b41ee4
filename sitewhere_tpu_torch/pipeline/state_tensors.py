"""Device-resident per-device state: the tensorized service-device-state.

Counterpart of `sitewhere_tpu/pipeline/state_tensors.py`: fixed-capacity
tensors indexed by interned device index, updated wholesale per batch by
the keyed reductions of ops/segments.py. D devices, M tracked measurement
slots (measurement names with interned index < M), T tenants.
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device

_NEG = -(2 ** 31)


@dataclasses.dataclass
class DeviceStateTensors:
    """All tensors device-indexed unless noted. ts columns are rebased int32
    ms (EventPacker.epoch_base_ms); -2^31 = never."""

    last_interaction: torch.Tensor       # int32 [D]
    present: torch.Tensor                # bool [D]
    presence_missing_since: torch.Tensor  # int32 [D]
    event_count: torch.Tensor            # int32 [D]

    last_location: torch.Tensor          # f32 [D,3] lat/lon/elev
    last_location_ts: torch.Tensor       # int32 [D]

    last_measurement: torch.Tensor       # f32 [D,M]
    last_measurement_ts: torch.Tensor    # int32 [D,M]

    last_alert_type: torch.Tensor        # int32 [D]
    last_alert_level: torch.Tensor       # int32 [D]
    last_alert_ts: torch.Tensor          # int32 [D]

    tenant_event_count: torch.Tensor     # int32 [T]
    tenant_alert_count: torch.Tensor     # int32 [T]

    @property
    def num_devices(self) -> int:
        return self.last_interaction.shape[0]

    @property
    def num_measurement_slots(self) -> int:
        return self.last_measurement.shape[1]


def init_device_state(max_devices: int, measurement_slots: int = 32,
                      max_tenants: int = 16,
                      device: DeviceLike = "cuda") -> DeviceStateTensors:
    """Fresh state on `device`: every ts at the -2^31 "never" sentinel,
    counts at 0, no device present, last alert level -1."""
    dev = resolve_device(device)
    D, M, T = max_devices, measurement_slots, max_tenants
    i32, f32 = torch.int32, torch.float32

    def full(shape, value, dtype=i32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return DeviceStateTensors(
        last_interaction=full((D,), _NEG),
        present=full((D,), False, torch.bool),
        presence_missing_since=full((D,), _NEG),
        event_count=full((D,), 0),
        last_location=full((D, 3), 0.0, f32),
        last_location_ts=full((D,), _NEG),
        last_measurement=full((D, M), 0.0, f32),
        last_measurement_ts=full((D, M), _NEG),
        last_alert_type=full((D,), 0),
        last_alert_level=full((D,), -1),
        last_alert_ts=full((D,), _NEG),
        tenant_event_count=full((T,), 0),
        tenant_alert_count=full((T,), 0),
    )
