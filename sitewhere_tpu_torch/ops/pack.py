"""Event packing: API events -> fixed-width SoA columns -> the int32 wire blob.

Counterpart of `sitewhere_tpu/ops/pack.py`. The device view of events is
`EventBatch`: one [B] tensor per field with a validity mask for padding, so
variable-rate ingest never changes shapes. Timestamps are int32 ms relative
to a host-held `epoch_base_ms` (int32 covers +-24 days per base).

The host stages each batch as ONE int32 wire blob (`batch_to_blob`, numpy;
its bytes are identical to the JAX package's) and the step unpacks it on
the device (`blob_to_batch`, torch). Three layouts, picked per batch:

  5 rows, 20 B/event:
    row 0: device_idx (bits 0-21) | event_type (22-24) |
           alert_level (25-27) | valid (28)
    row 1: ts (int32 ms, relative)
    row 2: payload A — value f32 bits (measurement) | lat f32 bits (location)
    row 3: payload B — mm_idx (measurement) | lon f32 bits (location) |
           alert_type_idx (alert)
    row 4: elevation f32 bits
  4 rows (compact), 16 B/event: the 5-row layout without row 4, when no
    row carries an elevation (elevation reads as 0).
  3 rows (packed), 12 B/event: measurement/alert-only batches whose valid
    timestamps span <= 65535 ms. Row 1 carries a 16-bit ts delta (bits
    0-15) and the 12-bit mm_idx/alert_type_idx (bits 16-27); row 2 the f32
    value; the 32-bit ts base rides row 0's spare bits 29-31 across lanes
    0..10, 3 bits per lane, two's complement.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.model.event import (
    DeviceAlert, DeviceEvent, DeviceEventType, DeviceLocation,
    DeviceMeasurement)
from sitewhere_tpu_torch.registry.interning import TokenInterner


@dataclasses.dataclass
class EventBatch:
    """SoA columns, all [B] tensors (host batches live on the CPU; the step
    sees them on its device)."""

    device_idx: torch.Tensor      # int32, interned device token (0 = unknown)
    tenant_idx: torch.Tensor      # int32, interned tenant (filled by validation)
    event_type: torch.Tensor      # int32, DeviceEventType value
    ts: torch.Tensor              # int32, ms since epoch_base
    mm_idx: torch.Tensor          # int32, interned measurement name
    value: torch.Tensor           # float32, measurement value
    lat: torch.Tensor             # float32
    lon: torch.Tensor             # float32
    elevation: torch.Tensor       # float32
    alert_type_idx: torch.Tensor  # int32, interned alert type code
    alert_level: torch.Tensor     # int32, AlertLevel value
    valid: torch.Tensor           # bool, False for padding rows


WIRE_ROWS = 5
WIRE_ROWS_COMPACT = 4
WIRE_ROWS_PACKED = 3
_TS_DELTA_BITS = 16
_TS_DELTA_MASK = (1 << _TS_DELTA_BITS) - 1
_PKIDX_SHIFT = 16
_BASE_SHIFT = 29     # row-0 bits 29..31 carry the ts base, lanes 0..10
_BASE_LANES = 11
WIRE_DEV_BITS = 22
WIRE_DEV_MAX = 1 << WIRE_DEV_BITS   # 4.19M interned devices per wire batch
_ET_SHIFT = 22
_LEVEL_SHIFT = 25
_VALID_SHIFT = 28
_META_MAX_IDX = 1 << 12  # mm_idx / alert_type_idx interner width

_ET_MEASUREMENT = int(DeviceEventType.MEASUREMENT)
_ET_LOCATION = int(DeviceEventType.LOCATION)
_ET_ALERT = int(DeviceEventType.ALERT)


def wire_variant_for(batch: EventBatch) -> Tuple[int, int]:
    """(wire_rows, ts_base) for a host batch: packed 3-row when it has no
    elevation, no location events and a valid-ts span under 2^16 ms;
    compact 4-row when only the elevation is absent; full 5-row otherwise.
    ts_base is meaningful for the packed variant only."""
    if np.any(np.asarray(batch.elevation)):
        return WIRE_ROWS, 0
    valid = np.asarray(batch.valid)
    if valid.shape[-1] >= _BASE_LANES \
            and not np.any(np.asarray(batch.event_type) == _ET_LOCATION):
        ts = np.asarray(batch.ts)
        lo = int(ts.min(where=valid, initial=2 ** 31 - 1))
        hi = int(ts.max(where=valid, initial=-(2 ** 31)))
        if hi < lo:  # no valid rows
            return WIRE_ROWS_PACKED, 0
        if hi - lo <= _TS_DELTA_MASK:
            return WIRE_ROWS_PACKED, lo
    return WIRE_ROWS_COMPACT, 0


def _embed_ts_base(row0: np.ndarray, ts_base: int) -> None:
    """Scatter the 32-bit ts base over row 0's spare bits, 3 per lane (lane
    10 carries the top 2). Bit work on a uint32 view so bit 31 never trips
    int32 overflow handling."""
    lanes = row0[:_BASE_LANES].view(np.uint32)
    base = np.uint32(int(ts_base) & 0xFFFFFFFF)
    for lane in range(_BASE_LANES):
        lanes[lane] |= ((base >> np.uint32(3 * lane)) & np.uint32(7)) \
            << np.uint32(_BASE_SHIFT)


def batch_to_blob(batch: EventBatch,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a host batch into the wire blob (numpy, [rows, B] int32) in the
    smallest layout its content allows. A well-formed batch — anything the
    packer produces — round-trips exactly.

    `out` is an optional preallocated [WIRE_ROWS, B] int32 buffer (the
    engine passes a pinned staging buffer): the blob is written into its
    first `rows` rows and that contiguous view is returned."""
    B = batch.device_idx.shape[-1]
    rows, ts_base = wire_variant_for(batch)
    dev = np.asarray(batch.device_idx, np.int32)
    if dev.size and (int(dev.max()) >= WIRE_DEV_MAX or int(dev.min()) < 0):
        raise ValueError(
            f"device_idx out of wire-blob device field range "
            f"[0, {WIRE_DEV_MAX}): min {int(dev.min())}, "
            f"max {int(dev.max())}")
    et = np.asarray(batch.event_type, np.int32) & 7
    is_loc = et == _ET_LOCATION
    is_alert = et == _ET_ALERT
    if out is not None and out.shape[-1] == B and out.ndim == 2 \
            and out.shape[0] >= rows:
        blob = out[:rows]
    else:
        blob = np.empty((rows, B), np.int32)
    valid = np.asarray(batch.valid)
    blob[0] = (dev
               | (et << _ET_SHIFT)
               | (np.asarray(batch.alert_level, np.int32) & 7) << _LEVEL_SHIFT
               | valid.astype(np.int32) << _VALID_SHIFT)
    # mm_idx/alert_type_idx keep the 12-bit wire mask: a negative or
    # oversized index must never reach the device-side `idx < M` guards
    idx_mask = _META_MAX_IDX - 1
    if rows == WIRE_ROWS_PACKED:
        delta = np.where(valid,
                         np.asarray(batch.ts, np.int32) - np.int32(ts_base),
                         0) & _TS_DELTA_MASK
        idx = np.where(is_alert,
                       np.asarray(batch.alert_type_idx, np.int32),
                       np.asarray(batch.mm_idx, np.int32)) & idx_mask
        blob[1] = delta | (idx << _PKIDX_SHIFT)
        blob[2] = np.asarray(batch.value, np.float32).view(np.int32)
        _embed_ts_base(blob[0], ts_base)
        return blob
    blob[1] = np.asarray(batch.ts, np.int32)
    blob[2] = np.where(
        is_loc, np.asarray(batch.lat, np.float32).view(np.int32),
        np.asarray(batch.value, np.float32).view(np.int32))
    blob[3] = np.where(
        is_loc, np.asarray(batch.lon, np.float32).view(np.int32),
        np.where(is_alert,
                 np.asarray(batch.alert_type_idx, np.int32) & idx_mask,
                 np.asarray(batch.mm_idx, np.int32) & idx_mask))
    if rows >= WIRE_ROWS:
        blob[4] = np.asarray(batch.elevation, np.float32).view(np.int32)
    return blob


def blob_to_batch(blob: torch.Tensor) -> EventBatch:
    """Inverse of batch_to_blob on the blob's device (torch ops). The
    variant follows the row count. Columns that the blob holds verbatim
    (ts, elevation) are views of it."""
    if blob.dtype != torch.int32 or blob.dim() != 2:
        raise ValueError(f"wire blob must be a 2-D int32 tensor, got "
                         f"{tuple(blob.shape)} {blob.dtype}")
    blob = blob.contiguous()
    rows = blob.shape[0]
    r0 = blob[0]
    et = (r0 >> _ET_SHIFT) & 7
    is_meas = et == _ET_MEASUREMENT
    is_alert = et == _ET_ALERT
    zf = torch.zeros(r0.shape, dtype=torch.float32, device=blob.device)
    common = dict(
        device_idx=r0 & (WIRE_DEV_MAX - 1),
        tenant_idx=torch.zeros_like(r0),
        event_type=et,
        alert_level=(r0 >> _LEVEL_SHIFT) & 7,
        valid=(r0 & (1 << _VALID_SHIFT)) != 0)
    if rows == WIRE_ROWS_PACKED:
        r1 = blob[1]
        spare = (r0[:_BASE_LANES] >> _BASE_SHIFT) & 7
        shifts = torch.arange(0, 3 * _BASE_LANES, 3, dtype=torch.int32,
                              device=blob.device)
        # int32 shifts wrap mod 2^32 (lane 10's bits land on 30/31) and the
        # 3-bit fields never overlap, so the int64 sum IS their bitwise OR:
        # the base's two's complement rebuilt exactly
        base = (spare << shifts).sum(dtype=torch.int64).to(torch.int32)
        idx = (r1 >> _PKIDX_SHIFT) & (_META_MAX_IDX - 1)
        return EventBatch(
            ts=base + (r1 & _TS_DELTA_MASK),
            mm_idx=torch.where(is_meas, idx, 0),
            value=torch.where(is_meas, blob[2].view(torch.float32), zf),
            lat=zf, lon=zf, elevation=zf,
            alert_type_idx=torch.where(is_alert, idx, 0),
            **common)
    if rows not in (WIRE_ROWS, WIRE_ROWS_COMPACT):
        raise ValueError(f"wire blob has {rows} rows; expected 3, 4 or 5")
    is_loc = et == _ET_LOCATION
    pa, pb = blob[2], blob[3]
    fa, fb = pa.view(torch.float32), pb.view(torch.float32)
    return EventBatch(
        ts=blob[1],
        mm_idx=torch.where(is_meas, pb, 0),
        value=torch.where(is_meas, fa, zf),
        lat=torch.where(is_loc, fa, zf),
        lon=torch.where(is_loc, fb, zf),
        elevation=(blob[4].view(torch.float32) if rows == WIRE_ROWS
                   else zf),
        alert_type_idx=torch.where(is_alert, pb, 0),
        **common)


class EventPacker:
    """Host-side packer: Python events / raw columns -> host EventBatch.

    Owns the measurement-name and alert-type interners; device tokens are
    interned against the registry's device interner so packed indices line
    up with the registry columns."""

    # int32 range minus a margin for the -2^31 "never" sentinel in state
    _REL_MIN = -(2 ** 31) + 2
    _REL_MAX = 2 ** 31 - 1

    def __init__(self, batch_size: int, device_interner: TokenInterner,
                 max_measurement_names: int = 1024,
                 max_alert_types: int = 1024,
                 epoch_base_ms: Optional[int] = None):
        if max_measurement_names > _META_MAX_IDX or \
                max_alert_types > _META_MAX_IDX:
            raise ValueError(
                f"measurement/alert-type interner capacity is limited to "
                f"{_META_MAX_IDX} by the wire-blob meta field width")
        self.batch_size = batch_size
        self.devices = device_interner
        self.measurements = TokenInterner(max_measurement_names,
                                          "measurements")
        self.alert_types = TokenInterner(max_alert_types, "alert_types")
        self.epoch_base_ms = (epoch_base_ms if epoch_base_ms is not None
                              else int(time.time() * 1000))

    def rel_ts(self, ts_ms: int) -> int:
        # events dated before epoch_base (delayed delivery, replay) rebase
        # negative; clamp to the int32 range
        rel = int(ts_ms - self.epoch_base_ms)
        return max(self._REL_MIN, min(self._REL_MAX, rel))

    def abs_ts(self, rel: int) -> int:
        return self.epoch_base_ms + int(rel)

    def pack_events(self, events: Sequence[DeviceEvent],
                    device_tokens: Sequence[str]) -> List[EventBatch]:
        """Pack API events (paired with their device tokens) into one or
        more fixed-size batches."""
        return [self._pack_chunk(events[s:s + self.batch_size],
                                 device_tokens[s:s + self.batch_size])
                for s in range(0, len(events), self.batch_size)]

    def _pack_chunk(self, events: Sequence[DeviceEvent],
                    tokens: Sequence[str]) -> EventBatch:
        B = self.batch_size
        cols = {name: np.zeros(B, np.int32) for name in (
            "device_idx", "event_type", "ts", "mm_idx", "alert_type_idx",
            "alert_level")}
        cols.update({name: np.zeros(B, np.float32) for name in (
            "value", "lat", "lon", "elevation")})
        valid = np.zeros(B, bool)
        for i, (event, token) in enumerate(zip(events, tokens)):
            cols["device_idx"][i] = self.devices.lookup(token)
            cols["event_type"][i] = int(event.event_type)
            cols["ts"][i] = self.rel_ts(event.event_date)
            valid[i] = True
            if isinstance(event, DeviceMeasurement):
                cols["mm_idx"][i] = self.measurements.intern(event.name)
                cols["value"][i] = event.value
            elif isinstance(event, DeviceLocation):
                cols["lat"][i] = event.latitude
                cols["lon"][i] = event.longitude
                cols["elevation"][i] = event.elevation
            elif isinstance(event, DeviceAlert):
                cols["alert_type_idx"][i] = self.alert_types.intern(
                    event.type)
                cols["alert_level"][i] = int(event.level)
        return EventBatch(
            tenant_idx=torch.zeros(B, dtype=torch.int32),
            valid=torch.from_numpy(valid),
            **{k: torch.from_numpy(v) for k, v in cols.items()})

    def pack_columns(self, device_idx: np.ndarray, event_type: np.ndarray,
                     ts_ms_abs: np.ndarray, *,
                     mm_idx: Optional[np.ndarray] = None,
                     value: Optional[np.ndarray] = None,
                     lat: Optional[np.ndarray] = None,
                     lon: Optional[np.ndarray] = None,
                     elevation: Optional[np.ndarray] = None,
                     alert_type_idx: Optional[np.ndarray] = None,
                     alert_level: Optional[np.ndarray] = None
                     ) -> EventBatch:
        """Bulk path for synthetic/replayed columns: pads to exactly one
        batch (more rows than the batch size raise)."""
        n = len(device_idx)
        if n > self.batch_size:
            raise ValueError(f"{n} events > batch size {self.batch_size}")
        B = self.batch_size

        def col(arr: Optional[np.ndarray], dtype) -> torch.Tensor:
            out = np.zeros(B, dtype)
            if arr is not None:
                out[:n] = arr
            return torch.from_numpy(out)

        ts_rel = np.clip(np.asarray(ts_ms_abs, np.int64) - self.epoch_base_ms,
                         self._REL_MIN, self._REL_MAX).astype(np.int32)
        valid = np.zeros(B, bool)
        valid[:n] = True
        return EventBatch(
            device_idx=col(device_idx, np.int32),
            tenant_idx=torch.zeros(B, dtype=torch.int32),
            event_type=col(event_type, np.int32),
            ts=col(ts_rel, np.int32),
            mm_idx=col(mm_idx, np.int32), value=col(value, np.float32),
            lat=col(lat, np.float32), lon=col(lon, np.float32),
            elevation=col(elevation, np.float32),
            alert_type_idx=col(alert_type_idx, np.int32),
            alert_level=col(alert_level, np.int32),
            valid=torch.from_numpy(valid))
