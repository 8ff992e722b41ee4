"""On-device alert-lane compaction: prefix-sum pack of fired rows.

Counterpart of `sitewhere_tpu/ops/compact.py`, same bit layout. A prefix
sum over the fired mask packs fired rows into fixed-capacity lanes on the
device, so alert materialization copies one lane-sized int32 array to the
host per step regardless of batch size.

Lane layout ([ALERT_LANE_ROWS, K] int32; slot i = i-th fired row in
batch-row order, so materialization order matches a mask scan exactly):

  row 0 (idx):   batch-row index of the fired row; -1 in unused slots
  row 1 (rules): threshold first_rule in bits 0-15, geofence first_rule
                 in bits 16-31 (int16 two's complement; -1 = none)
  row 2 (meta):  threshold alert_level bits 0-3 | anomaly-model slot
                 low nibble bits 4-7 | geofence alert_level bits 8-11 |
                 anomaly-model slot high nibble bits 12-15 |
                 threshold_fired bit 16 | geofence_fired bit 17 |
                 program_fired bit 18 | program slot id bits 19-26 |
                 program alert_level bits 27-30 | model_fired bit 31
                 (the sign bit: a negative meta word IS a model fire).
                 Levels/ids are only meaningful under their fired bit.
  row 3 (counts): [0] = fired rows this step (INCLUDING rows beyond
                 capacity), [1] = alerts dropped by lane overflow (each
                 fired rule family on a row beyond capacity counts one),
                 [2] = total alerts fired, [3] = rows a sharded route
                 dropped (always 0 on the single-device path)

Overflow contract: rows beyond capacity K are counted on the device
(counts[1]) and surface on the engine's `alerts_dropped`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

ALERT_LANE_ROWS = 4
DEFAULT_ALERT_LANE_CAPACITY = 128
MIN_ALERT_LANE_CAPACITY = 4

_THR_FIRED_BIT = 16
_GEO_FIRED_BIT = 17
_PROG_FIRED_BIT = 18
_PROG_RULE_SHIFT = 19
_PROG_LEVEL_SHIFT = 27
_MODEL_SLOT_LO_SHIFT = 4
_MODEL_SLOT_HI_SHIFT = 12


def compact_alert_lanes(thr: Dict, geo: Dict, capacity: int, prog: Dict,
                        model: Dict) -> torch.Tensor:
    """Pack the step's fired rows into alert lanes.

    `thr`/`geo` are eval_threshold_rules / eval_geofence_rules outputs
    (fired/first_rule/alert_level, all [B]); `prog` (fired/first_rule/
    alert_level) and `model` (fired/first_model) are the stateful stages'
    row outputs (all-off placeholders in this slice). Returns the
    [ALERT_LANE_ROWS, capacity] int32 lane array described above."""
    if capacity < MIN_ALERT_LANE_CAPACITY:
        raise ValueError(
            f"alert lane capacity {capacity} < {MIN_ALERT_LANE_CAPACITY}")
    B = thr["fired"].shape[0]
    dev = thr["fired"].device
    i32 = torch.int32
    fired = thr["fired"] | geo["fired"] | prog["fired"] | model["fired"]
    fired_i = fired.to(i32)
    rank = torch.cumsum(fired_i, 0, dtype=i32) - 1            # 0-based
    keep = fired & (rank < capacity)
    # out-of-capacity rows write to the pad slot `capacity`, sliced off;
    # kept ranks are unique by construction
    slot = torch.where(keep, rank, capacity).long()

    def lane(fill: int, values: torch.Tensor) -> torch.Tensor:
        return torch.full((capacity + 1,), fill, dtype=i32, device=dev) \
            .index_put_((slot,), values)[:capacity]

    idx_lane = lane(-1, torch.arange(B, dtype=i32, device=dev))
    rules = ((thr["first_rule"] & 0xFFFF)
             | ((geo["first_rule"] & 0xFFFF) << 16))
    rules_lane = lane(0, rules)
    prog_fired_i = prog["fired"].to(i32)
    model_slot = torch.where(model["fired"], model["first_model"] & 0xFF, 0)
    meta = ((thr["alert_level"] & 0xF)
            | ((model_slot & 0xF) << _MODEL_SLOT_LO_SHIFT)
            | ((geo["alert_level"] & 0xF) << 8)
            | (((model_slot >> 4) & 0xF) << _MODEL_SLOT_HI_SHIFT)
            | (thr["fired"].to(i32) << _THR_FIRED_BIT)
            | (geo["fired"].to(i32) << _GEO_FIRED_BIT)
            | (prog_fired_i << _PROG_FIRED_BIT)
            | (torch.where(prog["fired"], prog["first_rule"] & 0xFF, 0)
               << _PROG_RULE_SHIFT)
            | (torch.where(prog["fired"], prog["alert_level"] & 0xF, 0)
               << _PROG_LEVEL_SHIFT))
    meta = torch.where(model["fired"], meta | -(2 ** 31), meta)
    meta_lane = lane(0, meta)
    alerts_of = (thr["fired"].to(i32) + geo["fired"].to(i32)
                 + prog_fired_i + model["fired"].to(i32))     # 0..4 per row
    total_alerts = alerts_of.sum(dtype=i32)
    kept_alerts = torch.where(keep, alerts_of, 0).sum(dtype=i32)
    counts_lane = torch.cat([
        torch.stack([fired_i.sum(dtype=i32), total_alerts - kept_alerts,
                     total_alerts]),
        torch.zeros(capacity - 3, dtype=i32, device=dev)])
    return torch.stack([idx_lane, rules_lane, meta_lane, counts_lane])


@dataclass
class DecodedAlertLanes:
    """Host-side view of one lane array's used slots (all arrays [n])."""

    rows: np.ndarray        # int32 batch-row indices, ascending
    thr_fired: np.ndarray   # bool
    geo_fired: np.ndarray   # bool
    thr_rule: np.ndarray    # int32 (sign-extended; -1 = none)
    geo_rule: np.ndarray    # int32
    thr_level: np.ndarray   # int32 (meaningful only where thr_fired)
    geo_level: np.ndarray   # int32
    fired_rows: int         # total fired rows incl. overflow
    dropped_alerts: int     # alerts lost to lane overflow
    total_alerts: int
    prog_fired: np.ndarray   # bool (rule-program fires)
    prog_rule: np.ndarray    # int32 program slot (-1 = none)
    prog_level: np.ndarray   # int32 (meaningful under prog_fired)
    route_dropped: int       # rows dropped by a sharded route
    model_fired: np.ndarray  # bool (anomaly-model fires)
    model_slot: np.ndarray   # int32 model slot (-1 = none)

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def head(self, n: int) -> "DecodedAlertLanes":
        """First `n` slots (max_alerts bounding; counts untouched)."""
        cut = {name: getattr(self, name)[:n] for name in (
            "rows", "thr_fired", "geo_fired", "thr_rule", "geo_rule",
            "thr_level", "geo_level", "prog_fired", "prog_rule",
            "prog_level", "model_fired", "model_slot")}
        return DecodedAlertLanes(
            fired_rows=self.fired_rows, dropped_alerts=self.dropped_alerts,
            total_alerts=self.total_alerts,
            route_dropped=self.route_dropped, **cut)


def decode_alert_lanes(lanes: np.ndarray) -> DecodedAlertLanes:
    """Inverse of compact_alert_lanes on the fetched host copy (numpy)."""
    lanes = np.asarray(lanes)
    capacity = lanes.shape[-1]
    counts = lanes[3]
    fired_rows = int(counts[0])
    n = min(fired_rows, capacity)
    rules = lanes[1, :n]
    meta = lanes[2, :n]
    prog_fired = ((meta >> _PROG_FIRED_BIT) & 1).astype(bool)
    model_fired = meta < 0                     # sign bit IS the fire bit
    return DecodedAlertLanes(
        rows=lanes[0, :n],
        thr_fired=((meta >> _THR_FIRED_BIT) & 1).astype(bool),
        geo_fired=((meta >> _GEO_FIRED_BIT) & 1).astype(bool),
        # int32 arithmetic shifts sign-extend the int16 halves exactly
        thr_rule=(rules << 16) >> 16,
        geo_rule=rules >> 16,
        thr_level=meta & 0xF,
        geo_level=(meta >> 8) & 0xF,
        fired_rows=fired_rows,
        dropped_alerts=int(counts[1]),
        total_alerts=int(counts[2]),
        prog_fired=prog_fired,
        prog_rule=np.where(prog_fired,
                           (meta >> _PROG_RULE_SHIFT) & 0xFF,
                           -1).astype(np.int32),
        prog_level=((meta >> _PROG_LEVEL_SHIFT) & 0xF).astype(np.int32),
        route_dropped=int(counts[3]),
        model_fired=model_fired,
        model_slot=np.where(
            model_fired,
            ((meta >> _MODEL_SLOT_LO_SHIFT) & 0xF)
            | (((meta >> _MODEL_SLOT_HI_SHIFT) & 0xF) << 4),
            -1).astype(np.int32))
