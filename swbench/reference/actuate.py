# Frozen copy of sitewhere_tpu_torch/ops/actuate.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
"""In-step actuation: policy evaluation + debounce + command-lane pack.

Counterpart of `sitewhere_tpu/ops/actuate.py`, same semantics and lane
layout. Right after anomaly scoring, every (batch row, policy) pair is
tested against the step's fired alert bits (threshold/geofence/program/
model), matched triggers are debounced against per-(device, policy) state
kept on the device (the ops/slab.py layout with one slot per policy), and
the surviving (device, command) pairs pack into a second fixed-capacity
[4, K] int32 lane that comes back to the host with the alert lanes.

Step semantics:
  * a policy MATCHES a batch row when any allowed source kind fired on
    that row with (match_slot < 0 or the kind's slot id == match_slot) and
    the kind's alert level >= min_level, the policy is active, and the
    row's tenant matches (tenant_idx 0 = any);
  * per device a policy TRIGGERS at most once per step, on the device's
    LAST matching row (highest batch index);
  * a trigger FIRES only when the debounce window allows: never fired
    before (or the slot's epoch moved), or trigger_ts - last_fire_ts >=
    debounce_ms, in event time; a blocked trigger counts as DEBOUNCED and
    leaves the stored last-fire ts unchanged;
  * fires pack into the command lane in (device, policy) ascending order;
    fires beyond the K capacity are counted (counts[1]) and dropped.

Lane layout ([COMMAND_LANE_ROWS, K] int32; slot i = i-th fired
(device, policy) pair in device-major order):

  row 0 (idx):    batch-row index of the triggering row; -1 unused
  row 1 (meta):   policy slot bits 0-7 | trigger alert level bits 8-11 |
                  trigger source kind bits 12-14 (PolicySource ids)
  row 2 (dev):    device index of the fired device; -1 unused
  row 3 (counts): [0] = commands fired this step (INCLUDING pairs beyond
                  capacity), [1] = commands dropped by lane overflow,
                  [2] = triggers debounced this step, [3] reserved (0)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from swbench.reference.actuation_compiler import (
    ActuationPolicyTable, PolicySource)
from swbench.reference.base import DeviceLike, resolve_device
from swbench.reference.slab import state_slab_lanes

_NEG = -(2 ** 31)

COMMAND_LANE_ROWS = 4
DEFAULT_COMMAND_LANE_CAPACITY = 64
# counts ride slots 0..2 of the counts row
MIN_COMMAND_LANE_CAPACITY = 4

_LEVEL_SHIFT = 8
_SOURCE_SHIFT = 12


@dataclasses.dataclass
class ActuationStateTensors:
    """Per-(device, policy) debounce state on the step's device: the shared
    slab layout with ONE state slot [D, P, 6]: lane 2 = last command-fire
    ts (event time, NEG = never), lane 3 = per-(device, policy) cumulative
    fire counter, lane 5 = the row generation against the policy's table
    epoch; lanes 0/1/4 are unused and held at zero."""

    slab: torch.Tensor            # i32 [D, P, 6] fused debounce state
    gen: torch.Tensor             # i32 [P] counter-row generation
    fire_count: torch.Tensor      # i32 [P] cumulative commands fired
    debounce_count: torch.Tensor  # i32 [P] cumulative triggers debounced

    @property
    def num_policies(self) -> int:
        return self.gen.shape[-1]


def init_actuation_state(max_devices: int, max_policies: int,
                         device: DeviceLike = "cuda"
                         ) -> ActuationStateTensors:
    """Fresh state on `device`: never fired, generation 0."""
    dev = resolve_device(device)
    D, P = max_devices, max_policies
    slab = torch.zeros((D, P, state_slab_lanes(1)), dtype=torch.int32,
                       device=dev)
    slab[:, :, 2] = _NEG
    zp = torch.zeros(P, dtype=torch.int32, device=dev)
    return ActuationStateTensors(slab=slab, gen=zp, fire_count=zp.clone(),
                                 debounce_count=zp.clone())


def eval_actuation_policies(
        table: ActuationPolicyTable,
        state: ActuationStateTensors,
        *,
        dev: torch.Tensor,           # i32 [B] row device index
        ts: torch.Tensor,            # i32 [B] row relative timestamps
        tenant_row: torch.Tensor,    # i32 [B] registry mirror per row
        thr: Dict[str, torch.Tensor],    # eval_threshold_rules output
        geo: Dict[str, torch.Tensor],    # eval_geofence_rules output
        prog: Dict[str, torch.Tensor],   # rule-program row dict
        model: Dict[str, torch.Tensor],  # anomaly-model row dict
        capacity: int,
) -> Tuple[ActuationStateTensors, torch.Tensor]:
    """One step's actuation advance. The slab is updated IN PLACE (the
    reference donates it). Returns (new_state, command_lanes
    [COMMAND_LANE_ROWS, capacity]). Rows whose device index is >= D never
    trigger, as the reference's scatter drops them."""
    if capacity < MIN_COMMAND_LANE_CAPACITY:
        raise ValueError(
            f"command lane capacity {capacity} < "
            f"{MIN_COMMAND_LANE_CAPACITY}")
    B = dev.shape[0]
    slab = state.slab
    D = slab.shape[0]
    P = table.num_policies
    device = dev.device
    i32 = torch.int32

    # ---- per-(row, policy) matching over the step's fire bits -------------
    families = (
        (PolicySource.THRESHOLD, thr["fired"], thr["first_rule"],
         thr["alert_level"]),
        (PolicySource.GEOFENCE, geo["fired"], geo["first_rule"],
         geo["alert_level"]),
        (PolicySource.PROGRAM, prog["fired"], prog["first_rule"],
         prog["alert_level"]),
        (PolicySource.MODEL, model["fired"], model["first_model"],
         model["alert_level"]),
    )
    tenant_ok = ((table.tenant_idx[None, :] == 0)
                 | (table.tenant_idx[None, :] == tenant_row[:, None]))
    eligible = table.active[None, :] & tenant_ok           # [B, P]

    matched = torch.zeros((B, P), dtype=torch.bool, device=device)
    # lowest matching source kind and max matching level per (row, policy)
    trig_src = torch.full((B, P), 8, dtype=i32, device=device)
    trig_level = torch.full((B, P), -1, dtype=i32, device=device)
    for kind, fired_k, slot_k, level_k in families:
        src_ok = ((table.source[None, :] == PolicySource.ANY)
                  | (table.source[None, :] == kind))
        slot_ok = ((table.match_slot[None, :] < 0)
                   | (table.match_slot[None, :] == slot_k[:, None]))
        level_ok = level_k[:, None] >= table.min_level[None, :]
        m = eligible & fired_k[:, None] & src_ok & slot_ok & level_ok
        matched = matched | m
        trig_src = torch.where(m, torch.clamp(trig_src, max=kind), trig_src)
        trig_level = torch.where(m, torch.maximum(trig_level,
                                                  level_k[:, None]),
                                 trig_level)

    # ---- per-(device, policy) trigger: LAST matching row wins -------------
    # unmatched pairs add -1 to their own (in-range) cell, a no-op under
    # max, so only rows of out-of-range devices share the dropped pad
    row_ids = torch.arange(B, dtype=i32, device=device)
    slot_ids = torch.arange(P, dtype=i32, device=device)
    keyr = dev.long()[:, None] * P + slot_ids.long()[None, :]   # [B, P]
    tgt = torch.where(keyr < D * P, keyr, D * P)
    vals = torch.where(matched, row_ids[:, None], -1)
    last_row = torch.full((D * P + 1,), -1, dtype=i32, device=device) \
        .scatter_reduce_(0, tgt.reshape(-1), vals.reshape(-1), "amax",
                         include_self=True)[:D * P].reshape(D, P)
    trig = last_row >= 0                                    # [D, P]
    safe_row = last_row.clamp(0, B - 1).long()
    fire_ts = ts[safe_row]                                  # [D, P]

    # ---- debounce against the stored last-fire ts (generation reset) ------
    stale = slab[:, :, 5] != table.epoch[None, :]          # [D, P]
    last_ts = torch.where(stale, _NEG, slab[:, :, 2])
    ctr = torch.where(stale, 0, slab[:, :, 3])
    allow = ((last_ts == _NEG)
             | ((fire_ts - last_ts) >= table.debounce_ms[None, :]))
    fired_dp = trig & allow
    debounced_dp = trig & ~allow

    # ---- state write-back: only TRIGGERED records persist (and destale,
    # zeroing the unused lanes of a freshly reset row) ----------------------
    fresh = (trig & stale)[:, :, None]
    for lane in (0, 1, 4):
        slab[:, :, lane:lane + 1].masked_fill_(fresh, 0)
    slab[:, :, 2] = torch.where(
        trig, torch.where(fired_dp, fire_ts, last_ts), slab[:, :, 2])
    slab[:, :, 3] = torch.where(trig, ctr + fired_dp.to(i32), slab[:, :, 3])
    slab[:, :, 5] = torch.where(trig, table.epoch[None, :].to(i32),
                                slab[:, :, 5])

    epoch_moved = state.gen != table.epoch
    new_state = ActuationStateTensors(
        slab=slab,
        gen=table.epoch.to(i32).clone(),
        fire_count=torch.where(epoch_moved, 0, state.fire_count)
        + fired_dp.sum(dim=0, dtype=i32),
        debounce_count=torch.where(epoch_moved, 0, state.debounce_count)
        + debounced_dp.sum(dim=0, dtype=i32),
    )

    # ---- compaction into the command lane (device-major) ------------------
    # slot k holds the (k+1)-th fire: the first flat position whose running
    # count of fires reaches k + 1 (one binary search per lane slot)
    fired_flat = fired_dp.reshape(-1)
    csum = torch.cumsum(fired_flat.to(torch.int64), 0)
    total = csum[-1]
    want = torch.arange(1, capacity + 1, dtype=torch.int64, device=device)
    pos = torch.searchsorted(csum, want).clamp(max=D * P - 1)
    used = want <= total
    row_at = last_row.reshape(-1)[pos]
    pol_at = (pos % P).to(i32)
    lvl_at = trig_level[row_at.clamp(0, B - 1).long(), pol_at.long()]
    src_at = trig_src[row_at.clamp(0, B - 1).long(), pol_at.long()]
    meta = ((pol_at & 0xFF) | ((lvl_at & 0xF) << _LEVEL_SHIFT)
            | ((src_at & 0x7) << _SOURCE_SHIFT))
    kept = torch.clamp(total, max=capacity).to(i32)
    counts = torch.zeros(capacity, dtype=i32, device=device)
    counts[0] = total.to(i32)
    counts[1] = total.to(i32) - kept
    counts[2] = debounced_dp.sum(dtype=i32)
    lanes = torch.stack([
        torch.where(used, row_at, -1),
        torch.where(used, meta, 0),
        torch.where(used, (pos // P).to(i32), -1),
        counts])
    return new_state, lanes


@dataclass
class DecodedCommandLanes:
    """Host-side view of one command-lane array's used slots ([n])."""

    rows: np.ndarray         # int32 triggering batch-row indices
    policy_slot: np.ndarray  # int32 policy slot ids
    level: np.ndarray        # int32 trigger alert level
    source: np.ndarray       # int32 trigger source kind (PolicySource)
    dev: np.ndarray          # int32 device indices
    fired: int               # commands fired incl. overflow
    dropped: int             # commands lost to lane overflow
    debounced: int           # triggers blocked by the debounce window

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def head(self, n: int) -> "DecodedCommandLanes":
        """First `n` slots (bounding; counts untouched)."""
        return DecodedCommandLanes(
            rows=self.rows[:n], policy_slot=self.policy_slot[:n],
            level=self.level[:n], source=self.source[:n],
            dev=self.dev[:n], fired=self.fired, dropped=self.dropped,
            debounced=self.debounced)


def decode_command_lanes(lanes: np.ndarray) -> DecodedCommandLanes:
    """Inverse of the lane pack on the fetched host copy (numpy)."""
    lanes = np.asarray(lanes)
    capacity = lanes.shape[-1]
    counts = lanes[3]
    fired = int(counts[0])
    n = min(fired, capacity)
    meta = lanes[1, :n]
    return DecodedCommandLanes(
        rows=lanes[0, :n],
        policy_slot=(meta & 0xFF).astype(np.int32),
        level=((meta >> _LEVEL_SHIFT) & 0xF).astype(np.int32),
        source=((meta >> _SOURCE_SHIFT) & 0x7).astype(np.int32),
        dev=lanes[2, :n],
        fired=fired,
        dropped=int(counts[1]),
        debounced=int(counts[2]))
