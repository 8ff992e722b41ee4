"""Stateful rule-program evaluation inside the step.

Counterpart of `sitewhere_tpu/ops/stateful.py`, bit for bit. Evaluates the
compiled rule-program tables (rules/compiler.py) with per-(device, program,
state-slot) temporal state carried on the device across steps: EWMA
accumulators, last-value/last-ts pairs for rate-of-change, consecutive-hit
counters for debounce, latch bits for hysteresis, and satisfied-since
timestamps for `for_duration`.

Work scales with the batch, not the device capacity: the [B, P] program
matrix is evaluated on the batch's rows only; each row's whole state record
is one gather from the fused i32 slab [D, P, 4*S+2] (ops/slab.py), and the
new record goes back from the device's ATTACH row (its last tracked-
measurement row this step, one per ticked device).

Step semantics (docs/RULE_PROGRAMS.md):
  * a device's observation TICK is a step in which it had >= 1 valid
    measurement event on a tracked slot (0 < mm_idx < M);
  * predicates read the POST-FOLD last-measurement state;
  * temporal operators advance only on ticks; `for_duration` measures
    against the device's newest event timestamp this step;
  * a program FIRES on the rising edge of its root expression at a tick; a
    tick where the root stays true counts one suppression;
  * fires attach to the device's attach row, so they ride the alert lanes.

Generation reset: a gathered row whose generation lane lags its program's
table epoch reads as freshly initialized state (and writes back the
current epoch), so a program installed into a recycled slot starts from
zero without a sweep over the device capacity.

Arithmetic follows the reference's compiled f32 exactly: denormal operands
and results flush (ops/numerics.py), and the EWMA update is the fused
multiply-add XLA contracts it into (`fma_f32`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.ops.numerics import flush_denormals, fma_f32
from sitewhere_tpu_torch.ops.segments import count_by_key, scatter_max_by_key
from sitewhere_tpu_torch.ops.slab import _slab_f32, _slab_i32, state_slab_lanes
from sitewhere_tpu_torch.ops.threshold import _compare
from sitewhere_tpu_torch.rules.compiler import ProgramOp, RuleProgramTable

_NEG = -(2 ** 31)


@dataclasses.dataclass
class RuleStateTensors:
    """Per-(device, program) temporal state on the step's device.

    All per-device state lives in ONE fused i32 slab [D, P, 4*S+2]: value
    bits / aux bits / ts / counter planes of S lanes each, then the
    root_prev bit and the row generation. The (value, aux, ts, counter)
    quad is one state record per stateful node (compiler-assigned
    state_slot):
      EWMA          value = accumulator, counter = observation count
      RATE          value = prev observation, aux = last computed rate,
                    ts = prev observation ts, counter = observation count
      DEBOUNCE      counter = consecutive satisfied ticks
      FOR_DURATION  ts = satisfied-since timestamp (NEG = not satisfied)
      HYSTERESIS    counter = latch bit
    """

    slab: torch.Tensor            # i32 [D, P, 4*S+2] fused per-device state
    gen: torch.Tensor             # i32 [P] counter-row generation
    fire_count: torch.Tensor      # i32 [P] cumulative fires
    suppress_count: torch.Tensor  # i32 [P] cumulative suppressions

    @property
    def num_programs(self) -> int:
        return self.gen.shape[-1]

    @property
    def num_state_slots(self) -> int:
        return (self.slab.shape[-1] - 2) // 4


def init_rule_state(max_devices: int, max_programs: int, state_slots: int,
                    device: DeviceLike = "cuda") -> RuleStateTensors:
    """Fresh state on `device`: zero planes, the ts plane at NEG."""
    dev = resolve_device(device)
    D, P, S = max_devices, max_programs, state_slots
    slab = torch.zeros((D, P, state_slab_lanes(S)), dtype=torch.int32,
                       device=dev)
    slab[:, :, 2 * S:3 * S] = _NEG   # zero bits are 0.0f elsewhere
    zp = torch.zeros(P, dtype=torch.int32, device=dev)
    return RuleStateTensors(slab=slab, gen=zp, fire_count=zp.clone(),
                            suppress_count=zp.clone())


def _gather_slot(arr: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """arr [B, P, S], slots [P] (in range) -> [B, P]: each program's
    assigned lane."""
    idx = slots.long()[None, :, None].expand(arr.shape[0], -1, 1)
    return torch.gather(arr, 2, idx)[..., 0]


def _scatter_slot(arr: torch.Tensor, slots: torch.Tensor,
                  values: torch.Tensor, write: torch.Tensor) -> None:
    """In place: arr[b, p, slots[p]] = values[b, p] where `write` [P];
    programs outside `write` get their current lane back, bit for bit. One
    target per (b, p), so the scatter has unique indices."""
    idx = slots.long()[None, :, None].expand(arr.shape[0], -1, 1)
    cur = torch.gather(arr, 2, idx)[..., 0]
    new = torch.where(write[None, :], values, cur)
    arr.scatter_(2, idx, new[..., None])


def write_attach_rows(slab: torch.Tensor, gdev: torch.Tensor,
                      attach: torch.Tensor, slab_rows: torch.Tensor,
                      new_rows: torch.Tensor) -> None:
    """In place: slab[d] = new_rows[attach row of d] for every device d
    with an attach row in the batch (the reference's unique-writer scatter
    with `mode="drop"`).

    `gdev` [B] are the rows' device indices clamped into the slab (the rows
    the reference's gather read) and `slab_rows` [B, ...] what was gathered
    there. Every row writes its device's record: the attach row's new
    record where the device has one, else the unchanged gathered row. Rows
    that share a device thus write identical bits, so the write needs no
    pad row and its result does not depend on the order in which the card
    applies duplicate writes."""
    D, B = slab.shape[0], gdev.shape[0]
    rows = torch.arange(B, device=gdev.device)
    at = torch.full((D + 1,), -1, dtype=torch.long, device=gdev.device)
    at.scatter_reduce_(0, torch.where(attach, gdev.long(), D), rows, "amax",
                       include_self=True)
    a = at[:D][gdev.long()]
    has = (a >= 0).reshape((B,) + (1,) * (slab_rows.dim() - 1))
    out = torch.where(has, new_rows[a.clamp(min=0)], slab_rows)
    slab.index_put_((gdev.long(),), out)


def eval_rule_programs(
        table: RuleProgramTable,
        state: RuleStateTensors,
        *,
        dev: torch.Tensor,          # i32 [B] row device index
        attach: torch.Tensor,       # bool [B] device's last tracked row
        obs_row: torch.Tensor,      # bool [B, M] device observed slot m
        now_row: torch.Tensor,      # i32 [B] device's newest ts this step
        lm_row: torch.Tensor,       # f32 [B, M] POST-fold last values
        lmts_row: torch.Tensor,     # i32 [B, M] POST-fold last ts
        tenant_row: torch.Tensor,   # i32 [B] registry mirror per row
        dtype_row: torch.Tensor,    # i32 [B] registry mirror per row
        node_limit: int = 0,        # node slots actually in use
) -> Tuple[RuleStateTensors, Dict[str, torch.Tensor]]:
    """One step's advance, evaluated on the batch's rows.

    The slab is updated IN PLACE (the reference donates it) and returned in
    a new RuleStateTensors with the new counters. Only ATTACH rows advance
    state and may fire; the per-row outputs feed the alert-lane compaction:
      fired:       bool [B]
      first_rule:  i32 [B] lowest fired program slot (-1 = none)
      alert_level: i32 [B] max level among fired programs (-1 = none)
    A device index >= D reads row D-1 (XLA's gather clamp) and is never
    written."""
    B = dev.shape[0]
    D = state.slab.shape[0]
    P, N = table.num_programs, table.num_nodes
    M = lm_row.shape[1]
    if node_limit:
        N = min(N, node_limit)
    S = state.num_state_slots
    i32 = torch.int32

    eligible = (
        table.active[None, :]
        & ((table.tenant_idx[None, :] == 0)
           | (table.tenant_idx[None, :] == tenant_row[:, None]))
        & ((table.device_type_idx[None, :] == 0)
           | (table.device_type_idx[None, :] == dtype_row[:, None]))
    )                                                      # [B, P]
    tick = eligible & attach[:, None]                      # [B, P]

    # one gather pulls each row's whole record; rows whose generation lags
    # their program's epoch read as fresh (lazy per-row reset)
    gdev = dev.clamp(0, D - 1).long()
    slab_rows = state.slab[gdev]                           # [B, P, 4S+2]
    stale = slab_rows[:, :, 4 * S + 1] != table.epoch[None, :]
    stale_s = stale[:, :, None]
    value_s = torch.where(stale_s, 0.0, _slab_f32(slab_rows[:, :, 0:S]))
    aux_s = torch.where(stale_s, 0.0, _slab_f32(slab_rows[:, :, S:2 * S]))
    ts_s = torch.where(stale_s, _NEG, slab_rows[:, :, 2 * S:3 * S])
    ctr_s = torch.where(stale_s, 0, slab_rows[:, :, 3 * S:4 * S])
    prev_row = ~stale & (slab_rows[:, :, 4 * S] != 0)     # [B, P]

    outs = torch.zeros((B, P, N), dtype=torch.bool, device=dev.device)
    now_col = now_row[:, None]

    for j in range(N):  # children sit at lower slots
        op = table.opcode[:, j]                            # [P]
        mm = table.mm_idx[:, j].clamp(0, M - 1).long()
        slot = table.state_slot[:, j]
        cmp_op = table.cmp_op[None, :, j]                  # [1, P]
        fconst = table.fconst[None, :, j]

        v = lm_row[:, mm]                                  # [B, P]
        cur_ts = lmts_row[:, mm]
        known = cur_ts > _NEG
        observed = obs_row[:, mm] & eligible

        sv = _gather_slot(value_s, slot)
        sa = _gather_slot(aux_s, slot)
        st = _gather_slot(ts_s, slot)
        sc = _gather_slot(ctr_s, slot)

        is_value = op == ProgramOp.VALUE
        is_ewma = op == ProgramOp.EWMA
        is_rate = op == ProgramOp.RATE
        is_not = op == ProgramOp.NOT
        is_and = op == ProgramOp.AND
        is_or = op == ProgramOp.OR
        is_deb = op == ProgramOp.DEBOUNCE
        is_dur = op == ProgramOp.FOR_DURATION
        is_hys = op == ProgramOp.HYSTERESIS

        lhs = _gather_slot(outs, table.lhs[:, j].clamp(0, N - 1))
        rhs = _gather_slot(outs, table.rhs[:, j].clamp(0, N - 1))

        # ---- predicates ----------------------------------------------------
        out_value = known & _compare(v, cmp_op, fconst)

        alpha = table.falpha[None, :, j]
        decay = flush_denormals(flush_denormals(1.0 - alpha)
                                * flush_denormals(sv))
        ewma = torch.where(sc > 0, fma_f32(alpha, v, decay), v)
        new_sv_ewma = torch.where(observed, ewma, sv)
        obs_inc = observed.to(i32)
        out_ewma = ((sc + obs_inc) > 0) & _compare(new_sv_ewma, cmp_op,
                                                   fconst)

        dt = torch.clamp(cur_ts - st, min=1).float()
        diff = flush_denormals(flush_denormals(v) - flush_denormals(sv))
        rate = flush_denormals(flush_denormals(diff * 1000.0) / dt)
        upd_rate = observed & (sc > 0)
        new_sa_rate = torch.where(upd_rate, rate, sa)
        out_rate = ((sc + obs_inc) > 1) & _compare(new_sa_rate, cmp_op,
                                                   fconst)

        # ---- temporal operators (advance on ticks only) -------------------
        iparam = table.iparam[None, :, j]
        new_sc_deb = torch.where(
            tick, torch.where(lhs, torch.clamp(sc + 1, max=2 ** 30), 0), sc)
        out_deb = new_sc_deb >= iparam

        since = torch.where(st == _NEG, now_col, st)
        new_st_dur = torch.where(tick, torch.where(lhs, since, _NEG), st)
        out_dur = lhs & (new_st_dur != _NEG) \
            & (now_col - new_st_dur >= iparam)

        latch = sc > 0
        new_latch = torch.where(tick, (latch | lhs) & ~rhs, latch)

        # ---- merge by opcode ----------------------------------------------
        out_j = (
            (is_value & out_value) | (is_ewma & out_ewma)
            | (is_rate & out_rate) | (is_not & ~lhs)
            | (is_and & (lhs & rhs)) | (is_or & (lhs | rhs))
            | (is_deb & out_deb) | (is_dur & out_dur)
            | (is_hys & new_latch))
        outs[:, :, j] = out_j

        # ---- state writes (one lane per stateful node) --------------------
        new_value = torch.where(is_ewma, new_sv_ewma,
                                torch.where(is_rate & observed, v, sv))
        new_aux = torch.where(is_rate, new_sa_rate, sa)
        new_ts = torch.where(is_rate & observed, cur_ts,
                             torch.where(is_dur, new_st_dur, st))
        new_ctr = torch.where(
            is_ewma | is_rate, sc + obs_inc,
            torch.where(is_deb, new_sc_deb,
                        torch.where(is_hys, new_latch.to(i32), sc)))
        stateful = is_ewma | is_rate | is_deb | is_dur | is_hys
        _scatter_slot(value_s, slot, new_value, stateful)
        _scatter_slot(aux_s, slot, new_aux, stateful)
        _scatter_slot(ts_s, slot, new_ts, stateful)
        _scatter_slot(ctr_s, slot, new_ctr, stateful)

    root = _gather_slot(outs, table.root.clamp(0, N - 1)) & eligible
    fired = tick & root & ~prev_row                        # [B, P]
    suppressed = tick & root & prev_row
    new_prev_row = torch.where(tick, root, prev_row)

    new_rows = torch.cat([
        _slab_i32(value_s), _slab_i32(aux_s), ts_s, ctr_s,
        new_prev_row.to(i32)[:, :, None],
        table.epoch.to(i32)[None, :, None].expand(B, P, 1),
    ], dim=-1)
    write_attach_rows(state.slab, gdev, attach & (dev < D), slab_rows,
                      new_rows)
    moved = state.gen != table.epoch
    new_state = RuleStateTensors(
        slab=state.slab,
        gen=table.epoch.to(i32).clone(),
        # per-program counters reset when their slot's epoch moved
        fire_count=torch.where(moved, 0, state.fire_count)
        + fired.sum(dim=0, dtype=i32),
        suppress_count=torch.where(moved, 0, state.suppress_count)
        + suppressed.sum(dim=0, dtype=i32),
    )
    return new_state, first_fired(fired, table.alert_level)


def first_fired(fired: torch.Tensor, alert_level: torch.Tensor,
                first_key: str = "first_rule") -> Dict[str, torch.Tensor]:
    """Per-row reduce of a bool [B, P] fire matrix: "fired" (any),
    `first_key` (the lowest fired slot, -1 if none) and "alert_level" (the
    max fired level, -1 if none)."""
    P = fired.shape[1]
    any_fired = fired.any(dim=1)
    slot_ids = torch.arange(P, dtype=torch.int32, device=fired.device)
    first = torch.where(fired, slot_ids[None, :], P).amin(dim=1)
    first = torch.where(any_fired, first, -1).to(torch.int32)
    level = torch.where(fired, alert_level[None, :].to(torch.int32),
                        -1).amax(dim=1).to(torch.int32)
    return {"fired": any_fired, first_key: first, "alert_level": level}


def observations_of_batch(batch, measurement_slots: int, num_devices: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Reduce a validated batch to the per-device observation view the
    stateful stages consume: (obs_mm [D, M], touched [D], now_d [D],
    attach_row [B]).

    `attach_row` marks the rows that are their device's LAST valid
    tracked-measurement row — the row a stateful fire attaches to. A row
    whose device index is >= D reads row D-1's entry, as XLA clamps the
    gather, and so is never an attach row."""
    D, M = num_devices, measurement_slots
    dev = batch.device_idx
    is_obs = (batch.valid
              & (batch.event_type == DeviceEventType.MEASUREMENT)
              & (batch.mm_idx > 0) & (batch.mm_idx < M))
    obs_mm = (count_by_key(dev * M + batch.mm_idx, is_obs, D * M) > 0) \
        .reshape(D, M)
    touched = obs_mm.any(dim=1)
    neg = torch.full((D,), _NEG, dtype=torch.int32, device=dev.device)
    now_d = scatter_max_by_key(dev, batch.ts, is_obs, D, neg)
    B = dev.shape[0]
    row_ids = torch.arange(B, dtype=torch.int32, device=dev.device)
    last_row = scatter_max_by_key(
        dev, row_ids, is_obs, D,
        torch.full((D,), -1, dtype=torch.int32, device=dev.device))
    attach_row = is_obs & (last_row[dev.clamp(0, D - 1).long()] == row_ids)
    return obs_mm, touched, now_d, attach_row

