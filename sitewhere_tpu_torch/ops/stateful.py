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

Two implementations of the same function:
  - `eval_rule_programs_plain`: plain torch, every opcode evaluated for
    every node over [B, P] and selected. The CPU path, and the semantics
    the kernel is held to;
  - `eval_rule_programs`: on CPU tensors the plain version; on CUDA
    tensors the hand kernel `csrc/rule_programs.cu` in one launch (a warp
    per 32 rows, a lane per program, only attach rows read and write the
    slab), or it raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.ops import cuda_build
from sitewhere_tpu_torch.ops.numerics import (
    div_f32, fma_f32, mul_f32, sub_f32)
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


def eval_rule_programs_plain(
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
        decay = mul_f32(sub_f32(torch.ones_like(alpha), alpha), sv)
        ewma = torch.where(sc > 0, fma_f32(alpha, v, decay), v)
        new_sv_ewma = torch.where(observed, ewma, sv)
        obs_inc = observed.to(i32)
        out_ewma = ((sc + obs_inc) > 0) & _compare(new_sv_ewma, cmp_op,
                                                   fconst)

        dt = torch.clamp(cur_ts - st, min=1).float()
        rate = div_f32(mul_f32(sub_f32(v, sv), 1000.0), dt)
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


# -- the hand kernel (csrc/rule_programs.cu) -------------------------------------

KERNEL_SOURCE = "rule_programs"

# the table's fields and the rows' keywords, in `_RuleArgs` order, with the
# dtype each must have
_TABLE_FIELDS = (
    ("active", torch.bool), ("tenant_idx", torch.int32),
    ("device_type_idx", torch.int32), ("alert_level", torch.int32),
    ("root", torch.int32), ("epoch", torch.int32), ("opcode", torch.int32),
    ("mm_idx", torch.int32), ("lhs", torch.int32), ("rhs", torch.int32),
    ("cmp_op", torch.int32), ("fconst", torch.float32),
    ("falpha", torch.float32), ("iparam", torch.int32),
    ("state_slot", torch.int32))
_ROW_FIELDS = (
    ("dev", torch.int32), ("attach", torch.bool), ("obs_row", torch.bool),
    ("now_row", torch.int32), ("lm_row", torch.float32),
    ("lmts_row", torch.int32), ("tenant_row", torch.int32),
    ("dtype_row", torch.int32))
_OUT_FIELDS = ("fired", "first_rule", "level", "fire_count",
               "suppress_count", "scratch")


class _RuleArgs(ctypes.Structure):
    """`RuleArgs` of csrc/rule_programs.cu, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name, _ in _TABLE_FIELDS]
                + [("slab", ctypes.c_void_p)]
                + [(name, ctypes.c_void_p) for name, _ in _ROW_FIELDS]
                + [(name, ctypes.c_void_p) for name in _OUT_FIELDS]
                + [("B", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in
                   ("D", "P", "node_stride", "N", "M", "S")]
                + [("scratch_words", ctypes.c_longlong),
                   ("table_words", ctypes.c_longlong)])   # set in C


def _rule_library() -> ctypes.CDLL:
    return bind_rule_library(cuda_build.load(KERNEL_SOURCE))


def bind_rule_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/rule_programs.cu) with its C entries typed."""
    if lib.swt_rule_programs.argtypes is None:
        lib.swt_rule_programs.argtypes = [ctypes.POINTER(_RuleArgs),
                                          ctypes.c_int, ctypes.c_void_p]
        lib.swt_rule_programs.restype = ctypes.c_int
        lib.swt_rule_programs_plan.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.swt_rule_programs_plan.restype = ctypes.c_int
        lib.swt_rule_programs_error_string.argtypes = [ctypes.c_int]
        lib.swt_rule_programs_error_string.restype = ctypes.c_char_p
    return lib


def _check_rule_inputs(table: RuleProgramTable, state: RuleStateTensors,
                       rows: Dict[str, torch.Tensor]) -> None:
    """Raise unless every tensor lies on `dev`'s device with the dtype and
    shape the stage takes."""
    where = rows["dev"].device
    B = rows["dev"].shape[0]
    P, N = table.num_programs, table.num_nodes
    M = rows["lm_row"].shape[-1]
    named = ([(f"table.{n}", getattr(table, n), dt, (P, N) if n in (
        "opcode", "mm_idx", "lhs", "rhs", "cmp_op", "fconst", "falpha",
        "iparam", "state_slot") else (P,)) for n, dt in _TABLE_FIELDS]
        + [("state.slab", state.slab, torch.int32, None)]
        + [(f"state.{n}", getattr(state, n), torch.int32, (P,))
           for n in ("gen", "fire_count", "suppress_count")]
        + [(n, rows[n], dt, (B, M) if n in ("obs_row", "lm_row", "lmts_row")
            else (B,)) for n, dt in _ROW_FIELDS])
    for name, t, dtype, shape in named:
        if t.device != where:
            raise ValueError(f"eval_rule_programs: {name} is on {t.device}, "
                             f"dev on {where}")
        if t.dtype != dtype:
            raise TypeError(f"eval_rule_programs: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"eval_rule_programs: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
    slab = state.slab
    if slab.dim() != 3 or slab.shape[1] != P or (slab.shape[2] - 2) % 4 \
            or slab.shape[2] < 6:
        raise ValueError(f"eval_rule_programs: state.slab must be "
                         f"[D, {P}, 4S+2], got {tuple(slab.shape)}")


def rule_programs_plan(B: int, P: int, N: int, S: int,
                       device: int = 0) -> Dict[str, int]:
    """How the kernel launches for B rows, P programs, N node slots (after
    node_limit) and S state slots on CUDA card `device`: grid, threads per
    block, dynamic shared bytes, blocks per SM, scratch (i32 words), and
    where the records, the node bits and the node columns live. For
    reports and the wrapper's scratch; launches nothing."""
    lib = _rule_library()
    plan = (ctypes.c_longlong * 8)()
    rc = lib.swt_rule_programs_plan(B, P, N, S, device, plan)
    if rc != 0:
        raise RuntimeError(
            f"rule-program kernel plan failed: "
            f"{lib.swt_rule_programs_error_string(rc).decode()}")
    out = dict(zip(("grid", "threads", "shared_bytes", "blocks_per_sm",
                    "scratch_words"), plan[:5]))
    out["records"] = "shared" if plan[5] else "global"
    out["node_bits"] = "global" if plan[6] else "registers"
    out["node_columns"] = "shared" if plan[7] else "global"
    return out


def _eval_rule_programs_kernel(table, state, rows, node_limit):
    B = rows["dev"].shape[0]
    D, P, N = state.slab.shape[0], table.num_programs, table.num_nodes
    N = min(N, node_limit) if node_limit else N
    S, M = state.num_state_slots, rows["lm_row"].shape[1]
    where = rows["dev"].device
    i32 = torch.int32
    if not state.slab.is_contiguous():
        raise ValueError("eval_rule_programs: state.slab must be contiguous "
                         "(the kernel updates it in place)")
    # per-program counters reset where their slot's epoch moved; the kernel
    # adds this step's fires and suppressions
    moved = state.gen != table.epoch
    fire_count = torch.where(moved, 0, state.fire_count)
    suppress_count = torch.where(moved, 0, state.suppress_count)
    fired = torch.empty(B, dtype=torch.bool, device=where)
    first = torch.empty(B, dtype=i32, device=where)
    level = torch.empty(B, dtype=i32, device=where)
    new_state = RuleStateTensors(slab=state.slab, gen=table.epoch.clone(),
                                 fire_count=fire_count,
                                 suppress_count=suppress_count)
    outs = {"fired": fired, "first_rule": first, "alert_level": level}
    if B == 0:
        return new_state, outs
    lib = _rule_library()
    plan = rule_programs_plan(B, P, N, S, where.index)
    scratch = (torch.empty(plan["scratch_words"], dtype=i32, device=where)
               if plan["scratch_words"] else None)
    keep = {n: getattr(table, n).contiguous() for n, _ in _TABLE_FIELDS}
    keep.update({n: rows[n].contiguous() for n, _ in _ROW_FIELDS})
    args = _RuleArgs(
        **{n: t.data_ptr() for n, t in keep.items()},
        slab=state.slab.data_ptr(), fired=fired.data_ptr(),
        first_rule=first.data_ptr(), level=level.data_ptr(),
        fire_count=fire_count.data_ptr(),
        suppress_count=suppress_count.data_ptr(),
        scratch=scratch.data_ptr() if scratch is not None else None,
        B=B, D=D, P=P, node_stride=table.num_nodes, N=N, M=M, S=S,
        scratch_words=plan["scratch_words"])
    # the library sets the card it launches on; the guard puts the
    # caller's current card back
    with torch.cuda.device(where):
        rc = lib.swt_rule_programs(
            ctypes.byref(args), where.index,
            torch.cuda.current_stream(where).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"rule-program kernel launch failed: "
            f"{lib.swt_rule_programs_error_string(rc).decode()} "
            f"(cudaError {rc})")
    if torch.cuda.is_current_stream_capturing():
        eval_rule_programs.captures += 1
    else:
        eval_rule_programs.launches += 1
        by_card = eval_rule_programs.by_card
        by_card[where.index] = by_card.get(where.index, 0) + 1
    return new_state, outs


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
    """One step's advance: what `eval_rule_programs_plain` computes, bit for
    bit. On CPU tensors it IS the plain version; on CUDA tensors it launches
    the kernel of csrc/rule_programs.cu once (built at first use, see
    ops/cuda_build.py) on the current stream, without synchronising, beside
    a few [P] torch ops for the counters, or raises. Every tensor must lie
    on `dev`'s device with the stage's dtypes and shapes (else ValueError
    or TypeError). The kernel takes rows with at most one attach row per
    clamped device index, as `observations_of_batch` gives them.
    `eval_rule_programs.launches` counts kernel launches (`.by_card` the
    same per card index); a launch recorded into a CUDA graph under
    capture counts on `.captures` instead (each replay launches it again,
    see pipeline/graph.py)."""
    rows = dict(dev=dev, attach=attach, obs_row=obs_row, now_row=now_row,
                lm_row=lm_row, lmts_row=lmts_row, tenant_row=tenant_row,
                dtype_row=dtype_row)
    _check_rule_inputs(table, state, rows)
    if dev.device.type == "cpu":
        return eval_rule_programs_plain(table, state, node_limit=node_limit,
                                        **rows)
    if dev.device.type != "cuda":
        raise ValueError(f"no rule-program kernel for device {dev.device}")
    return _eval_rule_programs_kernel(table, state, rows, node_limit)


eval_rule_programs.launches = 0
# launches per card index
eval_rule_programs.by_card = {}
eval_rule_programs.captures = 0


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

