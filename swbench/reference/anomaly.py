# Frozen copy of sitewhere_tpu_torch/ops/anomaly.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
"""Anomaly-model scoring inside the step.

Counterpart of `sitewhere_tpu/ops/anomaly.py`. Evaluates the compiled
anomaly-model weight tables (ml/compiler.py) with per-(device, model,
feature) state carried on the device across steps: EWMA accumulators and
last-value/last-ts pairs for rate features, with the rule programs'
feature equations (ops/stateful.py).

Work scales with the batch: each row's whole feature-state record is one
gather from the fused i32 slab [D, P, 4*F+2] (ops/slab.py layout), and the
new record goes back from each device's ATTACH row. The forward pass is an
unroll over the layer bucket, one [P, H, H] product per layer over every
(row, model) pair, written as a broadcast multiply and a sum over H (full
f32 whatever the process's matmul precision settings).

Step semantics:
  * a device's observation TICK is a step with >= 1 valid tracked
    measurement event (as for the rule programs);
  * features read the POST-FOLD last-measurement state; EWMA and rate
    features advance only when their measurement was observed this step;
  * a model SCORES at a tick only when every used feature is ready (value:
    ever observed; ewma: >= 1 observation; rate: >= 2) and finite;
  * mlp score = sigmoid(out_w . h + out_b) over tanh hidden layers;
    autoencoder score = mean squared reconstruction error of the
    normalized features (final layer linear);
  * a model FIRES on the rising edge of (score > threshold) at a scored
    tick; fires attach to the device's attach row.

Everything written to the slab (features, EWMA, rate, counters,
generation) is the reference's bits exactly; the scores themselves carry
`tanh`/`exp` last-bit differences between libraries. On the CPU, tanh and
exp come from ops/numerics.py (`tanh_f32`, `exp_f32`), so a score's bits
do not depend on the process or its thread count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from swbench.reference.base import DeviceLike, resolve_device
from swbench.reference.ml_compiler import (
    AnomalyModelTable, FeatureKind, ModelKind)
from swbench.reference.numerics import (
    div_f32, exp_f32, flush_denormals, fma_f32, mul_f32, sub_f32, tanh_f32)
from swbench.reference.slab import _slab_f32, _slab_i32, state_slab_lanes
from swbench.reference.stateful import first_fired, write_attach_rows

_NEG = -(2 ** 31)


@dataclasses.dataclass
class ModelStateTensors:
    """Per-(device, model, feature) scoring state on the step's device: ONE
    fused i32 slab [D, P, 4*F+2] with the rule-state lane layout (value/aux
    bits, ts, counter planes, then the score_prev bit and the row
    generation). The (value, aux, ts, counter) quad per feature slot:
      VALUE  unused (the post-fold last measurement IS the state)
      EWMA   value = accumulator, counter = observation count
      RATE   value = prev observation, aux = last computed rate,
             ts = prev observation ts, counter = observation count
    """

    slab: torch.Tensor        # i32 [D, P, 4*F+2] fused per-device state
    gen: torch.Tensor         # i32 [P] counter-row generation
    fire_count: torch.Tensor  # i32 [P] cumulative fires
    eval_count: torch.Tensor  # i32 [P] cumulative scored ticks

    @property
    def num_models(self) -> int:
        return self.gen.shape[-1]

    @property
    def num_features(self) -> int:
        return (self.slab.shape[-1] - 2) // 4


def init_model_state(max_devices: int, max_models: int, max_features: int,
                     device: DeviceLike = "cuda") -> ModelStateTensors:
    """Fresh state on `device`: zero planes, the ts plane at NEG."""
    dev = resolve_device(device)
    D, P, F = max_devices, max_models, max_features
    slab = torch.zeros((D, P, state_slab_lanes(F)), dtype=torch.int32,
                       device=dev)
    slab[:, :, 2 * F:3 * F] = _NEG
    zp = torch.zeros(P, dtype=torch.int32, device=dev)
    return ModelStateTensors(slab=slab, gen=zp, fire_count=zp.clone(),
                             eval_count=zp.clone())


def eval_anomaly_models(
        table: AnomalyModelTable,
        state: ModelStateTensors,
        *,
        dev: torch.Tensor,          # i32 [B] row device index
        attach: torch.Tensor,       # bool [B] device's last tracked row
        obs_row: torch.Tensor,      # bool [B, M] device observed slot m
        lm_row: torch.Tensor,       # f32 [B, M] POST-fold last values
        lmts_row: torch.Tensor,     # i32 [B, M] POST-fold last ts
        tenant_row: torch.Tensor,   # i32 [B] registry mirror per row
        dtype_row: torch.Tensor,    # i32 [B] registry mirror per row
) -> Tuple[ModelStateTensors, Dict[str, torch.Tensor]]:
    """One step's advance, evaluated on the batch's rows.

    The slab is updated IN PLACE (the reference donates it). Only ATTACH
    rows advance state and may fire; per-row outputs:
      fired:       bool [B]
      first_model: i32 [B] lowest fired model slot (-1 = none)
      alert_level: i32 [B] max level among fired models (-1 = none)
      score:       f32 [B] lowest scored slot's score (0 = none scored)
    A device index >= D reads row D-1 (XLA's gather clamp) and is never
    written."""
    B = dev.shape[0]
    D = state.slab.shape[0]
    P, F, H = table.num_models, table.num_features, table.width
    M = lm_row.shape[1]
    i32 = torch.int32

    eligible = (
        table.active[None, :]
        & ((table.tenant_idx[None, :] == 0)
           | (table.tenant_idx[None, :] == tenant_row[:, None]))
        & ((table.device_type_idx[None, :] == 0)
           | (table.device_type_idx[None, :] == dtype_row[:, None]))
    )                                                      # [B, P]
    tick = eligible & attach[:, None]

    gdev = dev.clamp(0, D - 1).long()
    slab_rows = state.slab[gdev]                           # [B, P, 4F+2]
    stale = slab_rows[:, :, 4 * F + 1] != table.epoch[None, :]
    stale_f = stale[:, :, None]
    value_s = torch.where(stale_f, 0.0, _slab_f32(slab_rows[:, :, 0:F]))
    aux_s = torch.where(stale_f, 0.0, _slab_f32(slab_rows[:, :, F:2 * F]))
    ts_s = torch.where(stale_f, _NEG, slab_rows[:, :, 2 * F:3 * F])
    ctr_s = torch.where(stale_f, 0, slab_rows[:, :, 3 * F:4 * F])
    prev_row = ~stale & (slab_rows[:, :, 4 * F] != 0)     # [B, P]

    # ---- feature extraction + state advance ([B, P, F]) -------------------
    mm = table.feat_mm.clamp(0, M - 1).long()              # [P, F]
    fk = table.feat_kind[None, :, :]
    used = table.feat_kind > FeatureKind.UNUSED            # [P, F]

    v = lm_row[:, mm]                                      # [B, P, F]
    cur_ts = lmts_row[:, mm]
    known = cur_ts > _NEG
    observed = obs_row[:, mm] & eligible[:, :, None]
    obs_inc = observed.to(i32)

    is_ewma = fk == FeatureKind.EWMA
    is_rate = fk == FeatureKind.RATE

    # the f32 arithmetic is XLA's CPU code's (ops/numerics.py): flushed
    # where the exact result is tiny after rounding, the first NaN operand.
    # The jitted reference's contracted `alpha * v + decay` returns v's NaN
    # before alpha's (probed: tests/test_torch_anomaly_worlds.py), so v
    # goes first into the fma. The per-table constants (1 - alpha, mean,
    # scale) are computed once at [1, P, F] and broadcast over the rows.
    alpha = table.feat_alpha[None, :, :]
    decay = mul_f32(sub_f32(torch.ones_like(alpha), alpha), value_s)
    ewma = torch.where(ctr_s > 0, fma_f32(v, alpha, decay), v)
    new_sv_ewma = torch.where(observed, ewma, value_s)

    dt = torch.clamp(cur_ts - ts_s, min=1).float()
    rate = div_f32(mul_f32(sub_f32(v, value_s), 1000.0), dt)
    new_sa_rate = torch.where(observed & (ctr_s > 0), rate, aux_s)

    x = torch.where(is_ewma, new_sv_ewma,
                    torch.where(is_rate, new_sa_rate, v))  # [B, P, F]
    ready = torch.where(
        is_ewma, (ctr_s + obs_inc) > 0,
        torch.where(is_rate, (ctr_s + obs_inc) > 1, known))
    ready = ready | ~used[None]                            # pads never block

    xn = mul_f32(sub_f32(x, table.feat_mean[None]), table.feat_scale[None])
    xn = torch.where(used[None], xn, 0.0)
    nan_any = (torch.isnan(xn) & used[None]).any(dim=-1)   # [B, P]
    ready_all = ready.all(dim=-1)

    new_value = torch.where(is_ewma, new_sv_ewma,
                            torch.where(is_rate & observed, v, value_s))
    new_aux = torch.where(is_rate, new_sa_rate, aux_s)
    new_ts = torch.where(is_rate & observed, cur_ts, ts_s)
    new_ctr = torch.where(is_ewma | is_rate, ctr_s + obs_inc, ctr_s)

    # ---- forward pass over the layer bucket -------------------------------
    # features fill the first F lanes of a width-H activation; rows/cols
    # past a model's true dims are zero, and tanh(0) = 0 keeps them inert
    h0 = torch.cat([xn, xn.new_zeros((B, P, H - F))], dim=-1) if H > F \
        else xn
    is_ae = table.kind == ModelKind.AUTOENCODER            # [P]
    h = h0
    for li in range(table.num_layers):
        w = table.w[:, li]                                 # [P, H, H]
        lin = (w[None] * h[:, :, None, :]).sum(dim=-1) + table.b[None, :, li]
        last = (table.n_layers - 1) == li                  # [P]
        act = torch.where((is_ae & last)[None, :, None], lin, tanh_f32(lin))
        live = (li < table.n_layers)[None, :, None]
        h = torch.where(live, act, h)

    logit = (table.out_w[None] * h).sum(dim=-1) + table.out_b[None, :]
    mlp_score = 1.0 / (1.0 + exp_f32(-logit))
    lane_used = torch.arange(H, device=dev.device)[None, :] \
        < table.n_features[:, None]                        # [P, H]
    err = torch.where(lane_used[None], h - h0, 0.0)
    ae_score = (err * err).sum(dim=-1) \
        / table.n_features.clamp(min=1).float()[None, :]
    score = torch.where(is_ae[None, :], ae_score, mlp_score)   # [B, P]

    # ---- fires: rising edge of (score > threshold) at scored ticks --------
    scored = tick & ready_all & ~nan_any
    above = scored & (flush_denormals(score)
                      > flush_denormals(table.threshold)[None, :])
    fired = above & ~prev_row
    new_prev_row = torch.where(scored, above, prev_row)

    new_rows = torch.cat([
        _slab_i32(new_value), _slab_i32(new_aux), new_ts, new_ctr,
        new_prev_row.to(i32)[:, :, None],
        table.epoch.to(i32)[None, :, None].expand(B, P, 1),
    ], dim=-1)
    write_attach_rows(state.slab, gdev, attach & (dev < D), slab_rows,
                      new_rows)
    moved = state.gen != table.epoch
    new_state = ModelStateTensors(
        slab=state.slab,
        gen=table.epoch.to(i32).clone(),
        fire_count=torch.where(moved, 0, state.fire_count)
        + fired.sum(dim=0, dtype=i32),
        eval_count=torch.where(moved, 0, state.eval_count)
        + scored.sum(dim=0, dtype=i32),
    )

    out = first_fired(fired, table.alert_level, "first_model")
    # the score channel: the lowest SCORED slot's score this row
    slot_ids = torch.arange(P, dtype=i32, device=dev.device)
    first_scored = torch.where(scored, slot_ids[None, :], P).amin(dim=1)
    score_row = torch.gather(score, 1,
                             first_scored.clamp(0, P - 1).long()[:, None])
    out["score"] = torch.where(scored.any(dim=1), score_row[:, 0], 0.0) \
        .float()
    return new_state, out
