"""The pipeline step: validate + rules + device-state fold + stateful
stages + alert and command lanes.

Counterpart of `sitewhere_tpu/pipeline/step.py` `process_batch` and
`check_presence`, for the single-device hot path. What the reference does
with per-event service hops — device lookup and assignment check, rule
processing, zone containment, device-state upserts — happens here as a
short sequence of batched torch ops and one hand-written kernel (geofence
containment) over a whole batch; then the three stateful stages of the
JAX step — rule programs, anomaly models and actuation policies — each
dropped when its family has nothing installed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from sitewhere_tpu_torch.actuation.compiler import ActuationPolicyTable
from sitewhere_tpu_torch.ml.compiler import AnomalyModelTable
from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.ops.actuate import (
    COMMAND_LANE_ROWS, DEFAULT_COMMAND_LANE_CAPACITY, ActuationStateTensors,
    eval_actuation_policies)
from sitewhere_tpu_torch.ops.anomaly import (
    ModelStateTensors, eval_anomaly_models)
from sitewhere_tpu_torch.ops.compact import (
    DEFAULT_ALERT_LANE_CAPACITY, compact_alert_lanes)
from sitewhere_tpu_torch.ops.geofence import (
    GeofenceRuleTable, ZoneTable, eval_geofence_rules)
from sitewhere_tpu_torch.ops.pack import EventBatch
from sitewhere_tpu_torch.ops.segments import (
    batch_device_order, count_by_key, last_by_key, scatter_max_by_key)
from sitewhere_tpu_torch.ops.stateful import (
    RuleStateTensors, eval_rule_programs, observations_of_batch)
from sitewhere_tpu_torch.ops.threshold import (
    ThresholdRuleTable, eval_threshold_rules)
from sitewhere_tpu_torch.pipeline.state_tensors import DeviceStateTensors
from sitewhere_tpu_torch.rules.compiler import RuleProgramTable

_NEG = -(2 ** 31)


@dataclasses.dataclass
class PipelineParams:
    """Everything the step reads but does not write: registry mirror + rule
    tables, as tensors on the step's device."""

    # registry mirror (registry/tensors.py), [D]
    assignment_status: torch.Tensor
    tenant_idx: torch.Tensor
    area_idx: torch.Tensor
    device_type_idx: torch.Tensor
    # rule tables
    threshold: ThresholdRuleTable
    zones: ZoneTable
    geofence: GeofenceRuleTable
    # compiled rule programs, anomaly models and actuation policies
    programs: RuleProgramTable
    models: AnomalyModelTable
    policies: ActuationPolicyTable


@dataclasses.dataclass
class ProcessOutputs:
    """Per-batch outputs; the field set of the reference's ProcessOutputs."""

    valid: torch.Tensor                  # bool [B] passed validation
    unregistered: torch.Tensor           # bool [B] had no active assignment
    threshold_fired: torch.Tensor        # bool [B]
    threshold_first_rule: torch.Tensor   # int32 [B]
    threshold_alert_level: torch.Tensor  # int32 [B]
    geofence_fired: torch.Tensor         # bool [B]
    geofence_first_rule: torch.Tensor    # int32 [B]
    geofence_alert_level: torch.Tensor   # int32 [B]
    # rule-program and anomaly-model fires, on their attach rows
    program_fired: torch.Tensor          # bool [B]
    program_first_rule: torch.Tensor     # int32 [B] program slot, -1 = none
    program_alert_level: torch.Tensor    # int32 [B]
    model_fired: torch.Tensor            # bool [B]
    model_first: torch.Tensor            # int32 [B] model slot, -1 = none
    model_level: torch.Tensor            # int32 [B] max fired level
    model_score: torch.Tensor            # f32 [B] lowest scored slot's score
    tenant_counts: torch.Tensor          # int32 [T] events per tenant
    processed: torch.Tensor              # int32 scalar, valid events
    alerts: torch.Tensor                 # int32 scalar, alerts fired
    alert_lanes: torch.Tensor            # int32 [ALERT_LANE_ROWS, K]
    command_lanes: torch.Tensor          # int32 [COMMAND_LANE_ROWS, K_cmd]


def validate_batch(params: PipelineParams, batch: EventBatch,
                   num_devices: int
                   ) -> Tuple[EventBatch, torch.Tensor, torch.Tensor]:
    """Stage 1: registry gathers. Returns (batch with tenant_idx and the
    validated mask filled in, per-event device type, unregistered mask).

    Unknown tokens intern to index 0, whose registry row always holds
    status 0, so one status gather covers "unknown device" and "no active
    assignment". A device index >= D (the wire field allows up to 2^22-1)
    gathers row D-1, as XLA clamps an out-of-range gather in the
    reference; torch indexing would raise instead."""
    gidx = batch.device_idx.clamp(0, num_devices - 1).long()
    registered = params.assignment_status[gidx] == 1   # ACTIVE
    unregistered = batch.valid & ~registered
    valid = batch.valid & registered
    batch = dataclasses.replace(batch, tenant_idx=params.tenant_idx[gidx],
                                valid=valid)
    return batch, params.device_type_idx[gidx], unregistered


def fold_device_state(state: DeviceStateTensors,
                      batch: EventBatch) -> DeviceStateTensors:
    """Stage 3: fold a validated batch into new per-device state tensors
    (the tenant counters are left to stage 4)."""
    D = state.num_devices
    M = state.num_measurement_slots
    dev, ts, valid = batch.device_idx, batch.ts, batch.valid
    last_interaction = scatter_max_by_key(dev, ts, valid, D,
                                          state.last_interaction)
    counts = count_by_key(dev, valid, D)
    # presence restore: any device with a valid event is present again
    touched = counts > 0

    is_loc = valid & (batch.event_type == DeviceEventType.LOCATION)
    loc_vals = torch.stack([batch.lat, batch.lon, batch.elevation], dim=1)
    loc_ts, (last_location,) = last_by_key(
        dev, ts, is_loc, D, state.last_location_ts,
        (state.last_location,), (loc_vals,))

    # last measurement per (device, slot < M)
    is_mm = (valid & (batch.event_type == DeviceEventType.MEASUREMENT)
             & (batch.mm_idx < M))
    mm_ts, (mm_val,) = last_by_key(
        dev * M + batch.mm_idx, ts, is_mm, D * M,
        state.last_measurement_ts.reshape(-1),
        (state.last_measurement.reshape(-1),), (batch.value,))

    # last device-sent alert per device
    is_alert = valid & (batch.event_type == DeviceEventType.ALERT)
    alert_ts, (alert_type, alert_level) = last_by_key(
        dev, ts, is_alert, D, state.last_alert_ts,
        (state.last_alert_type, state.last_alert_level),
        (batch.alert_type_idx, batch.alert_level))

    return dataclasses.replace(
        state,
        last_interaction=last_interaction,
        present=state.present | touched,
        presence_missing_since=torch.where(touched, _NEG,
                                           state.presence_missing_since),
        event_count=state.event_count + counts,
        last_location=last_location,
        last_location_ts=loc_ts,
        last_measurement=mm_val.reshape(D, M),
        last_measurement_ts=mm_ts.reshape(D, M),
        last_alert_type=alert_type,
        last_alert_level=alert_level,
        last_alert_ts=alert_ts)


def _placeholders(B: int, device) -> Tuple[Dict, Dict]:
    """Row outputs of the rule-program and anomaly-model stages when they
    are off, as in the reference."""
    none = torch.full((B,), -1, dtype=torch.int32, device=device)
    off = torch.zeros(B, dtype=torch.bool, device=device)
    prog = {"fired": off, "first_rule": none, "alert_level": none}
    model = {"fired": off, "first_model": none, "alert_level": none,
             "score": torch.zeros(B, dtype=torch.float32, device=device)}
    return prog, model


def stateful_rows(params: PipelineParams, state: DeviceStateTensors,
                  batch: EventBatch
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """The device-sorted row view both stateful stages read: (the row
    keywords of eval_rule_programs / eval_anomaly_models, the rows' newest
    observation ts, the inverse permutation that un-sorts their outputs).
    `state` is the POST-fold device state and `batch` the validated batch.
    Rows of one device read adjacent state. Gathers clamp a device index
    >= D to row D-1, as XLA does in the reference."""
    D = state.num_devices
    obs_mm, _, now_d, attach_row = observations_of_batch(
        batch, state.num_measurement_slots, D)
    order, inv = batch_device_order(batch.device_idx)
    sdev = batch.device_idx[order]
    gdev = sdev.clamp(0, D - 1).long()
    rows = dict(dev=sdev, attach=attach_row[order], obs_row=obs_mm[gdev],
                lm_row=state.last_measurement[gdev],
                lmts_row=state.last_measurement_ts[gdev],
                tenant_row=params.tenant_idx[gdev],
                dtype_row=params.device_type_idx[gdev])
    return rows, now_d[gdev], inv


def process_batch(params: PipelineParams, state: DeviceStateTensors,
                  rule_state: RuleStateTensors,
                  model_state: ModelStateTensors,
                  actuation_state: ActuationStateTensors,
                  batch: EventBatch, *, geofence_impl: str = "auto",
                  alert_lane_capacity: int = DEFAULT_ALERT_LANE_CAPACITY,
                  programs_enabled: bool = False,
                  program_node_limit: int = 0,
                  models_enabled: bool = False,
                  actuation_enabled: bool = False,
                  command_lane_capacity: int = DEFAULT_COMMAND_LANE_CAPACITY
                  ) -> Tuple[DeviceStateTensors, RuleStateTensors,
                             ModelStateTensors, ActuationStateTensors,
                             ProcessOutputs]:
    """One step over a batch already on the step's device.

    Returns (new_state, rule_state, model_state, actuation_state, outputs).
    The device-state group is NOT updated in place: the new state is a
    fresh set of tensors, so `state` stays readable until the caller drops
    it. The slabs of the three stateful groups ARE updated in place (the
    reference donates them): they hold hundreds of MB at full size, and a
    step writes only its batch's devices.

    Each stateful stage runs only when its flag is set — the engine sets it
    while its family has something installed — and its state passes
    through untouched otherwise (any value, None included); the rows of an
    off stage are the reference's placeholders and the command lane is
    zeros. `program_node_limit` trims the rule programs' node pass to the
    node slots the compiled table uses (0 = all).
    `geofence_impl` "auto" runs the containment kernel on CUDA tensors and
    the plain version on CPU tensors; "plain" forces the plain version.
    `alert_lane_capacity` and `command_lane_capacity` are the K of the
    alert and command lanes."""
    T = state.tenant_event_count.shape[0]
    B = batch.device_idx.shape[0]

    # stage 1: validation
    batch, device_type, unregistered = validate_batch(
        params, batch, state.num_devices)
    valid, tenant = batch.valid, batch.tenant_idx

    # stage 2: rule evaluation
    thr = eval_threshold_rules(batch, params.threshold, device_type)
    geo = eval_geofence_rules(batch, params.zones, params.geofence,
                              impl=geofence_impl)

    # stage 3: device-state fold
    new_state = fold_device_state(state, batch)
    prog, model = _placeholders(B, valid.device)

    if programs_enabled or models_enabled:
        rows, now_row, inv = stateful_rows(params, new_state, batch)

    # stage 3b: rule programs, on the POST-fold measurement state
    if programs_enabled:
        rule_state, sprog = eval_rule_programs(
            params.programs, rule_state, now_row=now_row,
            node_limit=program_node_limit, **rows)
        prog = {k: v[inv] for k, v in sprog.items()}

    # stage 3c: anomaly-model scoring
    if models_enabled:
        model_state, smodel = eval_anomaly_models(params.models, model_state,
                                                  **rows)
        model = {k: v[inv] for k, v in smodel.items()}

    # stage 3d: actuation policies, over every family's fire bits
    if actuation_enabled:
        actuation_state, command_lanes = eval_actuation_policies(
            params.policies, actuation_state, dev=batch.device_idx,
            ts=batch.ts, tenant_row=tenant, thr=thr, geo=geo, prog=prog,
            model=model, capacity=command_lane_capacity)
    else:
        command_lanes = torch.zeros(
            (COMMAND_LANE_ROWS, command_lane_capacity), dtype=torch.int32,
            device=valid.device)

    # stage 4: stats + alert lanes
    tenant_counts = count_by_key(tenant, valid, T)
    fired_any = thr["fired"] | geo["fired"] | prog["fired"] | model["fired"]
    new_state = dataclasses.replace(
        new_state,
        tenant_event_count=state.tenant_event_count + tenant_counts,
        tenant_alert_count=state.tenant_alert_count + count_by_key(
            tenant, valid & fired_any, T))
    outputs = ProcessOutputs(
        valid=valid,
        unregistered=unregistered,
        threshold_fired=thr["fired"],
        threshold_first_rule=thr["first_rule"],
        threshold_alert_level=thr["alert_level"],
        geofence_fired=geo["fired"],
        geofence_first_rule=geo["first_rule"],
        geofence_alert_level=geo["alert_level"],
        program_fired=prog["fired"],
        program_first_rule=prog["first_rule"],
        program_alert_level=prog["alert_level"],
        model_fired=model["fired"],
        model_first=model["first_model"],
        model_level=model["alert_level"],
        model_score=model["score"],
        tenant_counts=tenant_counts,
        processed=valid.sum(dtype=torch.int32),
        alerts=(thr["fired"].sum(dtype=torch.int32)
                + geo["fired"].sum(dtype=torch.int32)
                + prog["fired"].sum(dtype=torch.int32)
                + model["fired"].sum(dtype=torch.int32)),
        alert_lanes=compact_alert_lanes(thr, geo, alert_lane_capacity,
                                        prog, model),
        command_lanes=command_lanes,
    )
    return new_state, rule_state, model_state, actuation_state, outputs


def check_presence(state: DeviceStateTensors, registered: torch.Tensor,
                   now_rel: int, missing_interval_ms: int
                   ) -> Tuple[DeviceStateTensors, torch.Tensor]:
    """Periodic presence sweep (the reference's DevicePresenceManager
    checker). A registered device that has interacted before and whose last
    interaction is older than `missing_interval_ms` turns NOT_PRESENT
    exactly once; returns (new_state, newly_missing mask). int32
    arithmetic wraps as in the reference."""
    dev = state.last_interaction.device
    now = torch.tensor(now_rel, dtype=torch.int32, device=dev)
    interval = torch.tensor(missing_interval_ms, dtype=torch.int32,
                            device=dev)
    has_interacted = state.last_interaction > _NEG
    overdue = (now - state.last_interaction) > interval
    newly_missing = registered & has_interacted & state.present & overdue
    new_state = dataclasses.replace(
        state,
        present=state.present & ~newly_missing,
        presence_missing_since=torch.where(
            newly_missing, now, state.presence_missing_since))
    return new_state, newly_missing
