"""Vectorized threshold-rule evaluation.

Counterpart of `sitewhere_tpu/ops/threshold.py`: R rules are a table of
columns; one batch evaluates all B x R (event, rule) pairs as a broadcast
compare, then reduces per event.

A rule matches an event when: rule active, event valid, event is a
MEASUREMENT, tenant matches (or rule tenant = 0 = any), measurement name
matches (or 0 = any), device type matches (or 0 = any), and
`value <op> threshold` holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.ops.numerics import flush_denormals
from sitewhere_tpu_torch.ops.pack import EventBatch


class ThresholdOp:
    GT = 0
    GTE = 1
    LT = 2
    LTE = 3
    EQ = 4
    NEQ = 5

    BY_NAME = {">": GT, ">=": GTE, "<": LT, "<=": LTE, "==": EQ, "!=": NEQ}


@dataclasses.dataclass
class ThresholdRuleTable:
    """SoA rule columns, all shape [R] (numpy when compiled on the host,
    tensors on the step's device)."""

    active: torch.Tensor          # bool
    tenant_idx: torch.Tensor      # int32, 0 = any tenant
    mm_idx: torch.Tensor          # int32, 0 = any measurement
    device_type_idx: torch.Tensor  # int32, 0 = any device type
    op: torch.Tensor              # int32, ThresholdOp
    threshold: torch.Tensor       # float32
    alert_level: torch.Tensor     # int32 AlertLevel fired on match
    alert_type_idx: torch.Tensor  # int32 interned alert type code


def empty_threshold_table(max_rules: int) -> ThresholdRuleTable:
    """Host (numpy) table the engine's compiler fills row by row."""
    def zi():
        return np.zeros(max_rules, np.int32)

    return ThresholdRuleTable(
        active=np.zeros(max_rules, bool), tenant_idx=zi(), mm_idx=zi(),
        device_type_idx=zi(), op=zi(),
        threshold=np.zeros(max_rules, np.float32),
        alert_level=zi(), alert_type_idx=zi())


def _compare(value: torch.Tensor, op: torch.Tensor,
             threshold: torch.Tensor) -> torch.Tensor:
    """value [B,1] vs op/threshold [1,R] -> bool [B,R]; selects among all
    six compares (no data-dependent branching).

    NaN guard: a NaN value satisfies NO comparison. The ordered compares
    are false for NaN already, but `!=` is true — a corrupt reading must
    never fire an alert, so non-firing is explicit. Denormal operands
    compare as zeros, as in the reference (ops/numerics.py)."""
    nan = torch.isnan(value)
    value, threshold = flush_denormals(value), flush_denormals(threshold)
    gt = value > threshold
    lt = value < threshold
    eq = value == threshold
    result = torch.where(
        op == ThresholdOp.GT, gt, torch.where(
            op == ThresholdOp.GTE, gt | eq, torch.where(
                op == ThresholdOp.LT, lt, torch.where(
                    op == ThresholdOp.LTE, lt | eq, torch.where(
                        op == ThresholdOp.EQ, eq, ~eq)))))
    return result & ~nan


def first_and_max_level(fired_matrix: torch.Tensor,
                        alert_level: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row reduce of a bool [B,R] fire matrix: fired, fired_count,
    lowest fired rule index (-1 if none) and max fired alert level (-1 if
    none), all int32 but `fired`."""
    R = fired_matrix.shape[1]
    fired_count = fired_matrix.sum(dim=1, dtype=torch.int32)
    fired = fired_count > 0
    rule_ids = torch.arange(R, dtype=torch.int32,
                            device=fired_matrix.device)[None, :]
    first_rule = torch.where(fired_matrix, rule_ids, R).amin(dim=1)
    first_rule = torch.where(fired, first_rule, -1).to(torch.int32)
    level = torch.where(fired_matrix, alert_level[None, :], -1).amax(dim=1)
    return {
        "fired": fired,
        "fired_count": fired_count,
        "first_rule": first_rule,
        "alert_level": level.to(torch.int32),
    }


def eval_threshold_rules(batch: EventBatch, table: ThresholdRuleTable,
                         device_type_idx_of_event: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Evaluate all rules against all events; per-event outputs [B]:
    fired (bool), fired_count, first_rule (-1 if none), alert_level (max
    among fired rules, -1 if none)."""
    value = batch.value[:, None]                              # [B,1]
    is_measurement = batch.event_type == DeviceEventType.MEASUREMENT
    event_ok = (batch.valid & is_measurement)[:, None]        # [B,1]

    tenant_ok = ((table.tenant_idx[None, :] == 0)
                 | (table.tenant_idx[None, :] == batch.tenant_idx[:, None]))
    mm_ok = ((table.mm_idx[None, :] == 0)
             | (table.mm_idx[None, :] == batch.mm_idx[:, None]))
    dtype_ok = ((table.device_type_idx[None, :] == 0)
                | (table.device_type_idx[None, :]
                   == device_type_idx_of_event[:, None]))
    predicate = _compare(value, table.op[None, :], table.threshold[None, :])

    fired_matrix = (table.active[None, :] & event_ok & tenant_ok & mm_ok
                    & dtype_ok & predicate)                   # [B,R]
    return first_and_max_level(fired_matrix, table.alert_level)
