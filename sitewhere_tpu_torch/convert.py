"""State and tables across the two packages, as plain dicts of numpy arrays.

The JAX package keeps its registry snapshot, rule tables and device state as
dataclasses with numpy (or JAX) leaves under fixed field names. These
functions build the port's objects from dicts of numpy arrays under the
SAME field names, and back, so one world can run through both packages
without the port importing a single JAX class:

  params_from_numpy(d)      -> PipelineParams
  state_from_numpy(d)       -> DeviceStateTensors
  state_to_numpy(state)     -> dict of numpy arrays
  rule_state_from_numpy(d), model_state_from_numpy(d),
  actuation_state_from_numpy(d)
                            -> the stateful stages' state groups
  rule_state_to_numpy(s), model_state_to_numpy(s),
  actuation_state_to_numpy(s)
                            -> dicts of numpy arrays
  registry_from_snapshot(arrays, device_tokens, tenant_tokens, ...)
                            -> RegistryTensors (columns + interners)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sitewhere_tpu_torch.actuation.compiler import (
    ActuationPolicyTable, empty_policy_table)
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ml.compiler import (
    AnomalyModelTable, empty_model_table)
from sitewhere_tpu_torch.ops.actuate import ActuationStateTensors
from sitewhere_tpu_torch.ops.anomaly import ModelStateTensors
from sitewhere_tpu_torch.ops.geofence import GeofenceRuleTable, ZoneTable
from sitewhere_tpu_torch.ops.stateful import RuleStateTensors
from sitewhere_tpu_torch.ops.threshold import ThresholdRuleTable
from sitewhere_tpu_torch.pipeline.state_tensors import DeviceStateTensors
from sitewhere_tpu_torch.pipeline.step import PipelineParams
from sitewhere_tpu_torch.registry.tensors import RegistryTensors
from sitewhere_tpu_torch.rules.compiler import (
    RuleProgramTable, empty_program_table)
from sitewhere_tpu_torch.tree import to_device


def _build(cls, d: Dict):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in d]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    return cls(**{n: np.asarray(d[n]) for n in names})


def params_from_numpy(d: Dict, device: DeviceLike = "cuda"
                      ) -> PipelineParams:
    """PipelineParams on `device` from {"assignment_status", "tenant_idx",
    "area_idx", "device_type_idx": [D] arrays, "threshold": {...},
    "zones": {...}, "geofence": {...}, "programs": {...}, "models": {...},
    "policies": {...}} — the nested dicts under the field names of
    ThresholdRuleTable, ZoneTable, GeofenceRuleTable, RuleProgramTable,
    AnomalyModelTable and ActuationPolicyTable. An absent "programs",
    "models" or "policies" is that family's empty table at the engine's
    default buckets (nothing installed)."""
    dev = resolve_device(device)
    stateful = {
        "programs": (RuleProgramTable, empty_program_table),
        "models": (AnomalyModelTable, empty_model_table),
        "policies": (ActuationPolicyTable, empty_policy_table)}
    params = PipelineParams(
        assignment_status=np.asarray(d["assignment_status"]),
        tenant_idx=np.asarray(d["tenant_idx"]),
        area_idx=np.asarray(d["area_idx"]),
        device_type_idx=np.asarray(d["device_type_idx"]),
        threshold=_build(ThresholdRuleTable, d["threshold"]),
        zones=_build(ZoneTable, d["zones"]),
        geofence=_build(GeofenceRuleTable, d["geofence"]),
        **{name: _build(cls, d[name]) if name in d else empty()
           for name, (cls, empty) in stateful.items()})
    return to_device(params, dev)


def _to_numpy(group) -> Dict[str, np.ndarray]:
    """Every field of a state group (tensors or arrays) as a host numpy
    array (copies)."""
    def host(a):
        return np.array(a.cpu() if isinstance(a, torch.Tensor) else a)

    return {f.name: host(getattr(group, f.name))
            for f in dataclasses.fields(group)}


def state_from_numpy(d: Dict, device: DeviceLike = "cuda"
                     ) -> DeviceStateTensors:
    """DeviceStateTensors on `device` from a dict of its fields."""
    dev = resolve_device(device)
    return to_device(_build(DeviceStateTensors, d), dev)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every DeviceStateTensors field as a host numpy array (copies)."""
    return _to_numpy(state)


def rule_state_from_numpy(d: Dict, device: DeviceLike = "cuda"
                          ) -> RuleStateTensors:
    """RuleStateTensors on `device` from {"slab", "gen", "fire_count",
    "suppress_count"}."""
    dev = resolve_device(device)
    return to_device(_build(RuleStateTensors, d), dev)


def model_state_from_numpy(d: Dict, device: DeviceLike = "cuda"
                           ) -> ModelStateTensors:
    """ModelStateTensors on `device` from {"slab", "gen", "fire_count",
    "eval_count"}."""
    dev = resolve_device(device)
    return to_device(_build(ModelStateTensors, d), dev)


def actuation_state_from_numpy(d: Dict, device: DeviceLike = "cuda"
                               ) -> ActuationStateTensors:
    """ActuationStateTensors on `device` from {"slab", "gen", "fire_count",
    "debounce_count"}."""
    dev = resolve_device(device)
    return to_device(_build(ActuationStateTensors, d), dev)


rule_state_to_numpy = model_state_to_numpy = actuation_state_to_numpy = \
    _to_numpy


def registry_from_snapshot(arrays: Dict,
                           device_tokens: Sequence[Optional[str]],
                           tenant_tokens: Sequence[Optional[str]],
                           device_type_tokens: Sequence[Optional[str]] = (),
                           zone_tokens: Sequence[Optional[str]] = (),
                           area_tokens: Sequence[Optional[str]] = (),
                           assignment_tokens: Sequence[Optional[str]] = (),
                           shard_classes: int = 1) -> RegistryTensors:
    """The port's registry mirror from a registry snapshot (`arrays`: the
    RegistrySnapshot columns by name) and interner snapshots (index ->
    token lists, index 0 = None for UNKNOWN). Capacities follow the
    arrays: D = len(assignment_status), [Z, V, 2] = zone_vertices.
    `shard_classes` is the device interner's (a sharded world's S)."""
    D = int(np.asarray(arrays["assignment_status"]).shape[0])
    Z, V = np.asarray(arrays["zone_vertices"]).shape[:2]
    reg = RegistryTensors(max_devices=D, max_zones=int(Z),
                          max_zone_vertices=int(V),
                          shard_classes=shard_classes)
    for interner, tokens in ((reg.devices, device_tokens),
                             (reg.tenants, tenant_tokens),
                             (reg.device_types, device_type_tokens),
                             (reg.zones_interner, zone_tokens),
                             (reg.areas, area_tokens),
                             (reg.assignments, assignment_tokens)):
        interner.restore(list(tokens))
    reg.load_snapshot(arrays)
    return reg
