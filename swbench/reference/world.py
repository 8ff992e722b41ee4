"""The benchmark's world compiled into the reference step's params.

Works out again, from the world the harness made (swbench/world.py World:
the configuration, zone geometry and rule and family specs), what the
port's engine derives at set-up: the registry mirror's columns, the
threshold, zone and geofence tables, and the compiled rule-program,
anomaly-model and actuation-policy tables with their slots and epochs.
Mirrors sitewhere_tpu_torch/pipeline/engine.py `_refresh_params`,
`_compile_*_table` and `_install` (slots in install order, one epoch
counter a family, starting at 1) and registry/tensors.py
`mirror_devices` / `mirror_zone`, at commit f8b6811.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from swbench.reference import actuation_compiler as acomp
from swbench.reference import ml_compiler as mcomp
from swbench.reference import rules_compiler as rcomp
from swbench.reference.geofence import (
    GeofenceCondition, ZoneTable, empty_geofence_table)
from swbench.reference.step import PipelineParams
from swbench.reference.threshold import ThresholdOp, empty_threshold_table


class _Interner:
    """Token -> index from 1, in first-seen order (0 = unknown / any)."""

    def __init__(self, tokens=()):
        self.index: Dict[str, int] = {}
        for token in tokens:
            self.intern(token)

    def intern(self, token: str) -> int:
        if token not in self.index:
            self.index[token] = len(self.index) + 1
        return self.index[token]

    def lookup(self, token: str) -> int:
        return self.index.get(token, 0)


def _to_torch(table, device):
    """A compiled table's numpy columns as tensors on `device`."""
    changes = {}
    for f in dataclasses.fields(table):
        v = getattr(table, f.name)
        if isinstance(v, np.ndarray):
            changes[f.name] = torch.from_numpy(np.ascontiguousarray(v)).to(
                device)
    return dataclasses.replace(table, **changes)


@dataclasses.dataclass
class Compiled:
    params: PipelineParams
    flags: Dict                 # process_batch's stage keywords
    programs: Dict[int, Dict]   # slot -> normalized spec
    models: Dict[int, Dict]
    policies: Dict[int, Dict]


def compile_world(world, device, n_rows: Optional[int] = None) -> Compiled:
    """Params on `device` for a registry of `n_rows` device rows (default:
    the configuration's max_devices), rows 1.. registered and active up to
    the world's registered count (or every row but 0 when `n_rows` is
    given: a replay over a subset of the devices, renumbered 1..n)."""
    cfg = world.config
    D = cfg["max_devices"] if n_rows is None else n_rows
    n_active = world.n_registered if n_rows is None else n_rows - 1
    status = np.zeros(D, np.int32)
    status[1:n_active + 1] = 1
    ones = np.where(status == 1, 1, 0).astype(np.int32)
    tenants, dtypes = _Interner(["tenant-1"]), _Interner(["sensor"])
    measurements = _Interner(cfg["measurements"])
    alert_types, commands = _Interner(), _Interner()

    thr = empty_threshold_table(cfg["max_threshold_rules"])
    for i, r in enumerate(world.threshold_rules):
        thr.active[i] = True
        thr.mm_idx[i] = measurements.intern(r["measurement"])
        thr.op[i] = ThresholdOp.BY_NAME[r["operator"]]
        thr.threshold[i] = r["threshold"]
        thr.alert_level[i] = r["level"]
        thr.alert_type_idx[i] = alert_types.intern("threshold.violation")
    verts = world.zone_vertices
    Z, V = verts.shape[:2]
    zones = ZoneTable(vertices=verts.copy(),
                      nvert=np.full(Z, V, np.int32),
                      tenant_idx=np.ones(Z, np.int32),
                      active=np.full(Z, V >= 3))
    geo = empty_geofence_table(cfg["max_geofence_rules"])
    for i, r in enumerate(world.geofence_rules):
        geo.active[i] = True
        geo.zone_row[i] = r["zone"]
        geo.condition[i] = (GeofenceCondition.INSIDE
                            if r["condition"] == "inside"
                            else GeofenceCondition.OUTSIDE)
        geo.alert_level[i] = r["level"]
        geo.alert_type_idx[i] = alert_types.intern("zone.violation")

    fam = world.families or {"programs": [], "models": [], "policies": []}
    programs = rcomp.empty_program_table(
        cfg.get("max_rule_programs", 32), cfg.get("rule_program_nodes", 16))
    prog_specs, model_specs, policy_specs = {}, {}, {}
    for slot, spec in enumerate(fam["programs"]):
        norm = rcomp.dry_run_compile(
            copy.deepcopy(spec), measurement_slots=cfg["measurement_slots"],
            max_nodes=cfg.get("rule_program_nodes", 16),
            max_state_slots=cfg.get("rule_program_state_slots", 8),
            intern_measurement=measurements.intern)
        rcomp.compile_program_into(
            programs, slot, norm, slot + 1,
            intern_measurement=measurements.intern,
            intern_alert_type=alert_types.intern,
            lookup_tenant=tenants.lookup, lookup_device_type=dtypes.lookup,
            measurement_slots=cfg["measurement_slots"],
            max_state_slots=cfg.get("rule_program_state_slots", 8))
        prog_specs[slot] = norm
    used = np.nonzero((programs.opcode != 0).any(axis=0))[0]
    node_limit = int(used.max()) + 1 if used.size else 0
    models = mcomp.empty_model_table(
        cfg.get("max_anomaly_models", 8), cfg.get("anomaly_model_features", 4),
        cfg.get("anomaly_model_layers", 2), cfg.get("anomaly_model_width", 8))
    for slot, spec in enumerate(fam["models"]):
        norm = mcomp.dry_run_compile(
            copy.deepcopy(spec), measurement_slots=cfg["measurement_slots"],
            max_features=cfg.get("anomaly_model_features", 4),
            max_layers=cfg.get("anomaly_model_layers", 2),
            width=cfg.get("anomaly_model_width", 8),
            intern_measurement=measurements.intern)
        mcomp.compile_model_into(
            models, slot, norm, slot + 1,
            intern_measurement=measurements.intern,
            intern_alert_type=alert_types.intern,
            lookup_tenant=tenants.lookup, lookup_device_type=dtypes.lookup,
            measurement_slots=cfg["measurement_slots"])
        model_specs[slot] = norm
    policies = acomp.empty_policy_table(cfg.get("max_actuation_policies", 8))
    for slot, spec in enumerate(fam["policies"]):
        norm = acomp.dry_run_compile(copy.deepcopy(spec),
                                     intern_command=commands.intern)
        acomp.compile_policy_into(policies, slot, norm, slot + 1,
                                  intern_command=commands.intern,
                                  lookup_tenant=tenants.lookup)
        policy_specs[slot] = norm

    dev = torch.device(device)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    params = PipelineParams(
        assignment_status=t(status), tenant_idx=t(ones),
        area_idx=t(ones.copy()), device_type_idx=t(ones.copy()),
        threshold=_to_torch(thr, dev), zones=_to_torch(zones, dev),
        geofence=_to_torch(geo, dev), programs=_to_torch(programs, dev),
        models=_to_torch(models, dev), policies=_to_torch(policies, dev))
    flags = dict(alert_lane_capacity=cfg["alert_lane_capacity"],
                 programs_enabled=bool(prog_specs),
                 program_node_limit=node_limit,
                 models_enabled=bool(model_specs),
                 actuation_enabled=bool(policy_specs),
                 command_lane_capacity=cfg.get("command_lane_capacity", 64))
    return Compiled(params=params, flags=flags, programs=prog_specs,
                    models=model_specs, policies=policy_specs)
