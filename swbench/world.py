"""The world of a configuration, made from the seed, and the port's engine
built over it.

`make_world` draws everything a configuration leaves to the seed (zone
geometry, which zones the geofence rules watch) as plain numpy and lists:
the one input that both the port (`build_engine`) and the reference
(`reference/world.py`) are given. Rewritten from chip_smoke.py
`random_world`, `build_world` and `build_stateful_world`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class World:
    config: Dict
    n_registered: int
    zone_vertices: np.ndarray        # f32 [Z, V, 2] (lat, lon)
    threshold_rules: List[Dict]      # token, measurement, operator, threshold, level
    geofence_rules: List[Dict]       # token, zone (row), condition, level
    families: Optional[Dict]         # programs / models / policies specs

    def device_token(self, idx: int) -> str:
        return f"dev-{idx}"


def zone_geometry(rng, Z: int, V: int, box, radius) -> np.ndarray:
    """Z convex-ish polygons [Z, V, 2] (lat, lon) of 3..V vertices each,
    padded by repeating the last one (chip_smoke.py random_world)."""
    centers = rng.uniform(box[0], box[1], (Z, 2))
    verts = np.zeros((Z, V, 2), np.float32)
    for z in range(Z):
        nv = int(rng.integers(3, V + 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        r = rng.uniform(radius[0], radius[1], nv)
        pts = centers[z] + np.stack([r * np.sin(ang), r * np.cos(ang)], 1)
        verts[z, :nv] = pts
        verts[z, nv:] = pts[-1]
    return verts


def make_world(config: Dict, seed: int) -> World:
    rng = np.random.default_rng([seed, 1])
    Z, V = config["zones"], config["zone_vertices"]
    verts = zone_geometry(rng, Z, V, config["lat_lon_box"],
                          config["zone_radius"])
    thr = config["threshold"]
    threshold_rules = [
        {"token": f"thr-{i}", "measurement": thr["measurement"],
         "operator": thr["operator"],
         "threshold": float(thr["base"] + thr["step"] * i),
         "level": int(thr["alert_level"])}
        for i in range(config["threshold_rules"])]
    zones = rng.permutation(Z)[:min(config["geofence_rules"], Z)]
    geofence_rules = [
        {"token": f"fence-{g}", "zone": int(z),
         "condition": "inside" if g % 2 == 0 else "outside", "level": g % 4}
        for g, z in enumerate(zones)]
    return World(config=config, n_registered=config["registered_devices"],
                 zone_vertices=verts, threshold_rules=threshold_rules,
                 geofence_rules=geofence_rules,
                 families=copy.deepcopy(config.get("families")))


def engine_kwargs(config: Dict, batch: int) -> Dict:
    """The PipelineEngine's sizes as the configuration states them."""
    kw = dict(batch_size=batch,
              measurement_slots=config["measurement_slots"],
              max_tenants=config["max_tenants"],
              max_threshold_rules=config["max_threshold_rules"],
              max_geofence_rules=config["max_geofence_rules"],
              presence_missing_interval_ms=config["presence_interval_ms"],
              alert_lane_capacity=config["alert_lane_capacity"])
    for key in ("max_rule_programs", "rule_program_nodes",
                "rule_program_state_slots", "max_anomaly_models",
                "anomaly_model_features", "anomaly_model_layers",
                "anomaly_model_width", "max_actuation_policies",
                "command_lane_capacity"):
        if key in config:
            kw[key] = config[key]
    return kw


def build_engine(world: World, batch: int, device, name: str = "swbench"):
    """A started PipelineEngine of the port over `world` on `device`."""
    from sitewhere_tpu_torch.model import AlertLevel
    from sitewhere_tpu_torch.pipeline import (
        GeofenceRule, PipelineEngine, ThresholdRule)
    from sitewhere_tpu_torch.registry import RegistryTensors

    config = world.config
    Z, V = world.zone_vertices.shape[:2]
    reg = RegistryTensors(max_devices=config["max_devices"], max_zones=Z,
                          max_zone_vertices=V)
    n = world.n_registered
    idx = reg.mirror_devices([world.device_token(i) for i in range(1, n + 1)],
                             tenant="tenant-1", device_type="sensor",
                             area="area-1")
    if not np.array_equal(idx, np.arange(1, n + 1)):
        raise AssertionError("device interner did not assign rows 1..N")
    for z in range(Z):
        reg.mirror_zone(f"zone-{z}", "tenant-1",
                        [tuple(v) for v in world.zone_vertices[z]],
                        area="area-1")
    engine = PipelineEngine(reg, device=device, name=name,
                            **engine_kwargs(config, batch))
    engine.packer.epoch_base_ms = config["epoch_base_ms"]
    for m, name_m in enumerate(config["measurements"], start=1):
        if engine.packer.measurements.intern(name_m) != m:
            raise AssertionError(f"measurement {name_m} not interned at {m}")
    for r in world.threshold_rules:
        engine.add_threshold_rule(ThresholdRule(
            token=r["token"], measurement_name=r["measurement"],
            operator=r["operator"], threshold=r["threshold"],
            alert_level=AlertLevel(r["level"])))
    for r in world.geofence_rules:
        engine.add_geofence_rule(GeofenceRule(
            token=r["token"], zone_token=f"zone-{r['zone']}",
            condition=r["condition"], alert_level=AlertLevel(r["level"])))
    engine.start()
    if world.families:
        for spec in world.families["programs"]:
            engine.upsert_rule_program(copy.deepcopy(spec))
        for spec in world.families["models"]:
            engine.upsert_anomaly_model(copy.deepcopy(spec))
        for spec in world.families["policies"]:
            engine.upsert_actuation_policy(copy.deepcopy(spec))
    engine._ensure_params()   # compile the installed families now
    return engine
