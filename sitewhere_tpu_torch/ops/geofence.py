"""Vectorized geofencing: point-in-polygon over all zones at once.

Counterpart of `sitewhere_tpu/ops/geofence.py`. All B location events are
tested against all Z zone polygons with the crossing-number (even-odd)
algorithm. Zones are padded to V vertices by repeating the last vertex
(registry/tensors.py): degenerate zero-length edges have y1 == y2, never
straddle a point's ray and so never toggle the parity.

Two implementations of the containment matrix:
  - `points_in_zones` here: plain torch, a Python loop over the V edges on
    [B, Z] tensors. The CPU path and the semantics the kernel is held to.
  - `ops/geofence_kernel.py`: the hand-written CUDA kernel, launched for
    every CUDA tensor (no zone-count cut-over).
`zone_reject_mask` is the kernel's exact y-rejection predicate in plain
torch, for the tests and for chip_smoke.py's work count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.ops.numerics import flush_denormals
from sitewhere_tpu_torch.ops.pack import EventBatch
from sitewhere_tpu_torch.ops.threshold import first_and_max_level

GEOFENCE_IMPLS = ("auto", "plain")


@dataclasses.dataclass
class ZoneTable:
    """Zone geometry + scoping, shapes [Z] / [Z,V,2]."""

    vertices: torch.Tensor    # f32 [Z,V,2] (lat, lon)
    nvert: torch.Tensor       # int32 [Z]
    tenant_idx: torch.Tensor  # int32 [Z]
    active: torch.Tensor      # bool [Z]


class GeofenceCondition:
    INSIDE = 0   # fire when the point IS in the zone
    OUTSIDE = 1  # fire when the point is NOT in the zone


@dataclasses.dataclass
class GeofenceRuleTable:
    """Rules binding zones to alert outcomes, shapes [G]."""

    active: torch.Tensor          # bool
    zone_row: torch.Tensor        # int32 row into ZoneTable
    condition: torch.Tensor       # int32 GeofenceCondition
    alert_level: torch.Tensor     # int32
    alert_type_idx: torch.Tensor  # int32


def empty_geofence_table(max_rules: int) -> GeofenceRuleTable:
    """Host (numpy) table the engine's compiler fills row by row."""
    def zi():
        return np.zeros(max_rules, np.int32)

    return GeofenceRuleTable(active=np.zeros(max_rules, bool), zone_row=zi(),
                             condition=zi(), alert_level=zi(),
                             alert_type_idx=zi())


def points_in_zones(lat: torch.Tensor, lon: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """Even-odd containment, plain torch: points [B] against polygons
    [Z,V,2] -> bool [B,Z].

    Loops over edges (v, v+1 mod V), accumulating the crossing parity of a
    rightward ray from each point; x_at_y is computed as
    x1 + ((x2 - x1) * (py - y1)) / safe_dy, one rounded op at a time, the
    order the kernel reproduces bit for bit. Denormal coordinates and
    intermediate results are flushed to signed zeros, as the reference's
    compiled program does (ops/numerics.py)."""
    ftz = flush_denormals
    B, Z, V = lat.shape[0], vertices.shape[0], vertices.shape[1]
    vertices = ftz(vertices)
    ends = torch.roll(vertices, shifts=-1, dims=1)            # [Z,V,2]
    px = ftz(lon)[:, None]   # [B,1] x = longitude
    py = ftz(lat)[:, None]   # [B,1] y = latitude
    parity = torch.zeros((B, Z), dtype=torch.bool, device=lat.device)
    for v in range(V):
        y1, x1 = vertices[None, :, v, 0], vertices[None, :, v, 1]   # [1,Z]
        y2, x2 = ends[None, :, v, 0], ends[None, :, v, 1]
        straddles = (y1 > py) != (y2 > py)                    # [B,Z]
        dy = ftz(y2 - y1)
        safe_dy = torch.where(dy == 0, 1.0, dy)
        x_at_y = ftz(x1 + ftz(ftz(ftz(x2 - x1) * ftz(py - y1)) / safe_dy))
        parity ^= straddles & (px < x_at_y)
    return parity


def zone_reject_mask(lat: torch.Tensor, lon: torch.Tensor,
                     vertices: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's exact y-rejection, plain torch: bool [B, Z], true
    where the point's py lies below the zone's least flushed vertex y or at
    or above its greatest, so that no edge can straddle the point's ray and
    the pair is outside (the proof is in csrc/geofence.cu). A zone with any
    NaN coordinate is never rejected; a NaN point never is either. The
    kernel makes no x-rejection, so `lon` does not enter. Used by the tests
    and by chip_smoke.py's count of the pairs the kernel must walk."""
    del lon
    ftz = flush_denormals
    vertices = ftz(vertices)
    Z, V = vertices.shape[0], vertices.shape[1]
    y = vertices[:, :, 0]
    if V:
        ymin, ymax = y.amin(dim=1), y.amax(dim=1)
    else:   # no vertex: the empty min and max, as in the kernel
        ymin = torch.full((Z,), float("inf"), device=y.device)
        ymax = torch.full((Z,), float("-inf"), device=y.device)
    has_nan = torch.isnan(vertices).flatten(1).any(dim=1)
    ymin = torch.where(has_nan, float("nan"), ymin)
    ymax = torch.where(has_nan, float("nan"), ymax)
    py = ftz(lat)[:, None]
    return (py < ymin[None, :]) | (py >= ymax[None, :])


def _containment(lat: torch.Tensor, lon: torch.Tensor,
                 vertices: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == "plain":
        return points_in_zones(lat, lon, vertices)
    if impl != "auto":
        raise ValueError(f"geofence impl {impl!r}: expected one of "
                         f"{GEOFENCE_IMPLS}")
    from sitewhere_tpu_torch.ops.geofence_kernel import (
        points_in_zones_kernel)
    return points_in_zones_kernel(lat, lon, vertices)


def eval_geofence_rules(batch: EventBatch, zones: ZoneTable,
                        rules: GeofenceRuleTable,
                        impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Evaluate geofence rules against the location events of a batch.

    Per-event outputs [B]: fired (bool), fired_count, first_rule (lowest
    fired rule, -1 if none), alert_level (max among fired rules, -1 if
    none); plus the tenant-scoped containment matrix `inside` [B,Z].
    `impl` "auto" runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors; "plain" forces the plain version (the kernel's
    comparison leg on the card)."""
    is_location = batch.event_type == DeviceEventType.LOCATION
    event_ok = batch.valid & is_location                      # [B]

    inside = _containment(batch.lat, batch.lon, zones.vertices, impl)
    zone_ok = (zones.active[None, :]
               & ((zones.tenant_idx[None, :] == 0)
                  | (zones.tenant_idx[None, :] == batch.tenant_idx[:, None])))
    inside_scoped = inside & zone_ok

    # per-rule containment: [B,G] column gathers
    zone_row = rules.zone_row.long()
    rule_inside = inside_scoped[:, zone_row]
    rule_zone_ok = zone_ok[:, zone_row]
    cond_met = torch.where(
        rules.condition[None, :] == GeofenceCondition.INSIDE,
        rule_inside, rule_zone_ok & ~rule_inside)
    fired_matrix = rules.active[None, :] & event_ok[:, None] & cond_met
    out = first_and_max_level(fired_matrix, rules.alert_level)
    out["inside"] = inside_scoped
    return out
