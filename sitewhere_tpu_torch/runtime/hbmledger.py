"""Device-memory residency ledger: what the engine keeps resident on the card.

Counterpart of `sitewhere_tpu/runtime/hbmledger.py`: the same tables under
the same names, from tensor `nbytes` (host-side accounting, no device sync),
plus `step_graphs`, the private memory pools of the engine's captured
steps (pipeline/graph.py), which hold the step's intermediates. Device
totals come from `torch.cuda.memory_stats()` where the reference reads
`Device.memory_stats()`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sitewhere_tpu_torch.ops.compact import ALERT_LANE_ROWS
from sitewhere_tpu_torch.ops.pack import WIRE_ROWS
from sitewhere_tpu_torch.tree import tree_leaves


def _tree_bytes(tree) -> int:
    """Total nbytes across a tree's tensor leaves (0 for None)."""
    if tree is None:
        return 0
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in tree_leaves(tree))


def table_bytes(engine) -> Dict[str, int]:
    """Byte ledger of every resident table of one engine."""
    params = getattr(engine, "_params", None)
    out: Dict[str, int] = {
        "device_state": _tree_bytes(getattr(engine, "_state", None)),
        # the fused i32 slabs plus their [P] counter rows
        "rule_state": _tree_bytes(getattr(engine, "_rule_state", None)),
        "model_state": _tree_bytes(getattr(engine, "_model_state", None)),
        "rule_tables": 0,
        "model_weights": 0,
        "registry_params": 0,
    }
    if params is not None:
        out["rule_tables"] = sum(
            _tree_bytes(getattr(params, k, None))
            for k in ("threshold", "zones", "geofence", "programs"))
        out["model_weights"] = _tree_bytes(getattr(params, "models", None))
        out["registry_params"] = sum(
            _tree_bytes(getattr(params, k, None))
            for k in ("assignment_status", "tenant_idx", "area_idx",
                      "device_type_idx"))
    # fixed per-step capacities (the same shape every step)
    alert_cap = int(getattr(engine, "alert_lane_capacity", 0) or 0)
    out["alert_lanes"] = ALERT_LANE_ROWS * 4 * alert_cap
    route_cap = int(getattr(engine, "route_lane_capacity", 0) or 0)
    out["route_lanes"] = WIRE_ROWS * 4 * route_cap
    # the pinned host blob ring, counted because it sizes the H2D working
    # set (empty until the first full-size submit on the card)
    ring = getattr(engine, "_blob_ring", None)
    out["staging_buffers"] = (sum(int(b.nbytes) for b in ring)
                              if ring else 0)
    dev_ring = getattr(engine, "_staging_ring", None)
    out["staging_ring"] = (int(dev_ring.resident_bytes())
                           if dev_ring is not None else 0)
    graphs = getattr(engine, "_graphs", None) or {}
    out["step_graphs"] = sum(g.pool_bytes() + int(g.out_flat.nbytes)
                             + int(g.static_blob.nbytes)
                             for g in graphs.values())
    return out


def device_headroom(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's own accounting for a CUDA device (None on a
    machine without one): bytes in use, reserved, the card's total and
    what is free of it."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total), "bytes_free": int(free)}


def ledger(engine) -> Dict:
    """The full ledger block: per-table bytes, total, and (on a card) the
    allocator's view of the device."""
    tables = table_bytes(engine)
    out: Dict = {"tables": tables,
                 "total_bytes": int(sum(tables.values()))}
    if engine.device.type == "cuda":
        out["device"] = device_headroom(engine.device)
    return out


def export_gauges(engine, prefix: str = "hbm.table_bytes") -> Dict[str, int]:
    """Labeled extra-gauge dict for MetricsRegistry.prometheus_text: one
    ``hbm.table_bytes{table="..."}`` sample per resident table plus the
    ``hbm.total_bytes`` rollup."""
    tables = table_bytes(engine)
    out = {f'{prefix}{{table="{name}"}}': bytes_
           for name, bytes_ in tables.items()}
    out["hbm.total_bytes"] = int(sum(tables.values()))
    return out
