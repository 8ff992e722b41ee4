"""Device-memory residency ledger: what the engine keeps resident on the card.

Counterpart of `sitewhere_tpu/runtime/hbmledger.py`: the same tables under
the same names, from tensor `nbytes` (host-side accounting, no device sync),
plus `step_graphs`, the private memory pools of the engine's captured
steps (pipeline/graph.py), which hold the step's intermediates. Device
totals come from `torch.cuda.memory_stats()` where the reference reads
`Device.memory_stats()`. A sharded engine over several cards keeps its
tables in card blocks (parallel/engine.py): the ledger's `cards` lists each
card's own tables and its allocator's view.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sitewhere_tpu_torch.ops.compact import ALERT_LANE_ROWS
from sitewhere_tpu_torch.ops.pack import WIRE_ROWS
from sitewhere_tpu_torch.tree import Blocks, tree_leaves


def _tree_bytes(tree) -> int:
    """Total nbytes across a tree's tensor leaves (0 for None)."""
    if tree is None:
        return 0
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in tree_leaves(tree))


def _blocks(tree, block: Optional[int]) -> list:
    """The trees to count: every block of a `Blocks` (or only `block`),
    else the tree itself."""
    if tree is None:
        return []
    if isinstance(tree, Blocks):
        return list(tree) if block is None else [tree[block]]
    return [tree]


def table_bytes(engine, block: Optional[int] = None) -> Dict[str, int]:
    """Byte ledger of every resident table of one engine (of one card's
    block with `block`, for an engine over several cards)."""

    def count(name):
        return sum(_tree_bytes(t) for t in
                   _blocks(getattr(engine, name, None), block))

    params = _blocks(getattr(engine, "_params", None), block)
    out: Dict[str, int] = {
        "device_state": count("_state"),
        # the fused i32 slabs plus their [P] counter rows
        "rule_state": count("_rule_state"),
        "model_state": count("_model_state"),
        "rule_tables": 0,
        "model_weights": 0,
        "registry_params": 0,
    }
    for p in params:
        out["rule_tables"] += sum(
            _tree_bytes(getattr(p, k, None))
            for k in ("threshold", "zones", "geofence", "programs"))
        out["model_weights"] += _tree_bytes(getattr(p, "models", None))
        out["registry_params"] += sum(
            _tree_bytes(getattr(p, k, None))
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
    out["staging_ring"] = (int(dev_ring.resident_bytes(block))
                           if dev_ring is not None else 0)
    graphs = getattr(engine, "_graphs", None) or {}
    out["step_graphs"] = sum(_graph_bytes(g, block) for g in graphs.values())
    return out


def _graph_bytes(graph, block: Optional[int]) -> int:
    """Device bytes a captured step keeps: a one-card step's pool, output
    and input buffers; a step over several cards, those of every card's
    graphs (or of `block`'s)."""
    if hasattr(graph, "resident_bytes"):
        blocks = (range(len(graph.bodies)) if block is None else [block])
        return sum(graph.resident_bytes(k) for k in blocks)
    return (graph.pool_bytes() + int(graph.out_flat.nbytes)
            + int(graph.static_blob.nbytes))


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
    cards = getattr(engine, "cards", None)
    if cards is not None and len(cards) > 1:
        out["cards"] = []
        for k, card in enumerate(cards):
            own = table_bytes(engine, block=k)
            entry = {"card": str(card), "tables": own,
                     "total_bytes": int(sum(own.values()))}
            if card.type == "cuda":
                entry["device"] = device_headroom(card)
            out["cards"].append(entry)
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
