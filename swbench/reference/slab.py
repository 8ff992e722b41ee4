# Frozen copy of sitewhere_tpu_torch/ops/slab.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
"""Fused i32 state-slab primitives of the stateful stages.

Counterpart of `sitewhere_tpu/ops/slab.py`, same layout. The rule-program,
anomaly-model and actuation stages keep their per-(device, slot) state in
one interleaved i32 slab [D, P, 4*S+2], so a step pulls a device's whole
state record with one contiguous gather. Lane layout: [0:S] value f32 bits,
[S:2S] aux f32 bits, [2S:3S] ts, [3S:4S] counter, lane 4S the flag bit
(root_prev / score_prev), lane 4S+1 the per-row generation. Float planes
travel as raw IEEE bit patterns, so NaN payloads and -0.0 round-trip
exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_slab_lanes(slots: int) -> int:
    """Lane count of a fused state slab with `slots` state slots: four
    interleaved planes (value/aux bits, ts, counter) plus the flag and
    row-generation lanes."""
    return 4 * slots + 2


def pack_state_slab_np(value: np.ndarray, aux: np.ndarray, ts: np.ndarray,
                       counter: np.ndarray, flag: np.ndarray,
                       row_gen: np.ndarray) -> np.ndarray:
    """Fuse per-field state arrays into one i32 slab along the last axis
    (the layout above); float planes are stored as their bit patterns.
    Works for any leading dims."""
    def bits(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return np.ascontiguousarray(a).view(np.int32)
        return np.ascontiguousarray(a).astype(np.int32)

    return np.concatenate([
        bits(value), bits(aux),
        np.asarray(ts, np.int32), np.asarray(counter, np.int32),
        bits(flag)[..., None], np.asarray(row_gen, np.int32)[..., None],
    ], axis=-1)


def unpack_state_slab_np(slab: np.ndarray, *, float_flag: bool = False
                         ) -> Dict[str, np.ndarray]:
    """Inverse of pack_state_slab_np. `float_flag` reads the flag lane as
    f32 bits instead of a 0/1 bit."""
    slab = np.ascontiguousarray(np.asarray(slab, np.int32))
    S = (slab.shape[-1] - 2) // 4

    def as_f32(a):
        return np.ascontiguousarray(a).view(np.float32)

    flag = slab[..., 4 * S]
    return {
        "value": as_f32(slab[..., 0:S]),
        "aux": as_f32(slab[..., S:2 * S]),
        "ts": slab[..., 2 * S:3 * S].copy(),
        "counter": slab[..., 3 * S:4 * S].copy(),
        "flag": as_f32(flag) if float_flag else flag.copy(),
        "row_gen": slab[..., 4 * S + 1].copy(),
    }


def _slab_f32(plane: torch.Tensor) -> torch.Tensor:
    """i32 lane plane -> f32, a bitcast (NaN payloads, -0.0 kept)."""
    return plane.view(torch.float32)


def _slab_i32(plane: torch.Tensor) -> torch.Tensor:
    """f32 plane -> its raw i32 bits for slab storage."""
    return plane.view(torch.int32)
