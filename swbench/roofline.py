"""The H100's peaks and the least time of the port's hand kernels at the
cell's own inputs (copied from chip_smoke.py `geofence_bound_ms` and
`rule_bound_ms`; the arithmetic is PERF.md's).

A kernel's roofline share is its bound over its measured time: the
larger of the bytes its inputs need at the HBM rate and the operations
they need at the f32 rate, each input byte read once and each output
byte written once.
"""

from __future__ import annotations

import numpy as np

H100_F32_FLOPS = 67e12        # NVIDIA H100 SXM data sheet, non-tensor f32
H100_HBM_BYTES_S = 3.35e12    # NVIDIA H100 SXM data sheet, HBM3
# operations one node of a rule program takes on one (row, program): loads
# of its table fields and row values, the compare or combinator, the state
# read and write (a count for the bound, not a measurement)
RULE_NODE_OPS = 10


def geofence_bound_ms(B: int, Z: int, V: int, p_in: float) -> float:
    """Bytes: lat/lon read (8B), vertex tables (16VZ), bool output written
    (BZ). Operations: 2 compares for each of the B*Z pairs, and 8 f32 ops
    per edge for the p_in pairs whose point lies in the zone's y-range."""
    bytes_ms = (8 * B + 16 * V * Z + B * Z) / H100_HBM_BYTES_S * 1e3
    ops_ms = (2.0 * B * Z + 8.0 * V * p_in) / H100_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms)


def rule_bound_ms(B: int, attach: float, opcode: np.ndarray,
                  mm_idx: np.ndarray, node_limit: int, S: int) -> float:
    """Bytes: every row's attach flag (1 B) and outputs (9 B); each attach
    row's device index, newest ts, tenant and type (16 B), its P records
    read and written once (2 * P * (4S+2) * 4 B) and, for each measurement
    slot the table's VALUE/EWMA/RATE nodes read, its value, ts and
    observed flag (9 B); the table once. Operations: RULE_NODE_OPS for each
    (attach row, program, node slot in use), at the f32 peak."""
    P, N = opcode.shape
    n_eff = min(N, node_limit) if node_limit else N
    ops = opcode[:, :n_eff]
    reads_m = (ops >= 1) & (ops <= 3)
    m_used = int(np.unique(mm_idx[:, :n_eff][reads_m]).size)
    moved = (B * 10 + attach * (16 + 2 * P * (4 * S + 2) * 4 + m_used * 9)
             + P * n_eff * 9 * 4 + P * 6 * 4)
    operations = RULE_NODE_OPS * attach * P * n_eff
    return max(moved / H100_HBM_BYTES_S * 1e3,
               operations / H100_F32_FLOPS * 1e3)
