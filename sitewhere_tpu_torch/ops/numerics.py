"""f32 denormal handling of the reference, made explicit.

The JAX package's compiled programs read a denormal f32 operand as a zero
of the same sign, and flush a denormal f32 result to a signed zero: XLA on
the CPU runs with the DAZ/FTZ bits set, and the TPU has no denormals. So
there `1e-45 > 0` is false and `1e-45 == 0` is true. PyTorch, on the CPU and
on the card, keeps denormals. Every f32 compare and every f32 arithmetic op
of the port's hot path whose result the reference would see differently
goes through `flush_denormals` (operands, and each arithmetic result), so
the port gives the reference's answers bit for bit. Copies and selects keep
denormal bits in both packages and need nothing.

(The two can still differ for a result within 2^-150 of the smallest
normal, where the hardware's tininess rule and this check may round
differently.)
"""

from __future__ import annotations

import torch

# smallest normal float32
FLT_MIN = 1.1754943508222875e-38


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """x with every denormal replaced by a zero of its sign (NaN, inf and
    normal values unchanged)."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)
