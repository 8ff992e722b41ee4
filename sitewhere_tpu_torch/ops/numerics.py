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


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add: a*b + c rounded once, with the reference's
    denormal flushing of operands and result.

    XLA's CPU backend contracts an f32 `x*y + z` into one fused
    multiply-add, so the JAX package's EWMA update `alpha*v + (1-alpha)*sv`
    (ops/stateful.py, ops/anomaly.py) is fma(alpha, v, rn((1-alpha)*sv))
    there: under jit, eval_rule_programs (P=4, S=4, B=4096, alpha 0.3)
    wrote exactly that in 4096 of 4096 slab values, while op-by-op f32 —
    what eager torch does on the CPU and on the card — differed in 902
    (22%). The slab keeps these bits, so the port computes the fma
    explicitly instead of relying on a compiler or a floating-point mode.

    Method: the f32 x f32 product is exact in f64; TwoSum gives the exact
    error of the f64 sum; where that error is finite and nonzero and the
    sum's last bit is even, the sum steps to its neighbour toward the error
    (round to odd). Rounding that to f32 is then the correctly rounded
    fma, since 53 >= 2*24 + 2 bits. inf and NaN pass through unchanged.
    This reproduced XLA's jitted `a*b + c` in 2,097,152 of 2,097,152 seeded
    cases (wide exponents, heavy cancellation)."""
    a, b, c = (flush_denormals(x).double() for x in (a, b, c))
    p = a * b
    s = p + c
    # TwoSum: err = (p + c) - s exactly
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where(step, torch.nextafter(s, toward), s)
    return flush_denormals(s.float())
