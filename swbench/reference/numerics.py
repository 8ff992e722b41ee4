# Frozen copy of sitewhere_tpu_torch/ops/numerics.py at commit f8b6811,
# imports rewired to swbench.reference; the benchmark's plain
# reference. Do not edit to follow the port: it is the yardstick.
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


# The exact result below which XLA's CPU code flushes: FLT_MIN * (1 - 2^-25).
# x86 detects tininess AFTER rounding (to 24 bits, exponent unbounded), so a
# result whose exact value lies in [FLT_MIN * (1 - 2^-24), this) becomes a
# signed zero there, though rounding it with gradual underflow gives FLT_MIN.
TINY_AFTER_ROUNDING = FLT_MIN * (1.0 - 2.0 ** -25)
_QUIET_BIT = 0x00400000


def nan_first(result: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """`result`, or where an operand is NaN, the first NaN operand with its
    quiet bit set: the NaN an x86 SSE/AVX/FMA instruction returns, and so
    XLA's CPU code (probed: a - b, a * b, a / b and the contracted
    a * b + c all return the first NaN operand, signalling or not). torch's
    own ops can return another operand's NaN (its CPU subtraction returns
    a signalling NaN operand before a quiet one; the card returns a
    canonical NaN), so the rule-program arithmetic states the rule."""
    out = result
    for x in reversed(operands):
        quiet = (x.view(torch.int32) | _QUIET_BIT).view(torch.float32)
        out = torch.where(torch.isnan(x), quiet, out)
    return out


def _flush_by_exact(r: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """f32 `r` as a zero of its sign where the f64 `exact` (the exact
    result, or one no rounding can move across TINY_AFTER_ROUNDING) is
    tiny after rounding."""
    return torch.where(exact.abs() < TINY_AFTER_ROUNDING, r * 0.0, r)


def _like(a: torch.Tensor, b) -> torch.Tensor:
    """`b` as a tensor of `a`'s shape, dtype and device (a Python number
    is filled in on the device, which a CUDA graph can capture)."""
    return b if isinstance(b, torch.Tensor) else torch.full_like(a, b)


def sub_f32(a: torch.Tensor, b) -> torch.Tensor:
    """f32 a - b as XLA's CPU code computes it: operands flushed, IEEE
    difference, denormal results flushed (an exact difference below FLT_MIN
    is a denormal, so no rounding hides one), the first NaN operand."""
    a, b = flush_denormals(a), flush_denormals(_like(a, b))
    return nan_first(flush_denormals(a - b), a, b)


def mul_f32(a: torch.Tensor, b) -> torch.Tensor:
    """f32 a * b as XLA's CPU code computes it: operands flushed, IEEE
    product, flushed where the exact product (exact in f64) is tiny after
    rounding, the first NaN operand."""
    a, b = flush_denormals(a), flush_denormals(_like(a, b))
    r = _flush_by_exact(a * b, a.double() * b.double())
    return nan_first(r, a, b)


def div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 a / b as XLA's CPU code computes it: operands flushed, IEEE
    quotient, flushed where the quotient is tiny after rounding (decided on
    the f64 quotient: an f32 quotient that is not a 25-bit number lies
    further than 2^-49 of its size from every such number, beyond where f64
    rounding could move it across the bound), the first NaN operand."""
    a, b = flush_denormals(a), flush_denormals(b)
    r = _flush_by_exact(a / b, a.double() / b.double())
    return nan_first(r, a, b)


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
    fma, since 53 >= 2*24 + 2 bits. The result flushes where the exact sum
    is tiny after rounding (round to odd never lands on the bound, an even
    f64 number, so the rounded-to-odd sum decides it), and a NaN operand
    gives the first NaN operand, quieted (`nan_first`). This reproduced
    XLA's jitted `a*b + c` in 2,097,152 of 2,097,152 seeded cases (wide
    exponents, heavy cancellation)."""
    a, b, c = (flush_denormals(x) for x in (a, b, c))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    # TwoSum: err = (p + c) - s exactly
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where(step, torch.nextafter(s, toward), s)
    r = _flush_by_exact(flush_denormals(s.float()), s)
    return nan_first(r, a, b, c)


# -- tanh and exp whose bits do not depend on the CPU's thread split ----------
#
# On the CPU, torch.tanh (and torch.exp) over a large f32 tensor gave other
# last bits in about one process in five or ten, on the same input and at
# the same thread count (an MKL vector-math call per parallel chunk, where
# a chunk boundary or a dispatch decision of the run changes which code path
# evaluates an element); a score near a model's threshold could then flip a
# fire between processes. On the CPU these are evaluated instead from IEEE
# basic operations alone (+ - * / and exact scalings by powers of two),
# which round the same in every vector width and chunking: in f64, then
# rounded once to f32. On the card torch.tanh / torch.exp stay as they are.

_LN2 = 0.6931471805599453
# 1/n! for the expm1 polynomial on |r| <= ln2/2 (truncation < 1e-15)
_EXPM1_COEF = [1.0 / 479001600, 1.0 / 39916800, 1.0 / 3628800,
               1.0 / 362880, 1.0 / 40320, 1.0 / 5040, 1.0 / 720,
               1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0]


def _pow2_f64(k: torch.Tensor) -> torch.Tensor:
    """2^k for integral f64 k in [-1022, 1023], exactly (exponent bits)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _expm1_parts_f64(y: torch.Tensor):
    """(2^k, q) with exp(y) = 2^k * (1 + q) and expm1(r) = q for the
    reduced r = y - k*ln2, |r| <= ln2/2; y is f64 in [-1000, 700], and NaN
    gives NaN."""
    k = torch.nan_to_num(torch.round(y / _LN2))
    r = y - k * _LN2
    q = torch.full_like(r, _EXPM1_COEF[0])
    for c in _EXPM1_COEF[1:]:
        q = q * r + c
    return _pow2_f64(k.clamp(-1022, 1023)), q * r


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh of an f32 tensor: torch.tanh on the card; on the CPU from
    expm1 as sign(x) * e / (e + 2), e = expm1(2|x|) (no cancellation near
    0), in f64, rounded once to f32. NaN stays NaN, -0.0 stays -0.0."""
    if x.device.type != "cpu":
        return torch.tanh(x)
    a = 2.0 * x.double().abs().clamp(max=40.0)
    scale, q = _expm1_parts_f64(a)
    e = torch.where(scale == 1.0, q, scale * q + (scale - 1.0))
    return torch.copysign((e / (e + 2.0)).float(), x)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor: torch.exp on the card; on the CPU as
    2^k * (1 + expm1(r)) in f64, rounded once to f32 (inf past the f32
    range, 0 below it, NaN stays NaN)."""
    if x.device.type != "cpu":
        return torch.exp(x)
    scale, q = _expm1_parts_f64(x.double().clamp(-110.0, 100.0))
    return (scale * (1.0 + q)).float()
