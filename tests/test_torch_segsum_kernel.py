"""The segment-sum kernel (csrc/segsum.cu) and its plain version at the
segment lengths around its two paths.

A segment of up to 256 rows is folded by one thread from registers; a
longer one by a warp through a shared-memory ring (ops/segsum.py). The
cases hold segments of 0, 1, 31, 32, 33, 255, 256, 257, 3,851 (the chatty
query's longest cell) and, on the card, 100,000 rows (the adversarial
fixture's hot cell), with int32 and int64 offsets; segments whose partial
sums cancel into denormals (flushed), infinities and NaN; long segments
that start off a 16-byte boundary, two long segments in one tile of 32
(folded by the warp) and tiles full of long segments (folded by their
lanes), and a long segment that ends the values.

  - On the CPU: the plain version with int32 offsets, with int64 offsets
    and the row-order fold one add at a time agree bit for bit.
  - Marked `cuda` (skipped without a card): the kernel against the plain
    version on the card, bit for bit, one launch a call. Run on the card
    with `python -m pytest --noconftest -m cuda
    tests/test_torch_segsum_kernel.py`.
This file imports no JAX (the sums are held against XLA's segment_sum by
tests/test_torch_analytics.py). Tolerance: none.
"""

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.ops.segsum import (
    segment_row_sum, segment_row_sum_plain)

FLT_MIN = np.float32(1.1754944e-38)
CPU_LENGTHS = [0, 1, 31, 32, 33, 255, 256, 257, 3851]
CARD_LENGTHS = CPU_LENGTHS + [100_000]


def fold_numpy(values, offsets):
    """Each segment from +0.0 in row order, each partial sum rounded to f32
    and flushed to a zero of its sign below FLT_MIN."""
    out = np.zeros(len(offsets) - 1, np.float32)
    for s in range(len(out)):
        acc = np.float32(0.0)
        for x in values[offsets[s]:offsets[s + 1]]:
            with np.errstate(invalid="ignore", over="ignore"):
                acc = np.float32(acc + x)
            if abs(acc) < FLT_MIN:
                acc = np.copysign(np.float32(0.0), acc)
        out[s] = acc
    return out


def segments(lengths, seed):
    """(values, offsets int64): each length as a segment of normal values,
    then the same length of near-FLT_MIN normals of both signs (sums that
    cancel into denormals); a 1-row segment before each so that starts
    fall off 16-byte boundaries; 40 single-row segments so later segments
    start a new tile; two long segments side by side (a warp folds each),
    then 40 (a tile of more than four: each lane folds its own);
    infinities with a NaN sum; the longest segment last."""
    rng = np.random.default_rng(seed)
    parts = []
    for n in lengths:
        parts.append(rng.normal(0, 100, 1))
        parts.append(rng.normal(0, 100, n))
        parts.append(rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 1.3, n)
                     * FLT_MIN)
    parts += [rng.normal(0, 1, 1) for _ in range(40)]
    parts += [rng.normal(0, 1, 300), rng.normal(0, 1, 500)]
    parts += [rng.normal(0, 1, 1) for _ in range(40)]
    parts += [rng.normal(0, 1, int(rng.integers(257, 700)))
              for _ in range(40)]
    parts.append(np.array([np.inf, 1.0, -np.inf]))
    parts.append(rng.uniform(0, 100, max(lengths)))
    values = np.concatenate(parts).astype(np.float32)
    sizes = [len(p) for p in parts]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return values, offsets


def _bits(t):
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int64])
def test_plain_version_is_the_row_order_fold(offset_dtype):
    values, offsets = segments(CPU_LENGTHS, 3)
    want = fold_numpy(values, offsets)
    got = segment_row_sum(torch.from_numpy(values),
                          torch.from_numpy(offsets).to(offset_dtype))
    nan = np.isnan(want)
    assert nan.sum() == 1 and np.array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_array_equal(_bits(got)[~nan],
                                  want.view(np.int32)[~nan])


def test_tensors_neither_on_the_cpu_nor_the_card_raise():
    values, offsets = segments([3], 4)
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        segment_row_sum(torch.from_numpy(values).to("meta"),
                        torch.from_numpy(offsets).to("meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int64])
def test_kernel_bit_equal_to_plain_on_the_card(cuda, offset_dtype):
    values, offsets = segments(CARD_LENGTHS, 5)
    v = torch.from_numpy(values).to(cuda)
    off = torch.from_numpy(offsets).to(cuda, offset_dtype)
    launches = segment_row_sum.launches
    got = segment_row_sum(v, off)
    torch.cuda.synchronize()
    assert segment_row_sum.launches == launches + 1
    ref = segment_row_sum_plain(v, off)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    want = fold_numpy(values, offsets)
    nan = np.isnan(want)
    np.testing.assert_array_equal(_bits(got)[~nan],
                                  want.view(np.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("length", CARD_LENGTHS)
def test_kernel_single_segment_lengths(cuda, length):
    """One segment of each length alone, starting at row 0 and at row 1,
    against the plain version on the card."""
    rng = np.random.default_rng(length)
    for lead in (0, 1):
        values = np.concatenate([rng.normal(0, 1, lead), (
            rng.choice([-1.0, 1.0], length) * rng.uniform(1.0, 1.3, length)
            * FLT_MIN)]).astype(np.float32)
        offsets = torch.tensor([0, lead, lead + length] if lead
                               else [0, length], dtype=torch.int64)
        v = torch.from_numpy(values).to(cuda)
        got = segment_row_sum(v, offsets.to(cuda))
        ref = segment_row_sum_plain(v, offsets.to(cuda))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
