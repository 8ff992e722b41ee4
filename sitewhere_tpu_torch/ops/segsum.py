"""Row-order segment sums: the sum grid of the windowed analytics ops.

XLA's CPU scatter-add (`jax.ops.segment_sum`, which the reference's
`analytics/windows.py` uses) adds each segment's rows in row order, from
+0.0, with denormal results flushed to signed zeros. Both functions here
compute exactly that, from the rows sorted stably by segment:

  - `segment_row_sum_plain`: plain torch. Step r adds the r-th row of every
    segment at once, each segment at most once per step (one unique-index
    add), so the result does not depend on the order a device applies
    writes. One step per rank: its cost grows with the longest segment.
    The CPU path and the semantics the kernel is held to.
  - `segment_row_sum`: on CUDA tensors, the hand-written kernel
    `csrc/segsum.cu` (a segment of up to 256 rows folded in order by one
    thread; a longer one, in a second pass, by a warp of its own that
    stages its rows through shared memory while one lane folds them; built
    at first use, see ops/cuda_build.py), launched on the current stream
    without synchronising (a 4-byte memset, then the two passes), or
    raises; on CPU tensors, the plain version.

Offsets are int32 or int64 (int32 halves their bytes where the rows fit).

`segment_row_sum.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from sitewhere_tpu_torch.ops import cuda_build
from sitewhere_tpu_torch.ops.numerics import flush_denormals

KERNEL_SOURCE = "segsum"

# an input of magnitude below 2^-102 (and nonzero) is the only way a
# partial sum can be denormal: every other input is a multiple of 2^-125,
# and so is every rounded partial sum of such inputs
_TINY = 2.0 ** -102


def segment_row_sum_plain(values: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """f32 [S] sums of `values` (f32 [n], flushed, sorted stably by
    segment) over the segments `offsets` (int32 or int64 [S + 1],
    ascending) bound, each folded in row order from +0.0; the steps that
    reach a segment holding a tiny nonzero input flush their results."""
    offsets = offsets.long()
    S = offsets.numel() - 1
    n = values.numel()
    acc = torch.zeros(S, dtype=torch.float32, device=values.device)
    if n == 0:
        return acc
    counts = offsets[1:] - offsets[:-1]
    seg = torch.repeat_interleave(
        torch.arange(S, device=values.device), counts, output_size=n)
    rank = torch.arange(n, device=values.device) - offsets[:-1][seg]
    # rank-major: step r holds the r-th row of every segment, each
    # segment once, segments ascending
    by_rank = torch.sort(rank, stable=True).indices
    rseg = seg[by_rank]
    rval = values[by_rank]
    sizes = torch.bincount(rank).tolist()
    tiny = (values != 0) & (values.abs() < _TINY)
    careful_steps = 0
    if bool(tiny.any()):
        careful_steps = int(counts[seg[tiny]].max())
    off = 0
    for r, m in enumerate(sizes):
        s, x = rseg[off:off + m], rval[off:off + m]
        if r < careful_steps:
            acc[s] = flush_denormals(acc[s] + x)
        else:
            acc.index_add_(0, s, x)
        off += m
    return acc


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.swt_segment_row_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swt_segsum_scratch_bytes.argtypes = [ctypes.c_longlong]
        lib.swt_segsum_scratch_bytes.restype = ctypes.c_longlong
        lib.swt_segsum_error_string.argtypes = [ctypes.c_int]
        lib.swt_segsum_error_string.restype = ctypes.c_char_p
    return lib


def segment_row_sum(values: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """The row-order segment sums of `segment_row_sum_plain`; see the module
    docstring for where they run."""
    if values.device.type == "cpu":
        return segment_row_sum_plain(values, offsets)
    if values.device.type != "cuda" or offsets.device != values.device:
        raise ValueError(f"no segment-sum kernel for values on "
                         f"{values.device} and offsets on {offsets.device}")
    if values.dtype != torch.float32 or offsets.dtype not in (torch.int32,
                                                              torch.int64):
        raise TypeError(f"values must be float32 and offsets int32 or "
                        f"int64, got {values.dtype} and {offsets.dtype}")
    if values.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError("values must be [n] and offsets [S + 1]")
    values, offsets = values.contiguous(), offsets.contiguous()
    S = offsets.numel() - 1
    out = torch.empty(S, dtype=torch.float32, device=values.device)
    if S == 0:
        return out
    lib = _library()
    n = values.numel()
    scratch = torch.empty(lib.swt_segsum_scratch_bytes(n), dtype=torch.uint8,
                          device=values.device)
    # the library sets the card it launches on; the guard puts the
    # caller's current card back
    with torch.cuda.device(values.device):
        rc = lib.swt_segment_row_sum(
            values.data_ptr(), offsets.data_ptr(), out.data_ptr(), S,
            offsets.element_size(), n, scratch.data_ptr(),
            values.device.index,
            torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"segment-sum kernel launch failed: "
            f"{lib.swt_segsum_error_string(rc).decode()} (cudaError {rc})")
    segment_row_sum.launches += 1
    by_card = segment_row_sum.by_card
    by_card[values.device.index] = by_card.get(values.device.index, 0) + 1
    return out


segment_row_sum.launches = 0
# launches per card index
segment_row_sum.by_card = {}
