"""Windowed tensor reductions: the batch-analytics device ops.

Counterpart of `sitewhere_tpu/analytics/windows.py`. Events keyed by
(key, time-bucket) fold into dense [K, W] stat grids (count/sum/mean/min/
max): a (key, window) pair maps to one segment `key * n_windows + bucket`,
and invalid or out-of-range rows (key < 0, key >= K, bucket < 0,
bucket >= W) map to a dropped trailing segment. The ops run as torch ops on
an explicit `device` (default "cuda"; tests pass "cpu").

The grids are bit-equal to the reference's XLA CPU program, on the CPU and
on the card alike, because nothing here depends on the order in which a
device applies writes:

* counts are integer scatters;
* sums are folded in row order, as XLA's scatter-add adds them: rows are
  sorted stably by segment and each segment is folded in order
  (ops/segsum.py: on the card a hand kernel, one thread per segment);
* min and max are integer scatter-min/max over an order-preserving map of
  the f32 bits, which puts -0.0 below +0.0 as XLA orders it;
* XLA CPU reads f32 denormal operands as signed zeros and flushes denormal
  results. Inputs are flushed once, and the fold flushes its partial sums;
* NaN bits follow XLA's CPU code: a sum takes the last NaN of its segment
  in row order, quieted (inf + -inf gives the x86 default NaN 0xFFC00000);
  min takes the segment's first NaN with the sign bit clear, else its last
  NaN; max its first NaN with the sign bit set, else its last NaN; min and
  max keep the NaN's bits as they are.
* With a single input row, XLA stores the row as it is (no flush, no
  quieting) into its cell of the sum, min and max grids; so does this.

`block_partials` folds S contiguous blocks of rows in one pass, each as a
call of its own would fold it (the per-shard grids of the sharded path,
parallel/distributed.py); `windowed_stats` is its one-block case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ops.numerics import flush_denormals
from sitewhere_tpu_torch.ops.segsum import segment_row_sum

_QUIET_BIT = 0x00400000
_X86_DEFAULT_NAN = -0x00400000   # 0xFFC00000 as int32
_CANONICAL_NAN = 0x7FC00000      # jnp.nan, the empty-cell sentinel


@dataclass
class WindowedStats:
    """Dense per-(key, window) statistics, all shape [K, W].

    `mean`/`min`/`max` are NaN where count == 0 (query layers mask on count).
    """

    count: torch.Tensor  # int32
    sum: torch.Tensor    # float32
    mean: torch.Tensor   # float32
    min: torch.Tensor    # float32
    max: torch.Tensor    # float32

    @property
    def num_keys(self) -> int:
        return self.count.shape[0]

    @property
    def num_windows(self) -> int:
        return self.count.shape[1]

    def to(self, device: DeviceLike) -> "WindowedStats":
        """The five grids on `device` in one copy (a single [5, K, W]
        int32 buffer crosses, then splits into views)."""
        device = torch.device(device)
        if self.count.device == device:
            return self
        packed = torch.stack([self.count] + [
            g.view(torch.int32) for g in (self.sum, self.mean, self.min,
                                          self.max)])
        packed = to_host(packed) if device.type == "cpu" \
            else packed.to(device)
        return WindowedStats(packed[0], *(packed[i].view(torch.float32)
                                          for i in range(1, 5)))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host. From the card: one copy into pinned memory on the
    current stream, then a wait for that stream alone."""
    if t.device.type != "cuda":
        return t.cpu()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array `a` on `device`; to the card through pinned memory, on
    the current stream, without waiting."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`x` as `dtype` on `device`, converted as `jnp.asarray(x, dtype)`
    converts it: host arrays through numpy (int64 wraps to int32), tensors
    with torch's own cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32,
                torch.bool: np.bool_}[dtype]
    return to_device(np.asarray(x).astype(np_dtype), device)


def _segments(keys: torch.Tensor, ts_rel: torch.Tensor, valid: torch.Tensor,
              window_ms: int, num_keys: int, n_windows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in_range bool [B], segment int64 [B]) with int32 floor bucketing;
    the segment of a dropped row is num_keys * n_windows."""
    bucket = torch.div(ts_rel, window_ms, rounding_mode="floor")
    in_range = valid & (bucket >= 0) & (bucket < n_windows) & \
        (keys >= 0) & (keys < num_keys)
    seg = torch.where(in_range, keys.long() * n_windows + bucket.long(),
                      num_keys * n_windows)
    return in_range, seg


def _sortable(bits: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of f32 bits onto int32 (and its own inverse):
    negative floats get their magnitude bits flipped, so -0.0 maps to -1,
    just below +0.0's 0."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _quiet(bits: torch.Tensor) -> torch.Tensor:
    return bits | _QUIET_BIT


def _row_order_sums(seg: torch.Tensor, val: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """f32 sum per segment, each segment's rows added in row order from
    +0.0 (`val` holds the in-range rows, already flushed; `counts` the rows
    per segment): the rows sorted stably by segment, then one fold per
    segment (ops/segsum.py; the hand kernel on the card)."""
    order = torch.sort(seg, stable=True).indices
    # int32 offsets where the rows fit: half the kernel's offset bytes
    dtype = torch.int32 if val.numel() < 2 ** 31 else torch.int64
    offsets = torch.zeros(counts.numel() + 1, dtype=dtype, device=val.device)
    torch.cumsum(counts, 0, dtype=dtype, out=offsets[1:])
    return segment_row_sum(val[order], offsets)


def _nan_rows(seg: torch.Tensor, val: torch.Tensor, S: int, nan: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per segment: the row (position in `val`) of its last NaN, of its
    first NaN with the sign bit clear, of its first NaN with the sign bit
    set; -1 where there is none."""
    rows = torch.arange(seg.numel(), device=seg.device)
    none = torch.full((S,), seg.numel(), dtype=torch.long, device=seg.device)
    neg = val.view(torch.int32) < 0
    last = torch.full((S,), -1, dtype=torch.long, device=seg.device) \
        .scatter_reduce_(0, seg[nan], rows[nan], "amax")

    def first(sel):
        out = none.scatter_reduce(0, seg[sel], rows[sel], "amin")
        return torch.where(out == seg.numel(), -1, out)

    return last, first(nan & ~neg), first(nan & neg)


def block_partials(keys, ts_rel, value, valid, *, window_ms: int,
                   num_keys: int, n_windows: int, n_blocks: int = 1,
                   device: DeviceLike = "cuda"
                   ) -> Tuple[torch.Tensor, ...]:
    """The grids of `n_blocks` contiguous equal blocks of rows, each
    folded on its own as `windowed_stats` folds a call of that many rows:
    (count int32, sum, min, max f32 bits as int32), each
    [n_blocks * K * W], block b's cells at `b * K * W`. One pass for all
    blocks: a row's segment is offset by its block's cells, so one sort
    and one segment sum serve them all. Cells without rows hold
    count 0 and unspecified bits. The row count must be a multiple of
    `n_blocks`."""
    dev = resolve_device(device)
    K, W = int(num_keys), int(n_windows)
    keys = _as_tensor(keys, torch.int32, dev)
    ts_rel = _as_tensor(ts_rel, torch.int32, dev)
    value = _as_tensor(value, torch.float32, dev)
    valid = _as_tensor(valid, torch.bool, dev)
    rows = value.numel() // n_blocks
    if rows * n_blocks != value.numel():
        raise ValueError(f"{value.numel()} rows do not split into "
                         f"{n_blocks} equal blocks")
    S = n_blocks * K * W
    in_range, seg = _segments(keys, ts_rel, valid, int(window_ms), K, W)
    if n_blocks > 1 and rows:
        block = torch.arange(value.numel(), device=dev) // rows
        seg = seg + block * (K * W)
    seg = seg[in_range]
    raw = value[in_range]
    val = flush_denormals(raw)
    bits = val.view(torch.int32)

    counts = torch.bincount(seg, minlength=S)
    count = counts.to(torch.int32)
    vsum = _row_order_sums(seg, val, counts).view(torch.int32)
    nan = torch.isnan(val)
    keyed = _sortable(bits)
    i32 = torch.iinfo(torch.int32)
    vmin = torch.full((S,), i32.max, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, seg, torch.where(nan, i32.max, keyed), "amin")
    vmax = torch.full((S,), i32.min, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, seg, torch.where(nan, i32.min, keyed), "amax")
    vmin, vmax = _sortable(vmin), _sortable(vmax)
    # a NaN sum with no NaN input came from inf + -inf: XLA's x86 code
    # yields the default NaN there
    vsum = torch.where(torch.isnan(vsum.view(torch.float32)),
                       _X86_DEFAULT_NAN, vsum)
    if bool(nan.any()):
        last, first_pos, first_neg = _nan_rows(seg, val, S, nan)
        has = last >= 0
        pick = bits[last.clamp(min=0)]
        vsum = torch.where(has, _quiet(pick), vsum)
        vmin = torch.where(has, torch.where(
            first_pos >= 0, bits[first_pos.clamp(min=0)], pick), vmin)
        vmax = torch.where(has, torch.where(
            first_neg >= 0, bits[first_neg.clamp(min=0)], pick), vmax)
    if rows == 1 and seg.numel():
        # each block is a lone row: stored as it is where it lands
        raw_bits = raw.view(torch.int32)
        vsum = vsum.index_copy(0, seg, raw_bits)
        vmin = vmin.index_copy(0, seg, raw_bits)
        vmax = vmax.index_copy(0, seg, raw_bits)
    return count, vsum, vmin, vmax


def finalize_mean(count: torch.Tensor, vsum: torch.Tensor) -> torch.Tensor:
    """f32 bits (int32) of `sum / max(count, 1)` as XLA's CPU code divides
    (operands and result flushed; a NaN sum quieted), the canonical NaN
    where count == 0."""
    fsum = vsum.view(torch.float32)
    mean = flush_denormals(flush_denormals(fsum) /
                           torch.clamp(count, min=1).to(torch.float32))
    mean = torch.where(torch.isnan(fsum), _quiet(vsum),
                       mean.view(torch.int32))
    return torch.where(count == 0, _CANONICAL_NAN, mean)


def windowed_stats(keys, ts_rel, value, valid, *, window_ms: int,
                   num_keys: int, n_windows: int,
                   device: DeviceLike = "cuda") -> WindowedStats:
    """count/sum/mean/min/max of `value` per (key, time-bucket).

    Args:
      keys:    int32 [B] dense key indices in [0, num_keys)
      ts_rel:  int  [B] ms relative to the window origin (host-rebased;
               cast to int32 as the reference casts it)
      value:   f32  [B]
      valid:   bool [B]
      window_ms: bucket width (floor division)
      num_keys / n_windows: grid shape
      device:  where the op runs and the grids live
    """
    K, W = int(num_keys), int(n_windows)
    count, vsum, vmin, vmax = block_partials(
        keys, ts_rel, value, valid, window_ms=window_ms, num_keys=K,
        n_windows=W, device=device)
    return grids_of(count, vsum, finalize_mean(count, vsum), vmin, vmax,
                    K, W)


def grids_of(count, vsum, mean, vmin, vmax, K: int, W: int
             ) -> WindowedStats:
    """WindowedStats [K, W] from flat grids (f32 grids as int32 bits);
    min and max take the canonical NaN where count == 0."""
    empty = count == 0
    vmin = torch.where(empty, _CANONICAL_NAN, vmin)
    vmax = torch.where(empty, _CANONICAL_NAN, vmax)

    def grid(t):
        return t.view(torch.float32).reshape(K, W)

    return WindowedStats(count=count.reshape(K, W), sum=grid(vsum),
                         mean=grid(mean), min=grid(vmin), max=grid(vmax))


def event_type_histogram(event_type, ts_rel, valid, *, window_ms: int,
                         n_types: int, n_windows: int,
                         device: DeviceLike = "cuda") -> torch.Tensor:
    """Event counts per (event-type, time-bucket) -> int32 [n_types, W]."""
    dev = resolve_device(device)
    T, W = int(n_types), int(n_windows)
    in_range, seg = _segments(_as_tensor(event_type, torch.int32, dev),
                              _as_tensor(ts_rel, torch.int32, dev),
                              _as_tensor(valid, torch.bool, dev),
                              int(window_ms), T, W)
    return torch.bincount(seg[in_range], minlength=T * W)[:T * W] \
        .to(torch.int32).reshape(T, W)


def dense_key_span(sel: np.ndarray) -> Optional[Tuple[int, int]]:
    """(lo, span) when the presence-table regime applies to these keys:
    integer dtype, and a range either genuinely dense (span <= 4n) or
    bounded by registry capacity with enough rows to amortize the
    span-sized tables. One shared decision for every caller that switches
    between scatter-table and sort-based key handling — the regimes must
    flip together."""
    if sel.size == 0 or not np.issubdtype(sel.dtype, np.integer):
        return None
    lo = int(sel.min())
    span = int(sel.max()) - lo + 1
    n = int(sel.size)
    if span <= 4 * n or (n >= 4096 and span <= (1 << 22)):
        return lo, span
    return None


def compact_keys(raw: np.ndarray,
                 valid: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side key compaction: sparse ids -> dense [0, U) indices.

    Device ids span the full registry capacity; a replay usually touches a
    small subset. Compaction keeps the [K, W] stat grid proportional to the
    keys actually present. Returns (dense_keys, unique_raw_ids); rows not in
    `valid` get key -1 (dropped by the ops' range check).
    """
    raw = np.asarray(raw)
    if valid is None:
        valid = np.ones(len(raw), bool)
    sel = raw[valid]
    if sel.size == 0:
        return np.full(len(raw), -1, np.int32), sel[:0]
    regime = dense_key_span(sel)
    if regime is not None:
        # bounded integer key range (device indices are registry-capacity
        # bounded): a presence table and a remap gather, O(n + span)
        lo, span = regime
        present = np.zeros(span, bool)
        present[sel - lo] = True
        uniq_off = np.nonzero(present)[0]
        remap = np.full(span, -1, np.int32)
        remap[uniq_off] = np.arange(len(uniq_off), dtype=np.int32)
        in_range = valid & (raw >= lo) & (raw <= lo + span - 1)
        shifted = np.clip(raw - lo, 0, span - 1)
        dense = np.where(in_range, remap[shifted], -1).astype(np.int32)
        return dense, (uniq_off + lo).astype(raw.dtype)
    # sparse: non-integer keys, tiny row counts, or keys scattered over a
    # huge range
    uniq = np.unique(sel)
    dense = np.searchsorted(uniq, raw).astype(np.int32)
    # searchsorted gives arbitrary in-range slots for absent values; mask them
    dense = np.where(valid & (uniq[np.clip(dense, 0, len(uniq) - 1)] == raw),
                     dense, -1).astype(np.int32)
    return dense, uniq
