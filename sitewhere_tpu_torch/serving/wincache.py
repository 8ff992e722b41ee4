"""Incremental window-grid cache: sealed segments in, `[K, W]` grids out
(counterpart of `sitewhere_tpu/serving/wincache.py`).

tf.data (Murray et al. 2021, PAPERS.md) caches a materialized
intermediate and reuses it across epochs; the dashboard analog is the
finalized window grid reused across polls. A `measurement_windows`-shaped
query with an explicit `[start_ms, end_ms]` range is a pure function of
(filter, grid geometry, log contents) — and the log's sealed segments are
immutable and append-only (persist/eventlog.py), so the grid over sealed
segments `[0, w)` never changes. The cache stores exactly that prefix
grid, keyed by `(retention_epoch, w)`:

  * a repeat query scans only segments sealed since the cached watermark
    plus the unsealed buffer tail, folds the delta with the SAME
    device ops as the engine (analytics/windows.py, on the engine's
    device; the folded cells come back to the host in one copy), and
    merges on the host;
  * count and sum compose by addition, min/max by min/max over +-inf
    empty-cell sentinels — exactly; mean is refinalized as
    sum / max(count, 1) (float sums reassociate across the merge, the
    one documented deviation from a monolithic rescan);
  * invalidation is structural: sealing only appends (the watermark
    advances, the cached prefix stays exact) and retention bumps
    `retention_epoch` (every entry over that log dies). No listener
    plumbing — validity is checked against the log's own snapshot at
    lookup time;
  * the buffered (unsealed, still-growing) tail is folded per query and
    NEVER stored.

Resident bytes (host memory) are LRU-bounded (`max_bytes`) and exported
as `resident_bytes`.

Cacheability guard: rows appended by the control plane may carry
`device_idx == 0` (no interned index); the engine assigns those synthetic
per-token keys from the WHOLE result set, which an incremental fold
cannot reproduce. Any idx-0 row in a scanned range marks the query
uncacheable and the caller falls back to the monolithic engine path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.engine import WindowReport, _pad_pow2
from sitewhere_tpu_torch.analytics.windows import (
    WindowedStats, compact_keys, windowed_stats)
from sitewhere_tpu_torch.device import DeviceLike, own_stream, resolve_device
from sitewhere_tpu_torch.persist.eventlog import EventFilter
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

_COLS = ("device_idx", "event_date", "value", "device_token")


def grid_geometry(start_ms: int, end_ms: int, window_ms: int,
                  max_windows: int) -> int:
    """n_windows for an explicit range — must mirror
    WindowedAnalyticsEngine._build_report exactly."""
    return max(1, min(max_windows, (end_ms - start_ms) // window_ms + 1))


class _Fold:
    """One un-finalized grid: union raw keys (sorted) + composable
    per-(key, window) accumulators. `min`/`max` carry +-inf sentinels in
    empty cells so merges stay exact; NaN appears only at finalize."""

    __slots__ = ("key_ids", "tokens", "count", "sum", "min", "max")

    def __init__(self, key_ids: np.ndarray, tokens: List[str],
                 count: np.ndarray, vsum: np.ndarray, vmin: np.ndarray,
                 vmax: np.ndarray):
        self.key_ids = key_ids
        self.tokens = tokens
        self.count = count
        self.sum = vsum
        self.min = vmin
        self.max = vmax

    @property
    def nbytes(self) -> int:
        return int(self.key_ids.nbytes + self.count.nbytes +
                   self.sum.nbytes + self.min.nbytes + self.max.nbytes) + \
            sum(len(t) for t in self.tokens) + 64

    @classmethod
    def empty(cls, n_windows: int) -> "_Fold":
        shape = (0, n_windows)
        return cls(np.array([], np.int64), [],
                   np.zeros(shape, np.int64),
                   np.zeros(shape, np.float32),
                   np.full(shape, np.inf, np.float32),
                   np.full(shape, -np.inf, np.float32))


def _fold_rows(device_idx: np.ndarray, dates: np.ndarray,
               values: np.ndarray, tokens: np.ndarray, *, t0: int,
               window_ms: int, n_windows: int, device: DeviceLike) -> _Fold:
    """Fold filtered raw rows into a `_Fold` via the shared windowed_stats
    op on `device` (same `_pad_pow2` grid shapes as the engine), on the
    calling thread's own stream; the used [u, n_windows] cells come back
    to the host in one copy."""
    device_idx = device_idx.astype(np.int64, copy=False)
    dense, uniq = compact_keys(device_idx)
    u = len(uniq)
    if u == 0:
        return _Fold.empty(n_windows)
    rel = dates.astype(np.int64) - t0
    buckets = np.where((rel >= 0) & (rel // window_ms < n_windows),
                       rel // window_ms, -1).astype(np.int32)
    K = _pad_pow2(u)
    W = _pad_pow2(int(n_windows))
    device = resolve_device(device)
    with own_stream(device):
        stats = windowed_stats(dense, buckets, values.astype(np.float32),
                               np.ones(len(dense), bool), window_ms=1,
                               num_keys=K, n_windows=W, device=device)
        used = WindowedStats(*(getattr(stats, f)[:u, :n_windows] for f in (
            "count", "sum", "mean", "min", "max"))).to("cpu")
    count = used.count.numpy().astype(np.int64)
    vsum = used.sum.numpy()
    # re-sentinel the finalized NaNs: empty cells merge as +-inf
    empty = count == 0
    vmin = np.where(empty, np.inf, used.min.numpy()).astype(np.float32)
    vmax = np.where(empty, -np.inf, used.max.numpy()).astype(np.float32)
    # token per unique key from its first-occurrence row
    first = np.full(u, -1, np.int64)
    order = np.argsort(dense, kind="stable")
    pos = dense[order]
    sel = pos >= 0
    # last write wins on reversed order -> first occurrence survives
    first[pos[sel][::-1]] = order[sel][::-1]
    toks = ["" if (r < 0 or tokens[r] is None) else str(tokens[r])
            for r in first.tolist()]
    return _Fold(uniq.astype(np.int64), toks, count, vsum, vmin, vmax)


def _merge(a: _Fold, b: _Fold) -> _Fold:
    """Exact composition of two folds over disjoint row sets."""
    if len(a.key_ids) == 0:
        return b
    if len(b.key_ids) == 0:
        return a
    union = np.union1d(a.key_ids, b.key_ids)
    u, w = len(union), a.count.shape[1]
    pa = np.searchsorted(union, a.key_ids)
    pb = np.searchsorted(union, b.key_ids)
    count = np.zeros((u, w), np.int64)
    vsum = np.zeros((u, w), np.float32)
    vmin = np.full((u, w), np.inf, np.float32)
    vmax = np.full((u, w), -np.inf, np.float32)
    count[pa] = a.count
    vsum[pa] = a.sum
    vmin[pa] = a.min
    vmax[pa] = a.max
    count[pb] += b.count
    vsum[pb] += b.sum
    vmin[pb] = np.minimum(vmin[pb], b.min)
    vmax[pb] = np.maximum(vmax[pb], b.max)
    tokens = [""] * u
    for p, t in zip(pa.tolist(), a.tokens):
        tokens[p] = t
    for p, t in zip(pb.tolist(), b.tokens):
        if not tokens[p]:
            tokens[p] = t
    return _Fold(union.astype(np.int64), tokens, count, vsum, vmin, vmax)


def _finalize(fold: _Fold, *, t0: int, window_ms: int,
              n_windows: int):
    """Fold -> WindowReport, matching the engine's padded-grid layout
    (rows past num_keys unused, mean/min/max NaN where count == 0)."""
    u = len(fold.key_ids)
    if u == 0:
        empty = WindowedStats(*(torch.zeros((0, 0), dtype=d) for d in (
            torch.int32, torch.float32, torch.float32, torch.float32,
            torch.float32)))
        return WindowReport(t0_ms=t0, window_ms=window_ms, n_windows=0,
                            key_ids=np.array([], object), key_tokens=[],
                            stats=empty)
    K = _pad_pow2(u)
    W = _pad_pow2(int(n_windows))
    count = np.zeros((K, W), np.int32)
    vsum = np.zeros((K, W), np.float32)
    mean = np.zeros((K, W), np.float32)
    vmin = np.zeros((K, W), np.float32)
    vmax = np.zeros((K, W), np.float32)
    count[:u, :n_windows] = fold.count
    vsum[:u, :n_windows] = fold.sum
    cells = fold.count > 0
    mean[:u, :n_windows] = np.where(
        cells, fold.sum / np.maximum(fold.count, 1), np.nan)
    vmin[:u, :n_windows] = np.where(cells, fold.min, np.nan)
    vmax[:u, :n_windows] = np.where(cells, fold.max, np.nan)
    mean[:u, n_windows:] = np.nan
    vmin[:u, n_windows:] = np.nan
    vmax[:u, n_windows:] = np.nan
    mean[u:] = np.nan
    vmin[u:] = np.nan
    vmax[u:] = np.nan
    stats = WindowedStats(*(torch.from_numpy(g) for g in (
        count, vsum, mean, vmin, vmax)))
    return WindowReport(t0_ms=t0, window_ms=window_ms,
                        n_windows=int(n_windows),
                        key_ids=fold.key_ids.copy(),
                        key_tokens=list(fold.tokens), stats=stats)


class _Entry:
    __slots__ = ("fold", "epoch", "watermark")

    def __init__(self, fold: _Fold, epoch: int, watermark: int):
        self.fold = fold
        self.epoch = epoch
        self.watermark = watermark


def _gather(segments, flt: EventFilter
            ) -> Optional[Tuple[np.ndarray, ...]]:
    """Concatenated (device_idx, event_date, value, device_token) over the
    given immutable segments — the lock-free half of a snapshot scan.
    Returns None when an idx-0 row makes the range uncacheable."""
    parts: Dict[str, List[np.ndarray]] = {n: [] for n in _COLS}
    for seg in segments:
        if seg is None or seg.n == 0:
            continue
        if flt.start_date is not None and seg.max_date < flt.start_date:
            continue
        if flt.end_date is not None and seg.min_date > flt.end_date:
            continue
        idx = np.nonzero(flt._mask(seg.cols))[0]
        if not len(idx):
            continue
        dev = np.asarray(seg.cols["device_idx"][idx])
        if (dev == 0).any():
            return None
        parts["device_idx"].append(dev)
        for name in _COLS[1:]:
            parts[name].append(np.asarray(seg.cols[name][idx]))
    if not parts["device_idx"]:
        return (np.array([], np.int64), np.array([], np.int64),
                np.array([], np.float32), np.array([], object))
    return tuple(np.concatenate(parts[n]) for n in _COLS)


class WindowGridCache:
    """LRU byte-budgeted store of sealed-prefix window grids.

    One instance serves every tenant (keys embed the tenant); `query()`
    is thread-safe — folds run outside the lock, only the LRU map and
    byte accounting are guarded."""

    def __init__(self, max_bytes: int = 64 << 20, registry=None):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        m = registry or GLOBAL_METRICS
        self.hit_counter = m.counter("query.cache_hit")
        self.miss_counter = m.counter("query.cache_miss")
        self.evict_counter = m.counter("query.cache_evict")

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def invalidate(self, tenant: Optional[str] = None) -> int:
        """Drop entries (one tenant's, or all). Returns entries dropped."""
        with self._lock:
            if tenant is None:
                n = len(self._entries)
                self._entries.clear()
                self._bytes = 0
                return n
            dead = [k for k in self._entries if k[0] == tenant]
            for k in dead:
                self._bytes -= self._entries.pop(k).fold.nbytes
            return len(dead)

    def _store(self, key: Tuple, entry: _Entry) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.fold.nbytes
            self._entries[key] = entry
            self._bytes += entry.fold.nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.fold.nbytes
                self.evict_counter.inc()

    def query(self, tlog, *, tenant: str, flt: EventFilter, window_ms: int,
              start_ms: int, end_ms: int, max_windows: int,
              device: DeviceLike = "cuda"):
        """Serve one cacheable windowed query from `tlog`
        (persist/eventlog.py TenantEventLog). Returns
        `(WindowReport, info)` or None when the scanned rows are
        uncacheable (idx-0 rows) — the caller falls back to the
        monolithic engine path. Delta folds run on `device`."""
        device = resolve_device(device)
        n_windows = grid_geometry(start_ms, end_ms, window_ms, max_windows)
        key = (tenant, int(window_ms), int(start_ms), int(end_ms),
               int(n_windows), flt.event_type, flt.mm_name, flt.area_id,
               flt.device_token, flt.assignment_token, flt.customer_id,
               flt.asset_id)
        epoch, segments, pending = tlog.sealed_snapshot()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and (entry.epoch != epoch or
                                      entry.watermark > len(segments)):
                self._bytes -= entry.fold.nbytes
                del self._entries[key]
                entry = None
            if entry is not None:
                self._entries.move_to_end(key)
        hit = entry is not None
        base = entry.watermark if hit else 0
        delta_segments = segments[base:]
        delta = _gather(delta_segments, flt)
        if delta is None:
            return None
        delta_rows = len(delta[0])
        fold = entry.fold if hit else _Fold.empty(n_windows)
        if delta_rows:
            fold = _merge(fold, _fold_rows(
                delta[0], delta[1], delta[2], delta[3], t0=start_ms,
                window_ms=window_ms, n_windows=n_windows, device=device))
        if delta_rows or not hit or entry.watermark < len(segments):
            self._store(key, _Entry(fold, epoch, len(segments)))
        # the unsealed tail: folded into the RESULT only, never stored
        tail = _gather([pending], flt)
        if tail is None:
            return None
        tail_rows = len(tail[0])
        result = fold
        if tail_rows:
            result = _merge(result, _fold_rows(
                tail[0], tail[1], tail[2], tail[3], t0=start_ms,
                window_ms=window_ms, n_windows=n_windows, device=device))
        (self.hit_counter if hit else self.miss_counter).inc()
        report = _finalize(result, t0=start_ms, window_ms=window_ms,
                           n_windows=n_windows)
        return report, {
            "cache_hit": hit,
            "delta_segments": len(delta_segments),
            "delta_rows": delta_rows + tail_rows,
            "watermark": len(segments),
            "epoch": epoch,
        }
