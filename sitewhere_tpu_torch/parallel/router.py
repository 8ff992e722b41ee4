"""Host-side shard routing: global device index -> (shard, local index).

Counterpart of `sitewhere_tpu/parallel/router.py`. Global interned index d
maps to shard `d % S` with local row `d // S`; each shard's state rows are
indexed by local rows, so a shard only touches its own devices and the
step needs no cross-shard traffic for state updates, only stat sums.

`route_blob` routes a flat wire blob into the `[S, rows, B]` layout in one
pass of the native host library (`native.route_blob`); `route_blob_plain`
is its numpy plain version (the tests and chip_smoke.py hold the two
against each other). `route_batch` packs and routes a flat batch in one
native pass (`native.pack_route_blob`). `route_columns` turns flat event
columns into `[S, B]` columns. Rows past a shard's fixed capacity come back
as overflow (flat row indices, or a flat batch, in arrival order) for the
caller to requeue.

Host batches here hold numpy arrays (a router's arenas and overflow
slices, as the reference's do) or CPU tensors (the packer's); every reader
goes through `np.asarray`, which reads both without a copy.

Pooled staging buffers are the reference's loan contract (`staging_ring`
> 0): a buffer returns to the pool only when its borrower releases it,
with a guard (a CUDA event) that proves its H2D copy finished. The engine
turns pooling on only on the card; on the CPU the "transfer" may alias the
host buffer, as the reference's cpu backend does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.ops.pack import _BASE_LANES, EventBatch

# the packed 3-row wire embeds its ts base in 11 row-0 lanes PER SHARD:
# routed layouts need at least that per-shard width
_ROUTABLE_PACKED_MIN = _BASE_LANES



def routable_variant(rows: int, ts_base: int, per_shard_batch: int):
    """(wire rows, ts base) of a routed layout: the packed variant
    downgrades to compact when the PER-SHARD width cannot hold the
    lane-embedded ts base (11 lanes). A feeder's remote pack of a sharded
    engine's blob (feeders/worker.py) downgrades as the inline path
    does."""
    from sitewhere_tpu_torch.ops.pack import (
        WIRE_ROWS_COMPACT, WIRE_ROWS_PACKED)

    if rows == WIRE_ROWS_PACKED and per_shard_batch < _ROUTABLE_PACKED_MIN:
        return WIRE_ROWS_COMPACT, 0
    return rows, ts_base


_I32_COLS = ("device_idx", "tenant_idx", "event_type", "ts", "mm_idx",
             "alert_type_idx", "alert_level")
_F32_COLS = ("value", "lat", "lon", "elevation")


@dataclass
class RoutedBatches:
    batch: EventBatch                    # columns shaped [S, B_local]
    overflow: Optional[EventBatch]       # flat batch of rows past a shard's
    #                                      capacity (global indices, no
    #                                      padding) — requeued next round

    @property
    def overflow_count(self) -> int:
        return 0 if self.overflow is None else int(
            np.asarray(self.overflow.valid).sum())


def concat_flat_batches(batches: List[EventBatch]) -> EventBatch:
    """Concatenate flat (1-D column) batches, keeping only valid rows."""
    keeps = [np.asarray(b.valid) for b in batches]
    cols = {}
    for name in _I32_COLS + _F32_COLS:
        cols[name] = np.concatenate(
            [np.asarray(getattr(b, name))[k] for b, k in zip(batches, keeps)])
    n = len(cols["device_idx"])
    return EventBatch(valid=np.ones(n, bool), **cols)


class FlatBatchArena:
    """Reusable flat-column staging for the overflow-requeue merge: one set
    of flat column buffers (grown geometrically, never shrunk) that `concat`
    writes the merged valid rows into; the returned EventBatch holds views
    into the arena, valid until the next `concat`."""

    def __init__(self):
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._ones: Optional[np.ndarray] = None
        self._cap = 0

    def _ensure(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(n, 2 * self._cap, 1024)
        self._cols = {name: np.empty(cap, np.int32) for name in _I32_COLS}
        self._cols.update(
            {name: np.empty(cap, np.float32) for name in _F32_COLS})
        self._ones = np.ones(cap, bool)
        self._cap = cap

    def concat(self, batches: List[EventBatch]) -> EventBatch:
        """Valid rows of `batches`, in order, as views into the arena."""
        keeps = []
        n = 0
        for b in batches:
            valid = np.asarray(b.valid)
            rows = None if valid.all() else np.nonzero(valid)[0]
            k = valid.shape[0] if rows is None else len(rows)
            keeps.append((rows, k))
            n += k
        self._ensure(n)
        for name in _I32_COLS + _F32_COLS:
            dst = self._cols[name]
            pos = 0
            for b, (rows, k) in zip(batches, keeps):
                col = np.asarray(getattr(b, name))
                if rows is None:
                    dst[pos:pos + k] = col
                elif col.dtype == dst.dtype:
                    np.take(col, rows, out=dst[pos:pos + k])
                else:  # odd caller-supplied dtype: cast through a gather
                    dst[pos:pos + k] = col[rows]
                pos += k
        return EventBatch(
            valid=self._ones[:n],
            **{name: self._cols[name][:n] for name in _I32_COLS + _F32_COLS})


class ShardRouter:
    def __init__(self, n_shards: int, per_shard_batch: int,
                 staging_ring: int = 0):
        self.n_shards = n_shards
        self.per_shard_batch = per_shard_batch
        # loaned staging buffers (see the module docstring): free lists per
        # layout key under ONE bound of `staging_ring` buffers, entries
        # (buffer, guard) FIFO; 0 turns pooling off
        self.staging_ring = staging_ring
        self._pools: Dict[object, List[tuple]] = {}
        self._pool_lock = threading.Lock()
        # route_columns arenas: a ring of 2 [S, B] column sets, so the
        # previous returned batch stays intact while the next one routes
        self._col_arenas: Optional[List[Dict[str, np.ndarray]]] = None
        self._col_arena_pos = 0
        self._scratch_i: Optional[np.ndarray] = None
        self._scratch_f: Optional[np.ndarray] = None
        # pinned host allocator for pooled buffers (the engine sets it on
        # the card: pinned pages make the H2D copy asynchronous)
        self.alloc = np.empty
        # a pinned wire layout (a cluster host pins the full one, so every
        # host captures the same program); None picks it per batch
        self.fixed_wire_rows: Optional[int] = None

    # -- loaned staging buffers ---------------------------------------------

    def _buf_key(self, buf: np.ndarray):
        """Pool key: wire rows for routed [S, rows, B] blobs, ("flat",
        rows) for unrouted [rows, S*B] flat blobs."""
        if (buf.ndim == 3 and buf.shape[0] == self.n_shards
                and buf.shape[2] == self.per_shard_batch):
            return buf.shape[1]
        if (buf.ndim == 2
                and buf.shape[1] == self.n_shards * self.per_shard_batch):
            return ("flat", buf.shape[0])
        return None

    def _free_count(self) -> int:
        return sum(len(p) for p in self._pools.values())

    def _staging_buffer(self, rows: int) -> Optional[np.ndarray]:
        return self._pool_get(
            rows, (self.n_shards, rows, self.per_shard_batch))

    def flat_staging_buffer(self, rows: int) -> Optional[np.ndarray]:
        """Pooled UNROUTED flat staging blob [rows, S*B] for the device
        route (same loan and guard contract as the routed buffers)."""
        return self._pool_get(
            ("flat", rows), (rows, self.n_shards * self.per_shard_batch))

    def _pool_get(self, key, shape) -> Optional[np.ndarray]:
        if self.staging_ring <= 0:
            return None
        with self._pool_lock:
            pool = self._pools.setdefault(key, [])
            if not pool:
                return self.alloc(shape, np.int32)
            buf, guard = pool.pop(0)
        if guard is not None:
            # the buffer's H2D copy may still be reading it
            guard.synchronize()
        return buf

    def release_staging_buffer(self, buf: np.ndarray, guard=None) -> None:
        """Return a loaned blob to the free pool. ONE bound across layouts:
        when full, a free buffer of another layout is evicted in favour of
        this one; otherwise the extra drops to the garbage collector.
        `guard`: an event whose completion proves the blob's H2D copy
        finished."""
        if self.staging_ring <= 0:
            return
        key = self._buf_key(buf)
        if key is None:
            return
        with self._pool_lock:
            if self._free_count() >= self.staging_ring:
                other = next(
                    (pool for variant, pool in self._pools.items()
                     if variant != key and pool), None)
                if other is None:
                    return
                other.pop(0)
            self._pools.setdefault(key, []).append((buf, guard))

    # -- routing ---------------------------------------------------------------

    def route_batch(self, batch: EventBatch
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused pack + route: flat EventBatch columns -> ([S, rows, B]
        routed blob, overflow flat-row indices) in one native pass into a
        pooled staging buffer (on loan when pooling is on). The layout is
        the batch's smallest, downgraded from packed when a shard's width
        cannot carry the ts base."""
        from sitewhere_tpu_torch import native
        from sitewhere_tpu_torch.ops.pack import (
            _check_device_range, wire_variant_for)

        if self.fixed_wire_rows is not None:
            rows, ts_base = self.fixed_wire_rows, 0
        else:
            rows, ts_base = self._routable_variant(*wire_variant_for(batch))
        out = self._staging_buffer(rows)
        res = native.pack_route_blob(batch, self.n_shards,
                                     self.per_shard_batch, out=out,
                                     wire_rows=rows, ts_base=ts_base)
        if res is not None:
            return res
        if out is not None:
            self.release_staging_buffer(out)
        _check_device_range(np.asarray(batch.device_idx, np.int32))
        raise RuntimeError("the native pack refused a batch whose device "
                           "indices are in range")

    def _routable_variant(self, rows: int, ts_base: int):
        return routable_variant(rows, ts_base, self.per_shard_batch)

    def global_to_local(self, device_idx: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        return device_idx % self.n_shards, device_idx // self.n_shards

    def local_to_global(self, shard: int, local_idx: np.ndarray) -> np.ndarray:
        return local_idx * self.n_shards + shard

    def shard_param(self, arr: np.ndarray) -> np.ndarray:
        """Re-lay a device-indexed [D, ...] array into [S, D//S, ...] so that
        row (s, l) holds global row l*S + s. D must be divisible by S."""
        arr = np.asarray(arr)
        D = arr.shape[0]
        S = self.n_shards
        if D % S:
            raise ValueError(f"device capacity {D} not divisible by {S} shards")
        return np.ascontiguousarray(
            arr.reshape((D // S, S) + arr.shape[1:]).swapaxes(0, 1))

    def unshard_param(self, arr: np.ndarray) -> np.ndarray:
        """Inverse of shard_param: [S, D//S, ...] -> [D, ...]."""
        arr = np.asarray(arr)
        S, L = arr.shape[0], arr.shape[1]
        return np.ascontiguousarray(
            arr.swapaxes(0, 1).reshape((S * L,) + arr.shape[2:]))

    def _check_routable(self, blob) -> None:
        from sitewhere_tpu_torch.ops.pack import WIRE_ROWS_PACKED

        if np.asarray(blob).shape[-2] == WIRE_ROWS_PACKED \
                and self.per_shard_batch < _ROUTABLE_PACKED_MIN:
            raise ValueError(
                f"packed 3-row blobs need a per-shard width of at least "
                f"{_ROUTABLE_PACKED_MIN} lanes to carry the lane-embedded "
                f"ts base (per_shard_batch={self.per_shard_batch}); route "
                f"a classic-layout blob instead")

    def route_blob(self, blob: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Route a flat wire blob [rows, n] into ([S, rows, B] routed blob,
        overflow flat-row indices in arrival order), in one native pass
        (host_runtime.cc swt_route_blob)."""
        from sitewhere_tpu_torch import native

        self._check_routable(blob)
        return native.route_blob(blob, self.n_shards, self.per_shard_batch)

    def route_blob_plain(self, blob: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The numpy plain version of route_blob: the same blob and
        overflow, byte for byte (the blob rows routed the way
        route_columns routes the columns)."""
        from sitewhere_tpu_torch.ops.pack import (
            _BASE_SHIFT, _VALID_SHIFT, WIRE_DEV_MAX, WIRE_ROWS_PACKED,
            _embed_ts_base, _extract_ts_base_np)

        self._check_routable(blob)
        S, B = self.n_shards, self.per_shard_batch
        blob = np.asarray(blob, np.int32)
        wire_rows, n = blob.shape
        head = blob[0]
        # packed blobs carry the ts base by LANE POSITION in row 0's spare
        # bits: lift it, strip the spare bits from every routed head (zero
        # on 4/5-row blobs), re-embed per shard after
        packed = wire_rows == WIRE_ROWS_PACKED
        base = int(_extract_ts_base_np(head)) if packed else 0
        valid = (head & (1 << _VALID_SHIFT)) != 0
        rows = None if valid.all() else np.nonzero(valid)[0]
        dev = (head if rows is None else head[rows]) & (WIRE_DEV_MAX - 1)
        ksorted, kept, over_rows = self._shard_sort(dev, rows)
        kstarts = np.zeros(S + 1, np.int64)
        np.cumsum(kept, out=kstarts[1:])
        out = self._staging_buffer(wire_rows)
        if out is None:
            out = np.empty((S, wire_rows, B), np.int32)
        ghead = head[ksorted]
        gdev = ghead & (WIRE_DEV_MAX - 1)
        spare_clear = np.int32((1 << _BASE_SHIFT) - 1)
        ghead = (ghead & ~np.int32(WIRE_DEV_MAX - 1)
                 & spare_clear) | (gdev // S)
        self._place_sorted(out[:, 0, :], ghead, kept, kstarts)
        for r in range(1, wire_rows):
            self._place_sorted(out[:, r, :], blob[r][ksorted], kept, kstarts)
        if packed:
            _embed_ts_base(out[:, 0, :], base)
        return out, over_rows

    # -- the shared shard-bucketing core ------------------------------------

    def _shard_sort(self, dev: np.ndarray, rows: Optional[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stable shard bucketing of the valid flat rows. `dev` holds the
        global device index of each valid row; `rows` maps them to flat
        positions (None: all rows valid, in place). Returns (ksorted, kept,
        over_rows): flat indices in shard-major arrival order truncated to
        per-shard capacity, each shard's kept count, and the overflow's
        flat indices in arrival order."""
        S, B = self.n_shards, self.per_shard_batch
        shard = dev % S
        if S <= (1 << 8):
            shard = shard.astype(np.uint8)
        elif S <= (1 << 16):
            shard = shard.astype(np.uint16)
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=S).astype(np.int64)
        kept = np.minimum(counts, B)
        base = order if rows is None else rows[order]
        if int(counts.max(initial=0)) <= B:
            return base, kept, np.empty(0, np.int64)
        starts = np.zeros(S + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = (np.arange(len(order), dtype=np.int64)
               - np.repeat(starts[:-1], counts))
        keep = pos < B
        return base[keep], kept, np.sort(base[~keep])

    @staticmethod
    def _place_sorted(dst: np.ndarray, gathered: np.ndarray,
                      kept: np.ndarray, kstarts: np.ndarray) -> None:
        """Fill [S, B] `dst` from shard-major-sorted rows: one contiguous
        copy per shard plus a zeroed tail."""
        for s in range(dst.shape[0]):
            c = kept[s]
            row = dst[s]
            row[:c] = gathered[kstarts[s]:kstarts[s] + c]
            row[c:] = 0

    def _next_column_arena(self) -> Dict[str, np.ndarray]:
        if self._col_arenas is None:
            S, B = self.n_shards, self.per_shard_batch

            def alloc():
                cols = {name: np.empty((S, B), np.int32)
                        for name in _I32_COLS}
                cols.update({name: np.empty((S, B), np.float32)
                             for name in _F32_COLS})
                cols["valid"] = np.empty((S, B), bool)
                return cols

            self._col_arenas = [alloc(), alloc()]
        arena = self._col_arenas[self._col_arena_pos]
        self._col_arena_pos = (self._col_arena_pos + 1) % len(self._col_arenas)
        return arena

    def _gather_scratch(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._scratch_i is None or self._scratch_i.shape[0] < n:
            cap = max(n, 4096)
            self._scratch_i = np.empty(cap, np.int32)
            self._scratch_f = np.empty(cap, np.float32)
        return self._scratch_i, self._scratch_f

    def route_columns(self, batch: EventBatch) -> RoutedBatches:
        """Scatter a flat host batch into per-shard sub-batches with local
        device indices: one stable bucketing pass, then one contiguous
        per-shard copy per column into a reused arena (intact until the
        second-next route_columns on this router). Arrival order per
        device is kept; rows past a shard's capacity come back as
        `overflow` (flat, global indices, arrival order)."""
        S, B = self.n_shards, self.per_shard_batch
        valid = np.asarray(batch.valid)
        if valid.all():
            rows = None
            dev = np.asarray(batch.device_idx)
        else:
            rows = np.nonzero(valid)[0]
            dev = np.asarray(batch.device_idx)[rows]
        ksorted, kept, over_rows = self._shard_sort(dev, rows)
        k = len(ksorted)
        kstarts = np.zeros(S + 1, np.int64)
        np.cumsum(kept, out=kstarts[1:])
        arena = self._next_column_arena()
        scratch_i, scratch_f = self._gather_scratch(k)

        def gathered(name: str, scratch: np.ndarray) -> np.ndarray:
            col = np.asarray(getattr(batch, name))
            if col.dtype == scratch.dtype:
                return np.take(col, ksorted, out=scratch[:k])
            return col[ksorted]  # odd caller-supplied dtype: plain gather

        gdev = gathered("device_idx", scratch_i)
        np.floor_divide(gdev, S, out=gdev)          # global -> local rows
        self._place_sorted(arena["device_idx"], gdev, kept, kstarts)
        for name in _I32_COLS[1:]:
            self._place_sorted(arena[name], gathered(name, scratch_i),
                               kept, kstarts)
        for name in _F32_COLS:
            self._place_sorted(arena[name], gathered(name, scratch_f),
                               kept, kstarts)
        out_valid = arena["valid"]
        for s in range(S):
            out_valid[s, :kept[s]] = True
            out_valid[s, kept[s]:] = False
        routed = EventBatch(**arena)

        overflow = None
        if len(over_rows):
            ocols = {name: np.asarray(getattr(batch, name))[over_rows]
                     for name in _I32_COLS + _F32_COLS}
            overflow = EventBatch(valid=np.ones(len(over_rows), bool),
                                  **ocols)
        return RoutedBatches(batch=routed, overflow=overflow)
