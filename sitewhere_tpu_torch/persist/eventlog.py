"""Append-only columnar event log: the event store (counterpart of
`sitewhere_tpu/persist/eventlog.py`; Parquet segments load in either package).

Reference: the MongoDB event store with its bulk-insert buffer
(service-event-management/…/mongodb/MongoDeviceEventManagement.java:65,
DeviceEventBuffer.java:34 — 10k queue, batched writer thread, 200/chunk,
250 ms linger) and the time-bucketed Cassandra/HBase event tables.

Design: events on the hot path already live as SoA columns
(ops/pack.py EventBatch), so the store keeps them columnar end to end:

  append (columns or API objects) -> in-memory column buffer
    -> background flusher (chunk size + linger, like DeviceEventBuffer)
    -> immutable Arrow record-batch segment, optionally spilled to Parquet

Queries run as vectorized predicate scans over segments (numpy masks over
column arrays), newest
first with offset/limit paging, and materialize model dataclasses only for
the requested page. Analytics reads the raw
columns without materialization.

One unified nullable schema covers every DeviceEventType — the same trade
the reference's GDeviceEventPayload union makes, resolved as nullable
columns instead of a protobuf oneof.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import threading
import time
import uuid
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import pyarrow as pa
import pyarrow.parquet as pq

from sitewhere_tpu_torch.model.common import (
    DateRangeCriteria, SearchCriteria, SearchResults, new_id)
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, CommandInitiator, CommandTarget, DeviceAlert,
    DeviceCommandInvocation, DeviceCommandResponse, DeviceEvent,
    DeviceEventType, DeviceLocation, DeviceMeasurement, DeviceStateChange,
    DeviceStreamData)

# Unified event schema. String/object fields are nullable; numeric hot-path
# columns are dense. `device_idx`/`mm_idx`/`alert_type_idx` mirror the interned
# tensor indices so analytics can go straight back to tensors.
_SCHEMA = pa.schema([
    ("id", pa.string()),
    # Hot-path rows carry (id_prefix, id_seq) instead of a per-row id string:
    # building 131k formatted strings per batch was 70%+ of append_batch's
    # cost. The string id is derived on read (`_derive_id`); `id` stays for
    # control-plane events with caller-chosen ids.
    ("id_prefix", pa.string()),
    ("id_seq", pa.int64()),
    ("alternate_id", pa.string()),
    ("event_type", pa.int32()),
    ("device_idx", pa.int32()),
    ("device_token", pa.string()),
    ("assignment_token", pa.string()),
    ("customer_id", pa.string()),
    ("area_id", pa.string()),
    ("asset_id", pa.string()),
    ("event_date", pa.int64()),      # absolute ms
    ("received_date", pa.int64()),   # absolute ms
    ("mm_idx", pa.int32()),
    ("mm_name", pa.string()),
    ("value", pa.float32()),
    ("latitude", pa.float32()),
    ("longitude", pa.float32()),
    ("elevation", pa.float32()),
    ("alert_source", pa.int32()),
    ("alert_level", pa.int32()),
    ("alert_type_idx", pa.int32()),
    ("alert_type", pa.string()),
    ("alert_message", pa.string()),
    ("initiator", pa.int32()),
    ("initiator_id", pa.string()),
    ("target", pa.int32()),
    ("target_id", pa.string()),
    ("command_token", pa.string()),
    ("parameters", pa.string()),     # json map
    ("originating_event_id", pa.string()),
    ("response_event_id", pa.string()),
    ("response", pa.string()),
    ("attribute", pa.string()),
    ("state_type", pa.string()),
    ("previous_state", pa.string()),
    ("new_state", pa.string()),
    ("stream_id", pa.string()),
    ("sequence_number", pa.int64()),
    ("stream_data", pa.binary()),
    ("metadata", pa.string()),       # json map
])

_COLUMNS = [f.name for f in _SCHEMA]
_ID_PREFIX = uuid.uuid4().hex[:10]  # process-unique; see append_batch ids
_INT_COLS = {f.name for f in _SCHEMA if pa.types.is_integer(f.type)}
_FLOAT_COLS = {f.name for f in _SCHEMA if pa.types.is_floating(f.type)}
_I64_COLS = ("event_date", "received_date", "sequence_number", "id_seq")

_ID_RE = re.compile(r"ev-([0-9a-f]{10})-([0-9a-f]{12})")

# interner -> (length-at-snapshot, object-array snapshot); see resolve()
_SNAPSHOT_CACHE = weakref.WeakKeyDictionary()


def _snapshot_array(interner) -> np.ndarray:
    # Keyed on the interner's mutation version (not its length: a
    # checkpoint restore can swap same-length contents).
    version = getattr(interner, "version", None)
    if version is None:  # foreign interner-like object: don't cache
        return np.array(interner.snapshot(), dtype=object)
    cached = _SNAPSHOT_CACHE.get(interner)
    if cached is not None and cached[0] == version:
        return cached[1]
    snap = np.array(interner.snapshot(), dtype=object)
    _SNAPSHOT_CACHE[interner] = (version, snap)
    return snap


def _derive_id(prefix: str, seq: int) -> str:
    return f"ev-{prefix}-{seq:012x}"


@dataclass
class EventFilter:
    """Predicate for event queries (the reference's per-index list rpcs +
    ISearchCriteria date range, device-event-management.proto:37-93)."""

    event_type: Optional[DeviceEventType] = None
    device_idx: Optional[int] = None
    device_token: Optional[str] = None
    assignment_token: Optional[str] = None
    area_id: Optional[str] = None
    customer_id: Optional[str] = None
    asset_id: Optional[str] = None
    start_date: Optional[int] = None   # ms, inclusive
    end_date: Optional[int] = None     # ms, inclusive
    id: Optional[str] = None
    alternate_id: Optional[str] = None
    mm_name: Optional[str] = None
    originating_event_id: Optional[str] = None
    stream_id: Optional[str] = None
    sequence_number: Optional[int] = None

    def _mask(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(cols["event_date"])
        mask = np.ones(n, bool)
        if self.event_type is not None:
            mask &= cols["event_type"] == int(self.event_type)
        if self.sequence_number is not None:
            mask &= cols["sequence_number"] == self.sequence_number
        if self.device_idx is not None:
            mask &= cols["device_idx"] == self.device_idx
        if self.start_date is not None:
            mask &= cols["event_date"] >= self.start_date
        if self.end_date is not None:
            mask &= cols["event_date"] <= self.end_date
        if self.id is not None:
            id_mask = cols["id"] == self.id
            m = _ID_RE.fullmatch(self.id)
            if m is not None:  # derived hot-path id: match (prefix, seq)
                id_mask |= ((cols["id_prefix"] == m.group(1))
                            & (cols["id_seq"] == int(m.group(2), 16)))
            mask &= id_mask
        for attr, col in (("device_token", "device_token"),
                          ("assignment_token", "assignment_token"),
                          ("area_id", "area_id"),
                          ("customer_id", "customer_id"),
                          ("asset_id", "asset_id"),
                          ("alternate_id", "alternate_id"),
                          ("mm_name", "mm_name"),
                          ("originating_event_id", "originating_event_id"),
                          ("stream_id", "stream_id")):
            want = getattr(self, attr)
            if want is not None:
                val = cols[col]
                mask &= (val.eq_mask(want)
                         if isinstance(val, _LazyTokenCol) else val == want)
        return mask


class _Segment:
    """Immutable flushed chunk: numpy column dict + min/max skip-index over
    event_date and device_idx for segment pruning (the reference's Cassandra
    time buckets serve the same skip-scan purpose for time;
    device-partitioned logs additionally skip on the device range)."""

    __slots__ = ("cols", "n", "min_date", "max_date", "min_dev", "max_dev")

    def __init__(self, cols: Dict[str, np.ndarray]):
        self.cols = cols
        self.n = len(cols["event_date"])
        dates = cols["event_date"]
        self.min_date = int(dates.min()) if self.n else 0
        self.max_date = int(dates.max()) if self.n else 0
        devs = cols["device_idx"]
        self.min_dev = int(devs.min()) if self.n else 0
        self.max_dev = int(devs.max()) if self.n else 0

    def to_arrow(self) -> pa.Table:
        arrays = []
        for fld in _SCHEMA:
            col = self.cols[fld.name]
            if isinstance(col, _LazyTokenCol):
                # spill runs on the linger thread, off the append hot path
                col = col.materialize()
            if _is_const(col) and _const_value(col) is None:
                arrays.append(pa.nulls(len(col), type=fld.type))
            elif _is_const(col):
                arrays.append(pa.array(list(col), type=fld.type))
            elif fld.name == "stream_data":
                arrays.append(pa.array(list(col), type=pa.binary()))
            else:
                arrays.append(pa.array(col, type=fld.type))
        return pa.Table.from_arrays(arrays, schema=_SCHEMA)

    @classmethod
    def from_arrow(cls, table: pa.Table) -> "_Segment":
        # schema evolution: parquet written by an older build lacks newer
        # columns (e.g. id_prefix/id_seq) — start from defaults, overwrite
        # with whatever the file has
        cols = _full_cols(table.num_rows, const_strings=True)
        names = set(table.column_names)
        for fld in _SCHEMA:
            if fld.name not in names:
                continue
            arr = table.column(fld.name)
            if fld.name in _INT_COLS or fld.name in _FLOAT_COLS:
                np_dtype = arr.type.to_pandas_dtype()
                cols[fld.name] = np.asarray(
                    arr.fill_null(0).to_numpy(zero_copy_only=False),
                    dtype=np_dtype)
            elif arr.null_count == len(arr):
                cols[fld.name] = _const_col(table.num_rows)
            else:
                cols[fld.name] = np.asarray(arr.to_pylist(), dtype=object)
        return cls(cols)


def _merge_col(parts: List[np.ndarray]) -> np.ndarray:
    """Concatenate column chunks, keeping const views const (merging
    all-None const columns must not materialize the 8n bytes a const view
    exists to avoid) and lazy token chunks lazy when they share one
    dictionary snapshot (the steady-state ingest case: the interner is not
    growing, so `_snapshot_array` hands every chunk the same cached
    array). Mixed or differing-snapshot chunks materialize — a restore can
    swap same-length interner contents, so identity is the only safe
    fast-path key."""
    if len(parts) == 1:
        return parts[0]
    if any(isinstance(p, _LazyTokenCol) for p in parts):
        first = next(p for p in parts if isinstance(p, _LazyTokenCol))
        if all(isinstance(p, _LazyTokenCol) and p.snap is first.snap
               for p in parts):
            return _LazyTokenCol(np.concatenate([p.idx for p in parts]),
                                 first.snap)
        parts = [p.materialize() if isinstance(p, _LazyTokenCol) else p
                 for p in parts]
    if all(_is_const(p) for p in parts):
        shared = next((_const_value(p) for p in parts if len(p)), None)
        if all(len(p) == 0 or _const_value(p) is shared for p in parts):
            return _const_col(sum(len(p) for p in parts), shared)
    return np.concatenate(parts)


class _ColumnBuffer:
    """Mutable append buffer; column-major lists of row-chunks."""

    def __init__(self) -> None:
        self.chunks: List[Dict[str, np.ndarray]] = []
        self.n = 0
        self._peek_cache: Optional[Tuple[int, _Segment]] = None

    def append(self, cols: Dict[str, np.ndarray], n: int) -> None:
        self.chunks.append(cols)
        self.n += n

    def _merge(self) -> Dict[str, np.ndarray]:
        return {name: _merge_col([c[name] for c in self.chunks])
                for name in _COLUMNS}

    def drain(self) -> Optional[_Segment]:
        if not self.chunks:
            return None
        cached = self._peek_cache
        seg = (cached[1] if cached is not None and cached[0] == len(self.chunks)
               else _Segment(self._merge()))
        self.chunks = []
        self.n = 0
        self._peek_cache = None
        return seg

    def peek(self) -> Optional[_Segment]:
        """Transient view of buffered rows for scans — does NOT seal a
        segment, so trickle-rate tenants don't fragment the log. The merged
        view is cached until the next append (chunk count is the version:
        chunks are append-only), so repeated analytics replays don't pay
        the column merge each query."""
        if not self.chunks:
            return None
        cached = self._peek_cache
        if cached is not None and cached[0] == len(self.chunks):
            return cached[1]
        seg = _Segment(self._merge())
        self._peek_cache = (len(self.chunks), seg)
        return seg


class _LazyTokenCol:
    """Dictionary-encoded token column: row i reads `snap[idx[i]]` (None
    when the index is out of the snapshot's range or the reserved slot 0 —
    exactly `TokenInterner.token_of` semantics).

    The append hot path stores only the (already-materialized) int32 index
    column plus a reference to the interner's cached snapshot; the object
    column of Python strings materializes lazily — at Parquet spill (linger
    thread), or per-row/per-page at query time. Building those strings
    eagerly was >40% of `append_batch` cost at the 131k production batch,
    paid for rows whose tokens nobody ever reads (VERDICT r5 item 2: the
    sustained-system rate was persist-bound). Supports exactly the access
    patterns the log uses: len, scalar/fancy indexing, equality masking
    (on the int dictionary — cheaper than string compares), merge, and
    full materialization."""

    __slots__ = ("idx", "snap", "_mat")
    dtype = np.dtype(object)

    def __init__(self, idx: np.ndarray, snap: np.ndarray):
        self.idx = idx
        self.snap = snap
        self._mat: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.idx)

    def materialize(self) -> np.ndarray:
        if self._mat is None:
            clipped = np.clip(self.idx, 0, len(self.snap) - 1)
            out = self.snap[clipped]
            out[(self.idx <= 0) | (self.idx >= len(self.snap))] = None
            self._mat = out
        return self._mat

    def __getitem__(self, key):
        if self._mat is not None:
            return self._mat[key]
        if isinstance(key, (int, np.integer)):
            i = int(self.idx[key])
            return self.snap[i] if 0 < i < len(self.snap) else None
        sub = self.idx[key]
        clipped = np.clip(sub, 0, len(self.snap) - 1)
        out = self.snap[clipped]
        out[(sub <= 0) | (sub >= len(self.snap))] = None
        return out

    def eq_mask(self, want) -> np.ndarray:
        """Boolean column == `want`, computed as integer compares against
        the dictionary instead of n string compares."""
        hits = np.nonzero(self.snap == want)[0]
        hits = hits[hits > 0]
        if len(hits) == 0:
            return np.zeros(len(self.idx), bool)
        if len(hits) == 1:
            return self.idx == hits[0]
        return np.isin(self.idx, hits)


def _obj_col(n: int, value: Any = None) -> np.ndarray:
    out = np.empty(n, object)
    out[:] = value
    return out


def _const_col(n: int, value: Any = None) -> np.ndarray:
    """All-`value` object column as a stride-0 broadcast view: 8 bytes of
    storage instead of 8n. Appending 131k-row batches was dominated by
    page-faulting ~20 fresh 1MB all-None object arrays per batch (cost grows
    with process RSS); a read-only view sidesteps the allocation entirely.
    Reads (fancy indexing, ==, scalar access) behave like a real column."""
    base = np.empty((), object)
    base[()] = value
    return np.broadcast_to(base, (n,))


def _const_value(col: np.ndarray) -> Any:
    """The shared value of a stride-0 const column (None for empty)."""
    return col[0] if len(col) else None


def _is_const(col: np.ndarray) -> bool:
    return (isinstance(col, np.ndarray) and col.dtype == object
            and col.ndim == 1 and col.strides == (0,))


def _full_cols(n: int, const_strings: bool = False,
               **given: np.ndarray) -> Dict[str, np.ndarray]:
    """Build a complete column dict; unspecified columns default to 0/None.
    `const_strings=True` makes defaulted object columns read-only const
    views (hot path); leave False when rows are filled in afterwards."""
    cols: Dict[str, np.ndarray] = {}
    for name in _COLUMNS:
        if name in given:
            cols[name] = given[name]
        elif name in _INT_COLS:
            cols[name] = np.zeros(n, np.int64 if name in _I64_COLS
                                  else np.int32)
        elif name in _FLOAT_COLS:
            cols[name] = np.zeros(n, np.float32)
        elif const_strings:
            cols[name] = _const_col(n)
        else:
            cols[name] = _obj_col(n)
    return cols


class TenantEventLog:
    """One tenant's log: buffer + segments (+ optional Parquet spill dir)."""

    def __init__(self, tenant: str, data_dir: Optional[str],
                 segment_rows: int, spill: bool):
        self.tenant = tenant
        self.segment_rows = segment_rows
        self._buffer = _ColumnBuffer()
        self._segments: List[_Segment] = []
        self._seg_paths: List[Optional[str]] = []
        self._lock = threading.Lock()
        # Bumped whenever sealed segments are REMOVED (retention). Sealing
        # only appends, so `(retention_epoch, len(_segments))` is a
        # monotonic watermark within an epoch: anything cached over sealed
        # segments [0, n) stays exact until the epoch changes
        # (serving/wincache.py keys its grids on this pair).
        self.retention_epoch = 0
        self._dir = None
        self._spill = spill and data_dir is not None
        self._next_seg = 0
        if data_dir is not None:
            self._dir = os.path.join(data_dir, tenant.replace("/", "_"))
            os.makedirs(self._dir, exist_ok=True)
            # record the TRUE tenant name: reload keys tenants by it, not by
            # the sanitized directory name (they differ for e.g. "acme/eu")
            name_path = os.path.join(self._dir, "_tenant.name")
            if not os.path.exists(name_path):
                with open(name_path, "w", encoding="utf-8") as fh:
                    fh.write(tenant)
            self._load()

    def _load(self) -> None:
        # sweep orphaned .tmp spills first: a crash mid-seal leaves a
        # partial `events-N.parquet.tmp` that must never be read — and
        # must not survive to confuse a later crash's triage either
        for name in os.listdir(self._dir):
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self._dir, name))
                except OSError:
                    pass
        names = sorted(f for f in os.listdir(self._dir)
                       if f.endswith(".parquet"))
        for name in names:
            path = os.path.join(self._dir, name)
            try:
                seg = _Segment.from_arrow(pq.read_table(path))
            except Exception:
                # a sealed segment that no longer parses (torn pre-fsync
                # write, bit rot): quarantine instead of poisoning boot;
                # its rows are rebuildable from the bus log (at-least-once)
                logging.getLogger("sitewhere.eventlog").exception(
                    "quarantining unreadable segment %s", path)
                try:
                    os.replace(path, path + ".quarantine")
                except OSError:
                    pass
                continue
            self._segments.append(seg)
            self._seg_paths.append(path)
            seq = int(name.split("-")[1].split(".")[0])
            self._next_seg = max(self._next_seg, seq + 1)

    def append(self, cols: Dict[str, np.ndarray], n: int) -> None:
        """Buffer only — never touches disk, so the ingest hot path pays a
        list append. Sealing happens on the linger thread (flush_if_full) or
        an explicit flush(); scans see buffered rows via peek()."""
        with self._lock:
            self._buffer.append(cols, n)

    def flush_if_full(self) -> None:
        """Seal only when a full segment's worth is buffered — the linger
        loop calls this, so trickle-rate appends never fragment into tiny
        parquet files. Durability for the un-sealed tail rides the event bus
        log (at-least-once replay rebuilds it), the same trade the reference
        makes with DeviceEventBuffer's in-memory 10k queue."""
        self._seal(only_if_full=True)

    def flush(self) -> None:
        self._seal(only_if_full=False)

    def _seal(self, only_if_full: bool) -> None:
        """Drain buffer -> immutable segment under the lock; write Parquet
        OUTSIDE the lock so concurrent appends/scans never stall on disk."""
        with self._lock:
            if only_if_full and self._buffer.n < self.segment_rows:
                return
            seg = self._buffer.drain()
            if seg is None:
                return
            self._segments.append(seg)
            path = None
            if self._spill:
                path = os.path.join(self._dir,
                                    f"events-{self._next_seg:06d}.parquet")
                self._next_seg += 1
            self._seg_paths.append(path)
        if path is not None:
            from sitewhere_tpu_torch.persist.atomic import fsync_dir, fsync_file

            tmp = path + ".tmp"
            pq.write_table(seg.to_arrow(), tmp)
            # fsync BEFORE the rename: without it a crash can leave a
            # renamed-but-empty parquet that poisons the next boot
            fsync_file(tmp)
            os.replace(tmp, path)
            fsync_dir(self._dir)

    def scan(self, flt: EventFilter) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """Yield (cols, selected_row_indices) per segment, newest segment
        first (global ordering is the caller's job — see query())."""
        with self._lock:
            segments = list(self._segments)
            pending = self._buffer.peek()
        if pending is not None:
            segments.append(pending)
        for seg in reversed(segments):
            if flt.start_date is not None and seg.max_date < flt.start_date:
                continue
            if flt.end_date is not None and seg.min_date > flt.end_date:
                continue
            if flt.device_idx is not None and not (
                    seg.min_dev <= flt.device_idx <= seg.max_dev):
                continue
            idx = np.nonzero(flt._mask(seg.cols))[0]
            if len(idx):
                yield seg.cols, idx

    def count(self) -> int:
        with self._lock:
            return self._buffer.n + sum(s.n for s in self._segments)

    def sealed_snapshot(self) -> Tuple[int, List[_Segment],
                                       Optional[_Segment]]:
        """`(retention_epoch, sealed_segments, pending)` under one lock
        acquisition. Segments are immutable and the list is append-only
        within an epoch, so a reader can fold the snapshot lock-free while
        appends/seals proceed — the snapshot-isolation contract the
        serving tier's cache and delta scans are built on. `pending` is
        the buffered (unsealed, still-growing) tail; it must be re-read
        per query, never cached."""
        with self._lock:
            return (self.retention_epoch, list(self._segments),
                    self._buffer.peek())

    def estimate_rows(self, flt: EventFilter) -> int:
        """Upper-bound row count a scan of `flt` would touch, from the
        per-segment skip index alone — O(segments), no column reads. The
        query planner routes host-vs-mesh on this estimate."""
        with self._lock:
            segments = list(self._segments)
            pending_n = self._buffer.n
        n = pending_n
        for seg in segments:
            if flt.start_date is not None and seg.max_date < flt.start_date:
                continue
            if flt.end_date is not None and seg.min_date > flt.end_date:
                continue
            if flt.device_idx is not None and not (
                    seg.min_dev <= flt.device_idx <= seg.max_dev):
                continue
            n += seg.n
        return n

    def retain_max_segments(self, keep: int) -> int:
        """Drop the OLDEST sealed segments past `keep` (retention). Bumps
        `retention_epoch` so every cached grid over this log invalidates;
        parquet spills are unlinked outside the lock. Returns segments
        dropped."""
        keep = max(0, int(keep))
        with self._lock:
            drop = len(self._segments) - keep
            if drop <= 0:
                return 0
            dropped_paths = self._seg_paths[:drop]
            self._segments = self._segments[drop:]
            self._seg_paths = self._seg_paths[drop:]
            self.retention_epoch += 1
        for path in dropped_paths:
            if path is not None:
                try:
                    os.remove(path)
                except OSError:
                    pass
        return drop

    def _id_segments(self) -> List[Dict[str, np.ndarray]]:
        with self._lock:
            segments = list(self._segments)
            pending = self._buffer.peek()
        if pending is not None:
            segments.append(pending)
        return [seg.cols for seg in segments]

    def sequence_watermarks(self) -> Dict[str, int]:
        """Per `id_prefix` max `id_seq` over this tenant's rows (buffered
        + sealed). Each prefix is one process incarnation, each seq is
        monotonic within it, so the map is a compact high-watermark of
        everything this log has materialized — the instance checkpoint
        captures it next to the bus offsets (persist/checkpoint.py) and
        the replay barrier suppresses re-emission below it."""
        marks: Dict[str, int] = {}
        for cols in self._id_segments():
            prefixes = np.asarray(cols["id_prefix"], dtype=object)
            seqs = cols["id_seq"]
            for prefix in set(prefixes.tolist()):
                if prefix is None:
                    continue  # legacy rows without sequence identity
                top = int(seqs[prefixes == prefix].max())
                if top > marks.get(prefix, -1):
                    marks[prefix] = top
        return marks

    def rows_above(self, marks: Dict[str, int]) -> int:
        """Count rows whose (id_prefix, id_seq) lies ABOVE `marks` — at
        restore, with `marks` from the checkpoint manifest, this is the
        already-durable replay overlap (rows the retained log will
        re-offer past the saved offsets), i.e. the tenant's replay
        barrier budget."""
        n = 0
        for cols in self._id_segments():
            prefixes = np.asarray(cols["id_prefix"], dtype=object)
            seqs = cols["id_seq"]
            for prefix in set(prefixes.tolist()):
                if prefix is None:
                    continue
                sel = seqs[prefixes == prefix]
                n += int((sel > marks.get(prefix, -1)).sum())
        return n


class ColumnarEventLog:
    """Multi-tenant event store facade.

    Appends accept either packed `EventBatch` columns (hot path — vectorized,
    no per-event Python) or model dataclasses (control plane). Both land in
    the same unified schema.
    """

    def __init__(self, data_dir: Optional[str] = None,
                 segment_rows: int = 65536, linger_ms: int = 250,
                 spill_parquet: bool = True):
        self._data_dir = data_dir
        self._segment_rows = segment_rows
        self._linger_ms = linger_ms
        self._spill = spill_parquet
        self._tenants: Dict[str, TenantEventLog] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            for name in sorted(os.listdir(data_dir)):
                tdir = os.path.join(data_dir, name)
                if not os.path.isdir(tdir):
                    continue
                name_path = os.path.join(tdir, "_tenant.name")
                if os.path.exists(name_path):
                    with open(name_path, encoding="utf-8") as fh:
                        name = fh.read().strip() or name
                self._tenants[name] = TenantEventLog(
                    name, data_dir, segment_rows, spill_parquet)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the linger flusher (DeviceEventBuffer.java:99 writer thread)."""
        if self._flusher is None:
            self._stop.clear()
            self._flusher = threading.Thread(
                target=self._linger_loop, name="eventlog-flusher", daemon=True)
            self._flusher.start()

    def _linger_loop(self) -> None:
        while not self._stop.wait(self._linger_ms / 1000.0):
            for log in self._tenant_list():
                log.flush_if_full()

    def stop(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        self.flush()

    def flush(self) -> None:
        for log in self._tenant_list():
            log.flush()

    def _tenant_list(self) -> List[TenantEventLog]:
        with self._lock:
            return list(self._tenants.values())

    def tenant(self, tenant: str) -> TenantEventLog:
        """Write-path accessor: creates the tenant log (and its directory)."""
        with self._lock:
            if tenant not in self._tenants:
                self._tenants[tenant] = TenantEventLog(
                    tenant, self._data_dir, self._segment_rows, self._spill)
            return self._tenants[tenant]

    def tenant_if_exists(self, tenant: str) -> Optional[TenantEventLog]:
        """Read-path accessor: never creates phantom tenants on disk."""
        with self._lock:
            return self._tenants.get(tenant)

    def flush_tenant(self, tenant: str) -> None:
        log = self.tenant_if_exists(tenant)
        if log is not None:
            log.flush()

    def sequence_watermarks(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant `(id_prefix -> max id_seq)` high-watermarks — the
        checkpoint's exactly-once-effects anchor."""
        return {log.tenant: log.sequence_watermarks()
                for log in self._tenant_list()}

    def rows_above(self, tenant: str, marks: Dict[str, int]) -> int:
        log = self.tenant_if_exists(tenant)
        return 0 if log is None else log.rows_above(marks)

    def estimate_rows(self, tenant: str, flt: EventFilter) -> int:
        """Skip-index scan-size estimate for the query planner (see
        TenantEventLog.estimate_rows)."""
        log = self.tenant_if_exists(tenant)
        return 0 if log is None else log.estimate_rows(flt)

    def retain_max_segments(self, tenant: str, keep: int) -> int:
        """Retention facade: drop a tenant's oldest sealed segments past
        `keep` (bumps that log's retention_epoch — cached grids over it
        invalidate)."""
        log = self.tenant_if_exists(tenant)
        return 0 if log is None else log.retain_max_segments(keep)

    # -- hot-path append ---------------------------------------------------
    def append_batch(self, tenant: str, batch, packer,
                     received_ms: Optional[int] = None, registry=None) -> int:
        """Append the valid rows of a packed EventBatch. Vectorized: device
        tokens (and, when `registry` is given, assignment/area/customer/asset
        context — the GDeviceEventContext fields) are resolved once per
        unique device index, not per row, so index-based list queries work
        identically for hot-path and control-plane events."""
        valid = np.asarray(batch.valid)
        n = int(valid.sum())
        if n == 0:
            return 0
        sel = np.nonzero(valid)[0]
        # fancy-indexing already copies; astype(copy=False) avoids a second
        # copy per column when the dtype already matches (it always does on
        # the hot path — EventBatch columns are i32/f32 by construction)
        device_idx = np.asarray(batch.device_idx)[sel].astype(
            np.int32, copy=False)
        event_type = np.asarray(batch.event_type)[sel].astype(
            np.int32, copy=False)
        ts = np.add(np.asarray(batch.ts)[sel], packer.epoch_base_ms,
                    dtype=np.int64)
        mm_idx = np.asarray(batch.mm_idx)[sel].astype(np.int32, copy=False)
        alert_type_idx = np.asarray(batch.alert_type_idx)[sel].astype(
            np.int32, copy=False)
        now = received_ms if received_ms is not None else int(time.time() * 1000)

        # bulk ids: <process-unique prefix> + <monotonic counter>, stored as
        # (id_prefix, id_seq) columns. The prefix cell is ONE shared Python
        # string (no per-row allocation); the string form "ev-<prefix>-<seq>"
        # is derived on read — formatting 131k id strings per batch was 70%+
        # of append cost. The random prefix keeps ids unique across restarts
        # over the same parquet log.
        base = self._next_ids(n)
        id_seq = np.arange(base, base + n, dtype=np.int64)
        id_prefix = _const_col(n, _ID_PREFIX)

        context_cols: Dict[str, np.ndarray] = {}
        if registry is not None:
            # one lookup per unique device, then a vectorized gather through
            # an inverse index (np.unique is O(n log n), not O(U * n))
            uniq, inverse = np.unique(device_idx, return_inverse=True)
            u_assign = np.array([None] * len(uniq), dtype=object)
            u_customer = np.array([None] * len(uniq), dtype=object)
            u_area = np.array([None] * len(uniq), dtype=object)
            u_asset = np.array([None] * len(uniq), dtype=object)
            for j, u in enumerate(uniq):
                token = packer.devices.token_of(int(u))
                device = registry.get_device_by_token(token) if token else None
                assignment = (registry.get_active_assignment(device.id)
                              if device is not None else None)
                if assignment is None:
                    continue
                u_assign[j] = assignment.token
                u_customer[j] = assignment.customer_id or None
                u_area[j] = assignment.area_id or None
                u_asset[j] = assignment.asset_id or None
            context_cols = dict(assignment_token=u_assign[inverse],
                                customer_id=u_customer[inverse],
                                area_id=u_area[inverse],
                                asset_id=u_asset[inverse])

        cols = _full_cols(
            n,
            const_strings=True,
            id_prefix=id_prefix,
            id_seq=id_seq,
            event_type=event_type,
            device_idx=device_idx,
            # token strings are dictionary-encoded: the idx columns are
            # already selected above, so the string columns cost two
            # pointer stores here and materialize off the hot path
            device_token=_LazyTokenCol(device_idx,
                                       _snapshot_array(packer.devices)),
            event_date=ts,
            received_date=np.full(n, now, np.int64),
            mm_idx=mm_idx,
            mm_name=_LazyTokenCol(mm_idx,
                                  _snapshot_array(packer.measurements)),
            value=np.asarray(batch.value)[sel].astype(np.float32, copy=False),
            latitude=np.asarray(batch.lat)[sel].astype(np.float32, copy=False),
            longitude=np.asarray(batch.lon)[sel].astype(
                np.float32, copy=False),
            elevation=np.asarray(batch.elevation)[sel].astype(
                np.float32, copy=False),
            alert_level=np.asarray(batch.alert_level)[sel].astype(
                np.int32, copy=False),
            alert_type_idx=alert_type_idx,
            alert_type=_LazyTokenCol(alert_type_idx,
                                     _snapshot_array(packer.alert_types)),
            **context_cols,
        )
        self.tenant(tenant).append(cols, n)
        return n

    _id_counter = 0
    _id_lock = threading.Lock()

    @classmethod
    def _next_ids(cls, n: int) -> int:
        with cls._id_lock:
            base = cls._id_counter
            cls._id_counter += n
            return base

    # -- control-plane append ---------------------------------------------
    def append_events(self, tenant: str, events: Sequence[DeviceEvent],
                      device_interner=None) -> None:
        n = len(events)
        if n == 0:
            return
        # control-plane rows carry (id_prefix, id_seq) too — the explicit
        # event id stays authoritative on read, but sequence identity is
        # what the checkpoint watermarks and replay-barrier budgets count,
        # and inbound persist lands here rather than on the packed path
        base = self._next_ids(n)
        cols = _full_cols(n,
                          id_prefix=_const_col(n, _ID_PREFIX),
                          id_seq=np.arange(base, base + n, dtype=np.int64))
        for i, ev in enumerate(events):
            self._fill_row(cols, i, ev, device_interner)
        self.tenant(tenant).append(cols, n)

    @staticmethod
    def _fill_row(cols: Dict[str, np.ndarray], i: int, ev: DeviceEvent,
                  device_interner) -> None:
        cols["id"][i] = ev.id or new_id()
        cols["alternate_id"][i] = ev.alternate_id or None
        cols["event_type"][i] = int(ev.event_type)
        cols["device_token"][i] = ev.device_id or None
        if device_interner is not None and ev.device_id:
            cols["device_idx"][i] = device_interner.lookup(ev.device_id)
        cols["assignment_token"][i] = ev.device_assignment_id or None
        cols["customer_id"][i] = ev.customer_id or None
        cols["area_id"][i] = ev.area_id or None
        cols["asset_id"][i] = ev.asset_id or None
        cols["event_date"][i] = ev.event_date
        cols["received_date"][i] = ev.received_date
        if ev.metadata:
            cols["metadata"][i] = json.dumps(ev.metadata)
        if isinstance(ev, DeviceMeasurement):
            cols["mm_name"][i] = ev.name
            cols["value"][i] = ev.value
        elif isinstance(ev, DeviceLocation):
            cols["latitude"][i] = ev.latitude
            cols["longitude"][i] = ev.longitude
            cols["elevation"][i] = ev.elevation
        elif isinstance(ev, DeviceAlert):
            cols["alert_source"][i] = int(ev.source)
            cols["alert_level"][i] = int(ev.level)
            cols["alert_type"][i] = ev.type or None
            cols["alert_message"][i] = ev.message or None
        elif isinstance(ev, DeviceCommandInvocation):
            cols["initiator"][i] = int(ev.initiator)
            cols["initiator_id"][i] = ev.initiator_id or None
            cols["target"][i] = int(ev.target)
            cols["target_id"][i] = ev.target_id or None
            cols["command_token"][i] = ev.command_token or None
            if ev.parameter_values:
                cols["parameters"][i] = json.dumps(ev.parameter_values)
        elif isinstance(ev, DeviceCommandResponse):
            cols["originating_event_id"][i] = ev.originating_event_id or None
            cols["response_event_id"][i] = ev.response_event_id or None
            cols["response"][i] = ev.response or None
        elif isinstance(ev, DeviceStateChange):
            cols["attribute"][i] = ev.attribute or None
            cols["state_type"][i] = ev.type or None
            cols["previous_state"][i] = ev.previous_state or None
            cols["new_state"][i] = ev.new_state or None
        elif isinstance(ev, DeviceStreamData):
            cols["stream_id"][i] = ev.stream_id or None
            cols["sequence_number"][i] = ev.sequence_number
            cols["stream_data"][i] = ev.data

    # -- query -------------------------------------------------------------
    def query(self, tenant: str, flt: EventFilter,
              criteria: Optional[SearchCriteria] = None,
              order_by: str = "event_date_desc"
              ) -> SearchResults[DeviceEvent]:
        """Globally ordered paged query (default newest-first by event_date
        across ALL segments — late/replayed events interleave correctly),
        materializing dataclasses only for the requested page.

        `order_by`: "event_date_desc" | "sequence_asc" (stream reassembly).
        The caller's filter is never mutated."""
        criteria = criteria or SearchCriteria()
        flt = dataclasses.replace(flt)
        if isinstance(criteria, DateRangeCriteria):
            if criteria.start_date is not None and flt.start_date is None:
                flt.start_date = criteria.start_date
            if criteria.end_date is not None and flt.end_date is None:
                flt.end_date = criteria.end_date
        tlog = self.tenant_if_exists(tenant)
        matches: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = \
            list(tlog.scan(flt)) if tlog is not None else []
        if not matches:
            return SearchResults(results=[], num_results=0)
        key_col = ("sequence_number" if order_by == "sequence_asc"
                   else "event_date")
        keys = np.concatenate([cols[key_col][idx] for cols, idx in matches])
        order = np.argsort(keys, kind="stable")
        if order_by != "sequence_asc":
            # descending; reversing the stable ascending order also puts the
            # latest-appended event first among same-millisecond ties
            order = order[::-1]
        total = len(order)
        skip = criteria.offset
        page = order[skip:skip + criteria.page_size]
        # map flat positions back to (segment, row)
        bounds = np.cumsum([0] + [len(idx) for _, idx in matches])
        events: List[DeviceEvent] = []
        for pos in page:
            seg_i = int(np.searchsorted(bounds, pos, side="right") - 1)
            cols, idx = matches[seg_i]
            events.append(self._materialize(cols, int(idx[pos - bounds[seg_i]])))
        return SearchResults(results=events, num_results=total)

    def query_columns(self, tenant: str, flt: EventFilter,
                      names: Sequence[str]) -> Dict[str, np.ndarray]:
        """Analytics path: concatenated raw columns for all matching rows —
        no dataclass materialization (feeds windowed tensor reductions)."""
        parts: Dict[str, List[np.ndarray]] = {n: [] for n in names}
        tlog = self.tenant_if_exists(tenant)
        for cols, idx in (tlog.scan(flt) if tlog is not None else ()):
            for n in names:
                parts[n].append(cols[n][idx])

        def empty(name: str) -> np.ndarray:
            fld = _SCHEMA.field(name)
            if name in _INT_COLS or name in _FLOAT_COLS:
                return np.array([], dtype=fld.type.to_pandas_dtype())
            return np.array([], dtype=object)

        return {
            n: (np.concatenate(v) if v else empty(n))
            for n, v in parts.items()
        }

    def count(self, tenant: str) -> int:
        tlog = self.tenant_if_exists(tenant)
        return tlog.count() if tlog is not None else 0

    @staticmethod
    def _materialize(cols: Dict[str, np.ndarray], i: int) -> DeviceEvent:
        etype = DeviceEventType(int(cols["event_type"][i]))

        def s(name: str) -> str:
            v = cols[name][i]
            return "" if v is None else str(v)

        meta = json.loads(s("metadata")) if cols["metadata"][i] else {}
        event_id = cols["id"][i]
        if event_id is None and cols["id_prefix"][i] is not None:
            event_id = _derive_id(cols["id_prefix"][i], int(cols["id_seq"][i]))
        common = dict(
            id=event_id or "", alternate_id=s("alternate_id"), event_type=etype,
            device_id=s("device_token"),
            device_assignment_id=s("assignment_token"),
            customer_id=s("customer_id"), area_id=s("area_id"),
            asset_id=s("asset_id"), event_date=int(cols["event_date"][i]),
            received_date=int(cols["received_date"][i]), metadata=meta)
        if etype == DeviceEventType.MEASUREMENT:
            return DeviceMeasurement(**common, name=s("mm_name"),
                                     value=float(cols["value"][i]))
        if etype == DeviceEventType.LOCATION:
            return DeviceLocation(
                **common, latitude=float(cols["latitude"][i]),
                longitude=float(cols["longitude"][i]),
                elevation=float(cols["elevation"][i]))
        if etype == DeviceEventType.ALERT:
            return DeviceAlert(
                **common, source=AlertSource(int(cols["alert_source"][i])),
                level=AlertLevel(int(cols["alert_level"][i])),
                type=s("alert_type"), message=s("alert_message"))
        if etype == DeviceEventType.COMMAND_INVOCATION:
            params = json.loads(s("parameters")) if cols["parameters"][i] else {}
            return DeviceCommandInvocation(
                **common, initiator=CommandInitiator(int(cols["initiator"][i])),
                initiator_id=s("initiator_id"),
                target=CommandTarget(int(cols["target"][i])),
                target_id=s("target_id"), command_token=s("command_token"),
                parameter_values=params)
        if etype == DeviceEventType.COMMAND_RESPONSE:
            return DeviceCommandResponse(
                **common, originating_event_id=s("originating_event_id"),
                response_event_id=s("response_event_id"),
                response=s("response"))
        if etype == DeviceEventType.STATE_CHANGE:
            return DeviceStateChange(
                **common, attribute=s("attribute"), type=s("state_type"),
                previous_state=s("previous_state"), new_state=s("new_state"))
        data = cols["stream_data"][i]
        return DeviceStreamData(
            **common, stream_id=s("stream_id"),
            sequence_number=int(cols["sequence_number"][i]),
            data=data if isinstance(data, bytes) else b"")
