"""Wide-row historical event store — the second interchangeable backend
(counterpart of `sitewhere_tpu/persist/widerow.py`).

Reference: the legacy wide-column historical stores — sitewhere-hbase
(`hbase/device/HBaseDeviceEvent.java`: events in time-bucketed wide rows
keyed by assignment + inverted timestamp) and sitewhere-cassandra
(`cassandra/CassandraClient.java`: `events_by_id` / `events_by_*` tables
partitioned by a configurable time bucket) — selectable PER TENANT
against the primary store through `DatastoreConfigurationParser`.

This backend fills that slot with the same interchangeability contract:
`DatastoreConfig(kind="widerow")` gives a tenant an ACID, row-oriented
store instead of the columnar scan log. One sqlite row per event, keyed
by a time bucket (the Cassandra partition analog), secondary indexes on
the reference's query axes (device, assignment, type — the
`events_by_*` tables' role), WAL journaling, and whole-bucket retention
pruning. The trade-off vs the columnar log is honest and deliberate:
transactional durability and indexed point lookups in exchange for scan
bandwidth — the hot analytics path stays on the columnar default unless
a tenant opts out (data-residency, audit tenants, small fleets).

Duck-compatible with ColumnarEventLog's consumer surface
(`EventManagement`, `AnalyticsEngine`, `StreamManager`,
`PersistWorker`): start/stop/flush/flush_tenant, append_events,
append_batch, query, query_columns, count.

Hot-batch rows (MEASUREMENT / LOCATION / ALERT from packed EventBatches)
store typed SQL columns only; control-plane appends additionally keep
the full event document so every event kind round-trips losslessly.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sitewhere_tpu_torch.model.common import SearchCriteria, SearchResults
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert, DeviceEvent, DeviceEventType,
    DeviceLocation, DeviceMeasurement, event_from_dict)
from sitewhere_tpu_torch.persist.eventlog import (
    _ID_PREFIX, _derive_id, DateRangeCriteria, EventFilter)

_SCHEMA_SQL = """
CREATE TABLE IF NOT EXISTS events (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    tenant TEXT NOT NULL,
    bucket INTEGER NOT NULL,
    id TEXT,
    alternate_id TEXT,
    event_type INTEGER NOT NULL,
    device_idx INTEGER NOT NULL DEFAULT 0,
    device_token TEXT,
    assignment_token TEXT,
    customer_id TEXT,
    area_id TEXT,
    asset_id TEXT,
    event_date INTEGER NOT NULL,
    received_date INTEGER NOT NULL,
    mm_idx INTEGER NOT NULL DEFAULT 0,
    mm_name TEXT,
    value REAL NOT NULL DEFAULT 0,
    latitude REAL NOT NULL DEFAULT 0,
    longitude REAL NOT NULL DEFAULT 0,
    elevation REAL NOT NULL DEFAULT 0,
    alert_source INTEGER NOT NULL DEFAULT 0,
    alert_level INTEGER NOT NULL DEFAULT 0,
    alert_type TEXT,
    alert_message TEXT,
    stream_id TEXT,
    sequence_number INTEGER NOT NULL DEFAULT 0,
    originating_event_id TEXT,
    doc TEXT
);
CREATE INDEX IF NOT EXISTS ix_ev_bucket ON events(tenant, bucket);
CREATE INDEX IF NOT EXISTS ix_ev_device
    ON events(tenant, device_token, event_date);
CREATE INDEX IF NOT EXISTS ix_ev_assn
    ON events(tenant, assignment_token, event_date);
CREATE INDEX IF NOT EXISTS ix_ev_type
    ON events(tenant, event_type, event_date);
CREATE INDEX IF NOT EXISTS ix_ev_id ON events(tenant, id);
"""

# filter field -> SQL column for the exact-match predicates
_EQ_COLUMNS = {
    "device_idx": "device_idx",
    "device_token": "device_token",
    "assignment_token": "assignment_token",
    "area_id": "area_id",
    "customer_id": "customer_id",
    "asset_id": "asset_id",
    "id": "id",
    "alternate_id": "alternate_id",
    "mm_name": "mm_name",
    "originating_event_id": "originating_event_id",
    "stream_id": "stream_id",
    "sequence_number": "sequence_number",
}

_I64_NAMES = frozenset({"event_date", "received_date", "sequence_number",
                        "seq", "bucket"})
_I32_NAMES = frozenset({"event_type", "device_idx", "mm_idx",
                        "alert_source", "alert_level"})
_F32_NAMES = frozenset({"value", "latitude", "longitude", "elevation"})

_INSERT_COLS = (
    "tenant", "bucket", "id", "alternate_id", "event_type", "device_idx",
    "device_token", "assignment_token", "customer_id", "area_id",
    "asset_id", "event_date", "received_date", "mm_idx", "mm_name",
    "value", "latitude", "longitude", "elevation", "alert_source",
    "alert_level", "alert_type", "alert_message", "stream_id",
    "sequence_number", "originating_event_id", "doc")
_INSERT_SQL = (f"INSERT INTO events ({', '.join(_INSERT_COLS)}) "
               f"VALUES ({', '.join('?' * len(_INSERT_COLS))})")


class WideRowEventStore:
    """sqlite-backed wide-row event store (HBase/Cassandra historical
    store role), duck-compatible with ColumnarEventLog."""

    kind = "widerow"

    def __init__(self, db_path: Optional[str] = None,
                 bucket_ms: int = 3_600_000):
        self.db_path = db_path
        self.bucket_ms = int(bucket_ms)
        self._lock = threading.RLock()
        if db_path:
            os.makedirs(os.path.dirname(os.path.abspath(db_path)),
                        exist_ok=True)
        self._conn: Optional[sqlite3.Connection] = None
        self._connect()

    def _connect(self) -> None:
        self._conn = sqlite3.connect(self.db_path or ":memory:",
                                     check_same_thread=False)
        self._conn.executescript(_SCHEMA_SQL)
        if self.db_path:
            self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.commit()

    # -- lifecycle (ColumnarEventLog surface) ------------------------------
    def start(self) -> None:
        """Appends commit synchronously — start only reopens a connection
        a prior stop() closed (instance.restart() cycles stop->start)."""
        with self._lock:
            if self._conn is None:
                self._connect()

    def stop(self) -> None:
        with self._lock:
            if self._conn is None:
                return
            self._conn.commit()
            if self.db_path:
                self._conn.close()
                self._conn = None
            # :memory: connections stay open: closing would drop the data
            # across an engine restart (the in-memory columnar log keeps
            # its segments across stop/start the same way)

    def flush(self) -> None:
        # shutdown ordering: lifecycle teardown may flush components in
        # any order — a flush after stop() is a no-op, not an
        # AttributeError (same for the other post-stop guards below)
        with self._lock:
            if self._conn is None:
                return
            self._conn.commit()

    def flush_tenant(self, tenant: str) -> None:
        self.flush()

    # -- ids ---------------------------------------------------------------
    @staticmethod
    def _next_ids(n: int) -> int:
        # one process-wide locked counter SHARED with the columnar log:
        # both stores derive ids as ev-<_ID_PREFIX>-<seq>, so independent
        # counters would mint colliding ids (and the columnar log's
        # structural id matching would then resolve a widerow id to an
        # unrelated event)
        from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
        return ColumnarEventLog._next_ids(n)

    # -- appends -----------------------------------------------------------
    def append_events(self, tenant: str, events: Sequence[DeviceEvent],
                      device_interner=None) -> None:
        """Control-plane append: full document kept per row (lossless for
        every event kind), typed columns mirrored for indexed queries."""
        if not events:
            return
        from sitewhere_tpu_torch.model.common import new_id

        rows = []
        for ev in events:
            doc = ev.to_dict()
            if not doc.get("id"):
                doc["id"] = new_id()
            if isinstance(doc.get("data"), bytes):
                # stream chunks: JSON documents carry the payload hex
                # (decoded back in _materialize)
                doc["data"] = doc["data"].hex()
            idx = 0
            if device_interner is not None and ev.device_id:
                idx = max(0, int(device_interner.lookup(ev.device_id)))
            rows.append((
                tenant, int(ev.event_date) // self.bucket_ms,
                doc["id"], ev.alternate_id or None,
                int(ev.event_type.value), idx,
                ev.device_id or None, ev.device_assignment_id or None,
                ev.customer_id or None, ev.area_id or None,
                ev.asset_id or None, int(ev.event_date),
                int(ev.received_date or ev.event_date),
                0, getattr(ev, "name", None),
                float(getattr(ev, "value", 0.0) or 0.0),
                float(getattr(ev, "latitude", 0.0) or 0.0),
                float(getattr(ev, "longitude", 0.0) or 0.0),
                float(getattr(ev, "elevation", 0.0) or 0.0),
                int(getattr(getattr(ev, "source", None), "value", 0) or 0),
                int(getattr(getattr(ev, "level", None), "value", 0) or 0),
                getattr(ev, "type", None),
                getattr(ev, "message", None),
                getattr(ev, "stream_id", None),
                int(getattr(ev, "sequence_number", 0) or 0),
                getattr(ev, "originating_event_id", None),
                json.dumps(doc),
            ))
        with self._lock:
            if self._conn is None:
                return  # stopped: late append no-ops (shutdown ordering)
            self._conn.executemany(_INSERT_SQL, rows)
            self._conn.commit()

    def append_batch(self, tenant: str, batch, packer,
                     received_ms: Optional[int] = None,
                     registry=None) -> int:
        """Hot-path append from a packed EventBatch: one transaction per
        batch, typed columns only (no per-row document). Same unique-
        device context resolution as the columnar log so index-based list
        queries behave identically."""
        valid = np.asarray(batch.valid)
        n = int(valid.sum())
        if n == 0:
            return 0
        sel = np.nonzero(valid)[0]
        device_idx = np.asarray(batch.device_idx)[sel]
        event_type = np.asarray(batch.event_type)[sel]
        ts = np.add(np.asarray(batch.ts)[sel], packer.epoch_base_ms,
                    dtype=np.int64)
        mm_idx = np.asarray(batch.mm_idx)[sel]
        value = np.asarray(batch.value)[sel]
        lat = np.asarray(batch.lat)[sel]
        lon = np.asarray(batch.lon)[sel]
        elevation = np.asarray(batch.elevation)[sel]
        alert_level = np.asarray(batch.alert_level)[sel]
        alert_type_idx = np.asarray(batch.alert_type_idx)[sel]
        now = received_ms if received_ms is not None \
            else int(time.time() * 1000)

        uniq, inverse = np.unique(device_idx, return_inverse=True)
        u_token = [packer.devices.token_of(int(u)) for u in uniq]
        u_assign = [None] * len(uniq)
        u_customer = [None] * len(uniq)
        u_area = [None] * len(uniq)
        u_asset = [None] * len(uniq)
        if registry is not None:
            for j, token in enumerate(u_token):
                device = (registry.get_device_by_token(token)
                          if token else None)
                assignment = (registry.get_active_assignment(device.id)
                              if device is not None else None)
                if assignment is None:
                    continue
                u_assign[j] = assignment.token
                u_customer[j] = assignment.customer_id or None
                u_area[j] = assignment.area_id or None
                u_asset[j] = assignment.asset_id or None

        mm_map = {int(m): (packer.measurements.token_of(int(m)) or None)
                  for m in np.unique(mm_idx)}
        at_names = {int(a): (packer.alert_types.token_of(int(a)) or None)
                    for a in np.unique(alert_type_idx)}

        base = self._next_ids(n)
        bucket_ms = self.bucket_ms
        rows = []
        for i in range(n):
            j = int(inverse[i])
            et = int(event_type[i])
            rows.append((
                tenant, int(ts[i]) // bucket_ms,
                _derive_id(_ID_PREFIX, base + i), None, et,
                int(device_idx[i]), u_token[j], u_assign[j],
                u_customer[j], u_area[j], u_asset[j],
                int(ts[i]), now, int(mm_idx[i]),
                mm_map[int(mm_idx[i])]
                if et == DeviceEventType.MEASUREMENT.value else None,
                float(value[i]), float(lat[i]), float(lon[i]),
                float(elevation[i]), 0, int(alert_level[i]),
                at_names[int(alert_type_idx[i])]
                if et == DeviceEventType.ALERT.value else None,
                None, None, 0, None, None,
            ))
        with self._lock:
            if self._conn is None:
                return 0  # stopped: late append no-ops (shutdown ordering)
            self._conn.executemany(_INSERT_SQL, rows)
            self._conn.commit()
        return n

    # -- queries -----------------------------------------------------------
    @staticmethod
    def _where(tenant: str, flt: EventFilter) -> Tuple[str, list]:
        clauses, params = ["tenant = ?"], [tenant]
        if flt.event_type is not None:
            clauses.append("event_type = ?")
            params.append(int(flt.event_type.value))
        for field, column in _EQ_COLUMNS.items():
            val = getattr(flt, field)
            if val is not None:
                clauses.append(f"{column} = ?")
                params.append(val)
        if flt.start_date is not None:
            clauses.append("event_date >= ?")
            params.append(int(flt.start_date))
        if flt.end_date is not None:
            clauses.append("event_date <= ?")
            params.append(int(flt.end_date))
        return " AND ".join(clauses), params

    def query(self, tenant: str, flt: EventFilter,
              criteria: Optional[SearchCriteria] = None,
              order_by: str = "event_date_desc"
              ) -> SearchResults[DeviceEvent]:
        criteria = criteria or SearchCriteria()
        import dataclasses as _dc
        flt = _dc.replace(flt)
        if isinstance(criteria, DateRangeCriteria):
            if criteria.start_date is not None and flt.start_date is None:
                flt.start_date = criteria.start_date
            if criteria.end_date is not None and flt.end_date is None:
                flt.end_date = criteria.end_date
        where, params = self._where(tenant, flt)
        order = ("sequence_number ASC, seq ASC"
                 if order_by == "sequence_asc"
                 else "event_date DESC, seq DESC")
        with self._lock:
            if self._conn is None:
                return SearchResults(results=[], num_results=0)
            total = self._conn.execute(
                f"SELECT COUNT(*) FROM events WHERE {where}",
                params).fetchone()[0]
            cur = self._conn.execute(
                f"SELECT * FROM events WHERE {where} ORDER BY {order} "
                f"LIMIT ? OFFSET ?",
                params + [criteria.page_size, criteria.offset])
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        events = [self._materialize(dict(zip(names, row))) for row in rows]
        return SearchResults(results=events, num_results=int(total))

    def query_columns(self, tenant: str, flt: EventFilter,
                      names: Sequence[str]) -> Dict[str, np.ndarray]:
        where, params = self._where(tenant, flt)
        cols = ", ".join(names)
        with self._lock:
            rows = ([] if self._conn is None else self._conn.execute(
                f"SELECT {cols} FROM events WHERE {where}",
                params).fetchall())

        def column(i: int, name: str) -> np.ndarray:
            vals = [r[i] for r in rows]
            if name in _I64_NAMES:
                return np.array(vals, dtype=np.int64)
            if name in _I32_NAMES:
                return np.array(vals, dtype=np.int32)
            if name in _F32_NAMES:
                return np.array(vals, dtype=np.float32)
            return np.array(vals, dtype=object)

        return {name: column(i, name) for i, name in enumerate(names)}

    def count(self, tenant: str) -> int:
        with self._lock:
            if self._conn is None:
                return 0
            return self._conn.execute(
                "SELECT COUNT(*) FROM events WHERE tenant = ?",
                (tenant,)).fetchone()[0]

    # -- retention (the time-bucketed layout's point) ----------------------
    def buckets(self, tenant: str) -> List[Tuple[int, int]]:
        """(bucket, rows) pairs, oldest first."""
        with self._lock:
            if self._conn is None:
                return []
            return list(self._conn.execute(
                "SELECT bucket, COUNT(*) FROM events WHERE tenant = ? "
                "GROUP BY bucket ORDER BY bucket", (tenant,)))

    def prune(self, tenant: str, before_ms: int) -> int:
        """Drop every WHOLE bucket strictly older than `before_ms` — the
        wide-row layout's cheap retention path (delete by partition key,
        never row-by-row scans)."""
        cutoff_bucket = int(before_ms) // self.bucket_ms
        with self._lock:
            if self._conn is None:
                return 0
            cur = self._conn.execute(
                "DELETE FROM events WHERE tenant = ? AND bucket < ?",
                (tenant, cutoff_bucket))
            self._conn.commit()
            return cur.rowcount

    # -- materialization ---------------------------------------------------
    @staticmethod
    def _materialize(row: Dict) -> DeviceEvent:
        if row.get("doc"):
            doc = json.loads(row["doc"])
            if isinstance(doc.get("data"), str):
                doc["data"] = bytes.fromhex(doc["data"])
            return event_from_dict(doc)
        etype = DeviceEventType(int(row["event_type"]))
        common = dict(
            id=row["id"] or "", alternate_id=row["alternate_id"] or "",
            event_type=etype, device_id=row["device_token"] or "",
            device_assignment_id=row["assignment_token"] or "",
            customer_id=row["customer_id"] or "",
            area_id=row["area_id"] or "", asset_id=row["asset_id"] or "",
            event_date=int(row["event_date"]),
            received_date=int(row["received_date"]), metadata={})
        if etype == DeviceEventType.LOCATION:
            return DeviceLocation(
                **common, latitude=float(row["latitude"]),
                longitude=float(row["longitude"]),
                elevation=float(row["elevation"]))
        if etype == DeviceEventType.ALERT:
            return DeviceAlert(
                **common, source=AlertSource(int(row["alert_source"])),
                level=AlertLevel(int(row["alert_level"])),
                type=row["alert_type"] or "",
                message=row["alert_message"] or "")
        return DeviceMeasurement(**common, name=row["mm_name"] or "",
                                 value=float(row["value"]))
