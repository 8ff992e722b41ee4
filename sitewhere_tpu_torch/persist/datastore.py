"""Per-tenant datastore configuration: the DatastoreConfigurationParser role.

Reference: tenants choose their event store via configuration
(sitewhere-configuration/src/main/java/com/sitewhere/configuration/datastore/
DatastoreConfigurationParser.java — mongodb/influxdb/cassandra/hbase per
tenant). This framework has ONE storage engine (the columnar Arrow/Parquet
event log — the answer here to all four reference stores), so the
per-tenant choice becomes: which *instance* of it, where it spills, how it
buffers, and whether it persists at all:

- kind "columnar": dedicated ColumnarEventLog for the tenant with its own
  spill dir / segment size / linger (isolation, per-tenant retention).
- kind "memory": dedicated in-memory log, never touches disk (dev/test or
  data-residency-restricted tenants).
- kind "widerow": the SECOND interchangeable historical backend
  (`persist/widerow.py` — the sitewhere-hbase/cassandra wide-column
  store role): ACID sqlite rows in time buckets, indexed on the
  reference's query axes, whole-bucket retention pruning.
- no override: the tenant shares the instance's default log (the default
  single-store deployment).

Configuration sources, in priority order: explicit overrides passed by the
operator (config model `event_management.tenant_datastore` elements) and
`datastore.*` keys in the tenant's metadata (tenant templates can set them
— the analogue of the reference's per-tenant ZK config).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog

_KINDS = ("columnar", "memory", "widerow")


@dataclass
class DatastoreConfig:
    """One tenant's event-store choice."""

    kind: str = "columnar"           # "columnar" | "memory" | "widerow"
    data_dir: Optional[str] = None   # spill dir; relative = under base dir
    segment_rows: int = 65536
    linger_ms: int = 250
    spill: bool = True
    bucket_ms: int = 3_600_000       # widerow time-bucket width

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown datastore kind {self.kind!r} (one of {_KINDS})")

    @classmethod
    def from_metadata(cls, metadata: Dict[str, str]
                      ) -> Optional["DatastoreConfig"]:
        """Build from `datastore.*` tenant-metadata keys; None when the
        tenant doesn't customize (shares the instance default)."""
        keys = {k: v for k, v in (metadata or {}).items()
                if k.startswith("datastore.")}
        if not keys:
            return None
        return cls(
            kind=keys.get("datastore.kind", "columnar"),
            data_dir=keys.get("datastore.data_dir") or None,
            segment_rows=int(keys.get("datastore.segment_rows", 65536)),
            linger_ms=int(keys.get("datastore.linger_ms", 250)),
            spill=keys.get("datastore.spill", "true").lower()
            in ("1", "true", "yes", "on"),
            bucket_ms=int(keys.get("datastore.bucket_ms", 3_600_000)))


class TenantDatastoreManager:
    """Resolves each tenant to its event log and owns the dedicated ones.

    The instance's shared default log is NOT owned here (the instance
    starts/stops it); dedicated per-tenant logs are created lazily on first
    resolution and lifecycle-managed by this manager.
    """

    def __init__(self, default_log: ColumnarEventLog,
                 base_dir: Optional[str] = None,
                 overrides: Optional[Dict[str, DatastoreConfig]] = None):
        self.default_log = default_log
        self.base_dir = base_dir
        self.overrides: Dict[str, DatastoreConfig] = dict(overrides or {})
        # ColumnarEventLog or WideRowEventStore (duck-compatible surface)
        self._dedicated: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._started = False

    def register_override(self, tenant_token: str,
                          config: DatastoreConfig) -> None:
        """Operator-level override (config model tenant_datastore element).
        Takes effect on the tenant's next resolution (engine restart)."""
        with self._lock:
            self.overrides[tenant_token] = config

    def config_for(self, tenant) -> Optional[DatastoreConfig]:
        """tenant: token string or Tenant model object."""
        token = getattr(tenant, "token", tenant)
        with self._lock:
            if token in self.overrides:
                return self.overrides[token]
        return DatastoreConfig.from_metadata(
            getattr(tenant, "metadata", None) or {})

    def event_log_for(self, tenant):
        """The tenant's event store: the shared default ColumnarEventLog,
        or a dedicated columnar/memory/widerow store (duck-compatible)."""
        token = getattr(tenant, "token", tenant)
        config = self.config_for(tenant)
        if config is None:
            return self.default_log
        with self._lock:
            log = self._dedicated.get(token)
            if log is None:
                log = self._build(token, config)
                self._dedicated[token] = log
                if self._started:
                    log.start()
            return log

    def _build(self, token: str, config: DatastoreConfig):
        from urllib.parse import quote

        if config.kind == "widerow":
            from sitewhere_tpu_torch.persist.widerow import WideRowEventStore

            db_path = config.data_dir
            if db_path is None and self.base_dir:
                stores = os.path.join(self.base_dir, "tenant-stores")
                db_path = os.path.join(
                    stores, quote(token, safe="") + ".widerow.db")
            elif db_path is not None and not os.path.isabs(db_path) \
                    and self.base_dir:
                db_path = os.path.join(self.base_dir, db_path)
            return WideRowEventStore(db_path=db_path,
                                     bucket_ms=config.bucket_ms)
        data_dir = None
        if config.kind == "columnar":
            data_dir = config.data_dir
            if data_dir is None:
                # percent-encode: "a/b" and "a_b" are distinct tenants and
                # must not share a spill directory
                if self.base_dir:
                    stores = os.path.join(self.base_dir, "tenant-stores")
                    data_dir = os.path.join(stores, quote(token, safe=""))
                    # migrate a directory created by the pre-encoding
                    # underscore scheme so its data stays visible
                    legacy = os.path.join(stores, token.replace("/", "_"))
                    if (legacy != data_dir and os.path.isdir(legacy)
                            and not os.path.exists(data_dir)):
                        try:
                            os.rename(legacy, data_dir)
                        except OSError:
                            pass  # fall through: fresh dir
            elif not os.path.isabs(data_dir) and self.base_dir:
                data_dir = os.path.join(self.base_dir, data_dir)
        return ColumnarEventLog(data_dir=data_dir,
                                segment_rows=config.segment_rows,
                                linger_ms=config.linger_ms,
                                spill_parquet=config.spill)

    def dedicated_tenants(self) -> Dict[str, str]:
        """token -> kind, for topology/observability."""
        def kind(log) -> str:
            explicit = getattr(log, "kind", None)
            if explicit:
                return explicit
            return "columnar" if log._data_dir else "memory"

        with self._lock:
            return {tok: kind(log)
                    for tok, log in self._dedicated.items()}

    # -- lifecycle (instance calls these around its own) -------------------
    def start(self) -> None:
        with self._lock:
            self._started = True
            logs = list(self._dedicated.values())
        for log in logs:
            log.start()

    def stop(self) -> None:
        with self._lock:
            self._started = False
            logs = list(self._dedicated.values())
        for log in logs:
            log.stop()

    def flush(self) -> None:
        with self._lock:
            logs = list(self._dedicated.values())
        for log in logs:
            log.flush()
