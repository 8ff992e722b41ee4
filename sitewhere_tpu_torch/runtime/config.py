"""Layered configuration system.

Replaces the reference's ZooKeeper-resident XML + Spring namespace parsers
(sitewhere-configuration ConfigurationContentParser.java, ConfigurationMonitor.java:37-90)
with layered JSON/dict sources: defaults <- instance file <- service section <-
tenant section <- environment variables, plus a watch thread that live-reloads
changed files and fires callbacks (the reference restarts components on ZK
TreeCache change events; here listeners decide what to restart).

Keys are dotted paths, e.g. ``pipeline.batch_size`` or
``tenants.<tenant>.rules.geofence.max_zones``.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional


def _deep_merge(base: Dict, overlay: Dict) -> Dict:
    out = dict(base)
    for key, val in overlay.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = val
    return out


class Configuration:
    """Layered dotted-key configuration with optional file watching."""

    ENV_PREFIX = "SWTPU_"  # SWTPU_PIPELINE__BATCH_SIZE=4096 -> pipeline.batch_size

    def __init__(self, defaults: Optional[Dict] = None,
                 config_path: Optional[str] = None,
                 use_env: bool = True):
        self._defaults = copy.deepcopy(defaults or {})
        self._config_path = config_path
        self._use_env = use_env
        self._overrides: Dict = {}
        self._listeners: List[Callable[["Configuration"], None]] = []
        self._lock = threading.RLock()
        self._watcher: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._file_mtime: Optional[float] = None
        self._merged: Dict = {}
        self._rebuild()

    # -- layering ------------------------------------------------------------

    def _load_file(self) -> Dict:
        if not self._config_path or not os.path.exists(self._config_path):
            return {}
        with open(self._config_path, "r", encoding="utf-8") as fh:
            return json.load(fh)

    def _load_env(self) -> Dict:
        out: Dict = {}
        if not self._use_env:
            return out
        for key, val in os.environ.items():
            if not key.startswith(self.ENV_PREFIX):
                continue
            path = key[len(self.ENV_PREFIX):].lower().split("__")
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            try:
                node[path[-1]] = json.loads(val)
            except (ValueError, json.JSONDecodeError):
                node[path[-1]] = val
        return out

    def _rebuild(self) -> None:
        with self._lock:
            merged = self._defaults
            merged = _deep_merge(merged, self._load_file())
            merged = _deep_merge(merged, self._load_env())
            merged = _deep_merge(merged, self._overrides)
            self._merged = merged

    # -- access --------------------------------------------------------------

    def get(self, dotted_key: str, default: Any = None) -> Any:
        with self._lock:
            node: Any = self._merged
            for part in dotted_key.split("."):
                if not isinstance(node, dict) or part not in node:
                    return default
                node = node[part]
            return node

    def section(self, dotted_key: str) -> Dict:
        val = self.get(dotted_key, {})
        return copy.deepcopy(val) if isinstance(val, dict) else {}

    def tenant_section(self, tenant_token: str, dotted_key: str = "") -> Dict:
        """Per-tenant overlay (reference: per-tenant ZK config subtree)."""
        base = self.section(dotted_key) if dotted_key else {}
        suffix = f".{dotted_key}" if dotted_key else ""
        overlay = self.section(f"tenants.{tenant_token}{suffix}")
        return _deep_merge(base, overlay)

    def set(self, dotted_key: str, value: Any) -> None:
        """Programmatic override (highest-priority layer); fires listeners."""
        with self._lock:
            node = self._overrides
            parts = dotted_key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
            self._rebuild()
        self._fire()

    def snapshot(self) -> Dict:
        with self._lock:
            return copy.deepcopy(self._merged)

    # -- change notification -------------------------------------------------

    def add_listener(self, callback: Callable[["Configuration"], None]) -> None:
        self._listeners.append(callback)

    def _fire(self) -> None:
        for callback in list(self._listeners):
            callback(self)

    def start_watching(self, interval_s: float = 2.0) -> None:
        """Poll the config file for mtime changes and live-reload (reference:
        ConfigurationMonitor TreeCache watch)."""
        if self._watcher or not self._config_path:
            return
        self._watch_stop.clear()

        def _watch() -> None:
            while not self._watch_stop.wait(interval_s):
                try:
                    mtime = os.path.getmtime(self._config_path)
                except OSError:
                    continue
                if self._file_mtime is None:
                    self._file_mtime = mtime
                    continue
                if mtime != self._file_mtime:
                    self._file_mtime = mtime
                    self._rebuild()
                    self._fire()

        if os.path.exists(self._config_path):
            self._file_mtime = os.path.getmtime(self._config_path)
        self._watcher = threading.Thread(target=_watch, name="config-watch", daemon=True)
        self._watcher.start()

    def stop_watching(self) -> None:
        self._watch_stop.set()
        if self._watcher:
            self._watcher.join(timeout=5)
            self._watcher = None


DEFAULTS: Dict = {
    "instance": {"id": "swtpu1", "product_id": "sitewhere-tpu",
                 "default_tenant": "default",
                 "admin_username": "admin", "admin_password": "password"},
    "pipeline": {
        "enabled": True,
        # the card the engine runs on: "cuda" (or "cuda:N"), or "cpu" when
        # asked for; without CUDA, "cuda" refuses to boot (never falls back)
        "device": "cuda",
        "batch_size": 8192,
        # "throughput" feeds full batches via the pipelined submitter;
        # "latency" boots the engine at latency_batch_size and ingest
        # flushes adaptively (fill or linger_ms) so one event's
        # ingest->rules->alert wall time meets a p99 budget
        # (pipeline/feed.py AdaptiveBatcher)
        "mode": "throughput",
        "latency_batch_size": 4096,
        "linger_ms": 2.0,
        # adaptive linger (pipeline/feed.py AdaptiveBatcher): dispatch a
        # complete offered burst immediately; linger_ms only bounds
        # coalescing behind an in-flight flush. False = classic fixed
        # linger (maximize coalescing for bursty multi-producer ingest)
        "adaptive_linger": True,
        # on-device shard routing (ops/route.py): "auto" turns it on for
        # real multi-shard single-controller meshes (single-chip and
        # multi-host keep the host arena route); "on"/"off" force it
        "device_routing": "auto",
        # H2D staging-ring depth (pipeline/staging.py): in-flight
        # host->device transfers; 1 = serial staging, 2-3 overlap the
        # transfer of batch N+1 with the compute of batch N (PERF.md)
        "h2d_buffer_depth": 3,
        "max_devices": 131072,
        "max_zones": 256,
        "max_zone_vertices": 32,
        "max_threshold_rules": 256,
        "max_measurement_names": 1024,
        "max_tenants": 16,
        "measurement_slots": 8,
        "presence_missing_interval_ms": 8 * 60 * 60 * 1000,  # reference default 8h
    },
    "bus": {"partitions": 8, "retention_chunks": 64, "chunk_events": 65536,
            "edge_port": None},  # set to expose the bus on TCP (busnet)
    # disaggregated feeder fleet (feeders/): remote workers own TTL-leased
    # source partitions and ship ready-to-stage wire blobs; the mesh host
    # does only H2D + step. `enabled` mounts the feeder_* busnet ops on
    # the bus edge (requires bus.edge_port). Worker-side keys (`connect`,
    # `name`, `partitions`) configure `serve --feeder` processes.
    "feeders": {
        "enabled": False,
        "frames_topic": None,      # default: TopicNaming.feeder_frames()
        "lease_ttl_s": 5.0,
        "connect": None,           # mesh host bus edge "host:port"
        "name": None,              # worker identity (default: host:pid)
        "partitions": None,        # csv pin, e.g. "0,1"; None = all
        "poll_max_records": 4096,
        "shed_backoff_s": 0.25,
    },
    # fused pipeline rules applied at boot (list of dicts matching the
    # `rules` config-model element — runtime/config_model.py
    # rule_processing_model; same shape as POST /api/rules bodies)
    "rules": [],
    # federated external search providers (runtime/config_model.py
    # event_search_model; search/external.py HttpSearchProvider)
    "search_providers": [],
    # opt-in usage telemetry (runtime/telemetry.py — the
    # MicroserviceAnalytics role, inverted to off-by-default and
    # operator-owned endpoint)
    "telemetry": {"enabled": False, "endpoint": None, "interval_s": 3600},
    # in-process observability (runtime/config_model.py
    # observability_model): sample 1 in N ingest deliveries into a
    # journey span stitched across busnet hops (runtime/tracing.py
    # traceparent propagation). 0 disables sampling entirely — the
    # disarmed path is one modulo per delivery.
    "observability": {"trace_sample_n": 0},
    # concurrent query serving tier (serving/, docs/SERVING.md): bounded
    # analytics readers behind per-tenant admission + the incremental
    # window-grid cache. latency_budget_ms 0 disables the p99 shed gate;
    # mesh_row_threshold None keeps the planner's measured default.
    "serving": {
        "workers": 4,
        "queue_depth_budget": 64,
        "latency_budget_ms": 0,
        "cache_mb": 64,
        "mesh_row_threshold": None,
    },
    # unattended drift-refit sweeps (actuation/refit.py
    # DriftRefitJobExecutor): interval in seconds between sweeps over the
    # installed anomaly models. OFF by default (None) — an autonomous
    # refit rewrites live model constants, so it is operator opt-in.
    "actuation": {"refit_interval_s": None},
    # deterministic fault injection + ingest admission (runtime/faults.py,
    # sources/manager.py AdmissionController; config_model faults_model;
    # docs/OPERATIONS.md "Fault drills"). Everything off by default:
    # fault_point() is a module-global load + identity test when disarmed
    # and admit() is two attribute loads when no budget is set.
    "faults": {"allow_drills": False, "seed": 0, "rules": [],
               "admission_step_budget_ms": None,
               "admission_queue_depth_budget": None},
    "persist": {"data_dir": "./swtpu-data",
                # seconds between automatic device-state checkpoints
                # (None = manual/REST-triggered only)
                "checkpoint_interval_s": 300},
    "api": {"host": "127.0.0.1", "port": 8080, "jwt_secret": "change-me",
            "jwt_expiration_min": 600},
    "mesh": {"shards": 1},
    # multi-host deployment (parallel/cluster.py): N OS processes form one
    # jax.distributed mesh; `coordinator` ("host:port") turns it on.
    # `peers` maps process id -> that host's bus-edge address
    # ("0=hostA:9092,1=hostB:9092").
    "cluster": {
        "coordinator": None,
        "num_processes": 1,
        "process_id": 0,
        "peers": None,
        "heartbeat_s": 1.0,
        "stale_after_s": 5.0,
        "fail_after_s": 15.0,
        "presence_every_ticks": 0,
        # a stale peer (or step-loop fatal) exits the process for the
        # supervisor to restart the gang — the TPU pod failure model
        "exit_on_peer_loss": True,
        "peer_loss_exit_code": 13,
        # leaderless cross-host registry replication (parallel/cluster.py
        # RegistryGossip): creates + assignment lifecycle broadcast to
        # peers and apply idempotently
        "registry_gossip": True,
    },
}
