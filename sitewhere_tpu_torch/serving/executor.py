"""Concurrent query executor: bounded workers, read admission, rulers
(counterpart of `sitewhere_tpu/serving/executor.py`).

The write path's front door (budgets, a cached decision, a counted
structured 429) generalized to READS — hundreds of
dashboard pollers must not be able to convoy the analytics path into
unbounded queueing, and a shed dashboard poll must be a cheap, visible
429, not a 30 s hang:

  * a bounded worker pool (`workers` threads) runs every query; callers
    block on a future, never on the engine;
  * per-tenant admission: a tenant whose queued+running reads exceed
    `queue_depth_budget`, or whose recent latency breaches
    `latency_budget_ms`, gets :class:`QueryShedError` (HTTP 429) at
    submit — counted under `query.shed`;
  * scans are snapshot-isolated by construction: the eventlog hands the
    cache a sealed-segment snapshot under one lock acquisition
    (`sealed_snapshot`) and the monolithic path's `scan()` does the
    same, so a query NEVER holds a lock that an ingest append or the
    step loop waits on;
  * rulers: `query.latency_seconds{tenant}` histogram, the
    `analytics_query` edge on the ingest->effect age waterfall
    (`pipeline.event_age_seconds{engine="serving"}`), `query.shed` /
    `query.cache_hit` / `query.cache_miss` counters, and a bounded ring
    of per-query spans (admit -> start -> done, route + cache
    attribution) exported by :meth:`report` — the flight-plane analog
    for reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Deque, Dict, Optional

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.runtime.eventage import (
    AgeSidecar, age_histogram, observe_summary)
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.serving.planner import QueryPlanner, WindowQuery
from sitewhere_tpu_torch.serving.wincache import WindowGridCache

AGE_EDGE = "analytics_query"
AGE_ENGINE = "serving"


class QueryShedError(SiteWhereError):
    """Client-visible NACK for a read shed under overload — HTTP 429,
    the read-side sibling of IngestShedError."""

    def __init__(self, message: str = "query shed: serving over budget"):
        super().__init__(message, http_status=429)


class QueryExecutor:
    """Bounded concurrent serving over one analytics engine."""

    def __init__(self, engine, planner: Optional[QueryPlanner] = None,
                 cache: Optional[WindowGridCache] = None, *,
                 workers: int = 4, queue_depth_budget: int = 64,
                 latency_budget_ms: float = 0.0,
                 latency_window: int = 128, registry=None):
        self.engine = engine
        self.planner = planner or QueryPlanner(engine.event_log)
        self.cache = cache if cache is not None else WindowGridCache()
        self.workers = max(1, int(workers))
        self.queue_depth_budget = int(queue_depth_budget)
        self.latency_budget_ms = float(latency_budget_ms)
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="serving")
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._latencies: Deque[float] = deque(maxlen=max(8, latency_window))
        self._spans: Deque[Dict[str, Any]] = deque(maxlen=256)
        self._queries = 0
        m = registry or GLOBAL_METRICS
        self.latency_hist = m.histogram(
            "query.latency_seconds",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0))
        self.shed_counter = m.counter("query.shed")
        self.mesh_counter = m.counter("query.mesh_routed")
        self._age_hist = age_histogram(m)

    # -- admission ---------------------------------------------------------

    def _recent_p99_ms(self) -> float:
        with self._lock:
            if not self._latencies:
                return 0.0
            ordered = sorted(self._latencies)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))] * 1e3

    def _admit(self, tenant: str) -> None:
        """One read-admission decision; raises the structured 429. Depth
        is checked per tenant (a greedy dashboard cannot starve the
        rest); the latency budget is global — when the pool itself is
        over budget everyone sheds."""
        if self.queue_depth_budget > 0:
            with self._lock:
                depth = self._inflight.get(tenant, 0)
            if depth >= self.queue_depth_budget:
                self.shed_counter.inc()
                raise QueryShedError(
                    f"query shed: tenant {tenant} read depth {depth} over "
                    f"budget {self.queue_depth_budget}")
        if self.latency_budget_ms > 0.0:
            p99 = self._recent_p99_ms()
            if p99 > self.latency_budget_ms:
                self.shed_counter.inc()
                raise QueryShedError(
                    f"query shed: recent p99 {p99:.1f} ms over budget "
                    f"{self.latency_budget_ms:.1f} ms")

    # -- execution ---------------------------------------------------------

    def _run(self, query: WindowQuery, admitted_s: float) -> Dict[str, Any]:
        started_s = time.perf_counter()
        plan = self.planner.plan(query)
        report = None
        info: Dict[str, Any] = {"cache_hit": False}
        route = plan.route
        if plan.cacheable and self.cache is not None:
            tlog = self.engine.event_log.tenant_if_exists(query.tenant)
            if tlog is not None and hasattr(tlog, "sealed_snapshot"):
                served = self.cache.query(
                    tlog, tenant=query.tenant, flt=query.filter(),
                    window_ms=query.window_ms, start_ms=query.start_ms,
                    end_ms=query.end_ms, max_windows=query.max_windows,
                    device=self.engine.device)
                if served is not None:
                    report, info = served
                    route = "cache"
        if report is None:
            if plan.mesh is not None:
                self.mesh_counter.inc()
            report = self.engine.measurement_windows(
                query.tenant, window_ms=query.window_ms,
                mm_name=query.mm_name, start_ms=query.start_ms,
                end_ms=query.end_ms, area_id=query.area_id,
                max_windows=query.max_windows,
                with_type_histogram=query.with_type_histogram,
                mesh=plan.mesh)
        done_s = time.perf_counter()
        total_s = done_s - admitted_s
        self.latency_hist.observe(total_s, tenant=query.tenant)
        sidecar = AgeSidecar()
        sidecar.add(admitted_s, 1)
        observe_summary(self._age_hist, sidecar.close(done_s),
                        engine=AGE_ENGINE, edge=AGE_EDGE)
        span = {
            "tenant": query.tenant, "route": route,
            "cache_hit": bool(info.get("cache_hit")),
            "est_rows": plan.est_rows,
            "wait_ms": round((started_s - admitted_s) * 1e3, 3),
            "exec_ms": round((done_s - started_s) * 1e3, 3),
            "total_ms": round(total_s * 1e3, 3),
        }
        if "delta_rows" in info:
            span["delta_rows"] = info["delta_rows"]
        with self._lock:
            self._latencies.append(total_s)
            self._spans.append(span)
        return {"report": report, "plan": plan, "info": info, "span": span}

    def submit(self, query: WindowQuery) -> Future:
        """Admit + enqueue one query; the returned future resolves to
        `{"report": WindowReport, "plan": QueryPlan, "info": ..,
        "span": ..}`."""
        self._admit(query.tenant)
        admitted_s = time.perf_counter()
        with self._lock:
            self._inflight[query.tenant] = \
                self._inflight.get(query.tenant, 0) + 1
            self._queries += 1
        future = self._pool.submit(self._run, query, admitted_s)

        def _done(_f, tenant=query.tenant):
            with self._lock:
                left = self._inflight.get(tenant, 1) - 1
                if left <= 0:
                    self._inflight.pop(tenant, None)
                else:
                    self._inflight[tenant] = left

        future.add_done_callback(_done)
        return future

    def query(self, query: WindowQuery,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(query).result(timeout=timeout)

    # -- telemetry ---------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._lock:
            spans = list(self._spans)
            inflight = dict(self._inflight)
            queries = self._queries
        return {
            "workers": self.workers,
            "queries": queries,
            "inflight": inflight,
            "queue_depth_budget": self.queue_depth_budget,
            "latency_budget_ms": self.latency_budget_ms,
            "recent_p99_ms": round(self._recent_p99_ms(), 3),
            "shed_total": self.shed_counter.value,
            "mesh_routed_total": self.mesh_counter.value,
            "cache": {
                "entries": len(self.cache),
                "resident_bytes": self.cache.resident_bytes,
                "max_bytes": self.cache.max_bytes,
                "hits": self.cache.hit_counter.value,
                "misses": self.cache.miss_counter.value,
                "evictions": self.cache.evict_counter.value,
            },
            "spans": spans[-64:],
        }

    def stop(self) -> None:
        self._pool.shutdown(wait=True)
