"""Query planner: normalize windowed-read requests, route host vs mesh
(counterpart of `sitewhere_tpu/serving/planner.py`).

Every dashboard read is normalized into a :class:`WindowQuery` — the
`measurement_windows` parameter surface plus the tenant — which yields
(a) the canonical `EventFilter` the scan runs under, (b) the cache
identity `(tenant, filter, window_ms, range)` the incremental grid cache
keys on (serving/wincache.py), and (c) a routing decision:

  * **small scans**, and every scan when no `mesh_provider` is given,
    take the route "host": the engine's own single-device ops;
  * **large scans** with a `mesh_provider` take the route "mesh", the
    sharded path. That path is not ported to this package yet, so the
    engine raises for it instead of answering on one device.

The routing estimate is the eventlog's per-segment skip index
(`estimate_rows` — O(segments), no column reads), so planning cost is
noise even at high poll rates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from sitewhere_tpu_torch.model.event import DeviceEventType
from sitewhere_tpu_torch.persist.eventlog import EventFilter

# Below this many estimated rows a scan stays on one device (the JAX
# package's threshold, kept as it is); overridable per planner.
DEFAULT_MESH_ROW_THRESHOLD = 200_000


@dataclass(frozen=True)
class WindowQuery:
    """One normalized windowed read (the `measurement_windows` surface)."""

    tenant: str
    window_ms: int = 60_000
    mm_name: Optional[str] = None
    start_ms: Optional[int] = None
    end_ms: Optional[int] = None
    area_id: Optional[str] = None
    max_windows: int = 4096
    with_type_histogram: bool = False

    def filter(self) -> EventFilter:
        return EventFilter(event_type=DeviceEventType.MEASUREMENT,
                           mm_name=self.mm_name, area_id=self.area_id,
                           start_date=self.start_ms, end_date=self.end_ms)

    @property
    def cacheable(self) -> bool:
        """Only explicit-range, histogram-free queries are cacheable: an
        open range derives the grid origin from data min/max, which moves
        with every append — there is no stable grid to cache."""
        return (self.start_ms is not None and self.end_ms is not None
                and not self.with_type_histogram)


@dataclass
class QueryPlan:
    route: str              # "host" | "mesh"
    cacheable: bool
    est_rows: int
    mesh: object = None     # live mesh when route == "mesh"


class QueryPlanner:
    """Routes normalized queries over one event log + optional mesh.

    `mesh_provider` is a zero-arg callable returning the live mesh (or
    None when the process runs single-device); an error it raises reaches
    the caller, never a quiet single-device answer. Row estimates come
    from the log's segment skip index; stores without `estimate_rows`
    (wide-row datastores) degrade to host routing and no caching."""

    def __init__(self, event_log, *, mesh_provider=None,
                 mesh_row_threshold: int = DEFAULT_MESH_ROW_THRESHOLD):
        self.event_log = event_log
        self.mesh_provider = mesh_provider
        self.mesh_row_threshold = int(mesh_row_threshold)

    def estimate_rows(self, tenant: str, flt: EventFilter) -> int:
        est = getattr(self.event_log, "estimate_rows", None)
        if est is None:
            return 0
        try:
            return int(est(tenant, flt))
        except Exception:
            return 0

    def choose_mesh(self, tenant: str, flt: EventFilter):
        """The planner-decided `mesh` argument for one scan: the live
        mesh when the estimated scan is large enough to amortize the
        dispatch, else None (single device). This is what the engine's
        `mesh=None` default resolves through."""
        if self.mesh_provider is None:
            return None
        est = self.estimate_rows(tenant, flt)
        if est < self.mesh_row_threshold:
            return None
        return self.mesh_provider()

    def plan(self, query: WindowQuery) -> QueryPlan:
        flt = query.filter()
        est = self.estimate_rows(query.tenant, flt)
        mesh = None
        if self.mesh_provider is not None and \
                est >= self.mesh_row_threshold:
            mesh = self.mesh_provider()
        cacheable = query.cacheable and \
            hasattr(self.event_log, "tenant_if_exists")
        return QueryPlan(route="mesh" if mesh is not None else "host",
                         cacheable=cacheable, est_rows=est, mesh=mesh)
