"""End-to-end event-age accounting: ingest edge -> effect edge.

The flight recorder (runtime/flight.py) attributes *step wall* by stage;
this module measures the other axis of the paper's 10 ms p99 target —
how long an event existed before its effect landed: receiver queueing,
batcher linger, feeder turnstile wait, dispatch, lane fetch, and
materialization all fold into one number per event.

Receivers stamp one monotonic ``received_at`` (``time.perf_counter()``,
the flight recorder's clock) per *delivery* — a payload of N decoded
events shares one stamp, so the hot path never builds a per-row host
array.  The batcher/feeder folds ``(stamp, n)`` pairs into an
:class:`AgeSidecar` that rides the step's flight record through every
cross-thread handoff (``_PreparedStep.flight``, the feeder heap tuples)
on both engine kinds.  At a close edge (materialize / alert emission /
persist) the sidecar resolves into an :class:`AgeSummary` — count, sum,
min, max, and fixed log2 bucket counts — which feeds the labeled
``pipeline.event_age_seconds`` Prometheus histogram and the flight
export's derived p50/p99.

Hot-path budget: ``add`` is an append (amortized; bounded by
``AGE_MAX_ENTRIES`` with a deterministic weighted-merge spill), a close
is O(entries) and runs on the materialize path that already does
O(alerts) host work.

The port's copy of `sitewhere_tpu/runtime/eventage.py`: the same buckets,
summaries and histogram name.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Fixed log2 age buckets. Bucket 0 counts ages <= AGE_BUCKET_FLOOR_S;
# bucket k (k >= 1) counts ages in (floor * 2^(k-1), floor * 2^k]; the
# last bucket is open-ended. 0.1 ms * 2^18 ≈ 26 s of dynamic range —
# anything older is an incident, not a latency distribution.
AGE_BUCKET_FLOOR_S = 1e-4
N_AGE_BUCKETS = 20

# Upper bucket edges in seconds (finite edges only; the last bucket is
# +Inf). These double as the Prometheus histogram bucket bounds so the
# flight rollup and the scraped histogram bucket identically.
AGE_BUCKET_EDGES_S: Tuple[float, ...] = tuple(
    AGE_BUCKET_FLOOR_S * (2.0 ** k) for k in range(N_AGE_BUCKETS - 1))

# A sidecar never grows past this many delivery entries: the batcher can
# fold hundreds of tiny deliveries into one batch, and the sidecar must
# stay O(1)-ish however the traffic arrives. On overflow the NEWEST two
# entries merge (weighted-mean stamp — exact for sum/mean, conservative
# for min/max since merged stamps stay inside [min, max]).
AGE_MAX_ENTRIES = 64


def bucket_index(age_s: float) -> int:
    """Bucket index for one age (seconds). The oracle test mirrors this
    exact formula in NumPy — keep them in lockstep."""
    if age_s <= AGE_BUCKET_FLOOR_S:
        return 0
    idx = int(math.floor(math.log2(age_s / AGE_BUCKET_FLOOR_S))) + 1
    return idx if idx < N_AGE_BUCKETS else N_AGE_BUCKETS - 1


class AgeSummary:
    """Closed per-batch age digest: count/sum/min/max + log2 buckets."""

    __slots__ = ("count", "sum_s", "min_s", "max_s", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0
        self.buckets: List[int] = [0] * N_AGE_BUCKETS

    def fold(self, age_s: float, n: int) -> None:
        age_s = max(0.0, age_s)
        self.count += n
        self.sum_s += age_s * n
        if age_s < self.min_s:
            self.min_s = age_s
        if age_s > self.max_s:
            self.max_s = age_s
        self.buckets[bucket_index(age_s)] += n

    def merge(self, other: "AgeSummary") -> None:
        self.count += other.count
        self.sum_s += other.sum_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)
        for i in range(N_AGE_BUCKETS):
            self.buckets[i] += other.buckets[i]

    def quantile_s(self, q: float) -> float:
        """Bucketed quantile estimate: the upper edge of the bucket the
        rank lands in (an upper bound; the last bucket reports the max
        observed age since it has no finite edge)."""
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += b
            if b > 0 and acc >= rank:
                if i < len(AGE_BUCKET_EDGES_S):
                    return min(AGE_BUCKET_EDGES_S[i], self.max_s)
                return self.max_s
        return self.max_s

    def export(self) -> Dict:
        if self.count <= 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_ms": round(self.sum_s / self.count * 1e3, 4),
            "min_ms": round(self.min_s * 1e3, 4),
            "max_ms": round(self.max_s * 1e3, 4),
            "p50_ms": round(self.quantile_s(0.50) * 1e3, 4),
            "p99_ms": round(self.quantile_s(0.99) * 1e3, 4),
            "buckets": list(self.buckets),
        }


class AgeSidecar:
    """Open per-batch age carrier: bounded ``(stamp, n)`` delivery
    entries. Travels on ``StepRecord.age`` through the feeder/engine
    handoffs; closed (pure — close never mutates, so materialize, alert
    emission, and persist can each close the same sidecar at their own
    instant) into an :class:`AgeSummary`."""

    __slots__ = ("entries",)

    def __init__(self) -> None:
        self.entries: List[List[float]] = []  # [stamp_s, n]

    def add(self, stamp_s: Optional[float], n: int) -> None:
        if n <= 0:
            return
        if stamp_s is None:
            stamp_s = time.perf_counter()
        entries = self.entries
        if len(entries) >= AGE_MAX_ENTRIES:
            # deterministic spill: merge the two newest entries by
            # event-weighted mean stamp (exact sum/mean, bounded error
            # on min/max/buckets only for pathological delivery storms)
            last = entries[-1]
            total = last[1] + n
            last[0] = (last[0] * last[1] + stamp_s * n) / total
            last[1] = total
            return
        entries.append([stamp_s, float(n)])

    def merge(self, other: Optional["AgeSidecar"]) -> None:
        if other is None:
            return
        for stamp, n in other.entries:
            self.add(stamp, int(n))

    @property
    def count(self) -> int:
        return int(sum(n for _, n in self.entries))

    def close(self, now_s: Optional[float] = None) -> AgeSummary:
        if now_s is None:
            now_s = time.perf_counter()
        summary = AgeSummary()
        for stamp, n in self.entries:
            summary.fold(now_s - stamp, int(n))
        return summary


def sidecar_to_wire(sidecar: Optional[AgeSidecar],
                    now_s: Optional[float] = None) -> List[List[float]]:
    """Sidecar entries for cross-process transport. ``perf_counter``
    stamps are process-local — they must never cross a process boundary
    raw. The wire form carries AGE-SO-FAR per entry ([age_s, n]); the
    receiver re-stamps against its own clock (:func:`sidecar_from_wire`),
    so the end-to-end age keeps accumulating across the hop and only the
    one-way transport skew (not clock-domain garbage) is lost."""
    if sidecar is None or not sidecar.entries:
        return []
    if now_s is None:
        now_s = time.perf_counter()
    return [[max(0.0, now_s - stamp), n] for stamp, n in sidecar.entries]


def sidecar_from_wire(entries: Sequence[Sequence[float]],
                      now_s: Optional[float] = None) -> AgeSidecar:
    """Rebuild a sidecar from wire age-so-far entries, re-stamped on the
    receiving process's ``perf_counter`` clock."""
    if now_s is None:
        now_s = time.perf_counter()
    sidecar = AgeSidecar()
    for age_s, n in entries:
        sidecar.add(now_s - max(0.0, float(age_s)), int(n))
    return sidecar


def observe_summary(hist, summary: AgeSummary, **labels) -> None:
    """Feed a closed summary into a bucketed Prometheus histogram whose
    buckets are AGE_BUCKET_EDGES_S (runtime/metrics.py Histogram built
    by :func:`age_histogram`): bucket counts transfer 1:1, sum/count
    stay exact."""
    if summary.count <= 0:
        return
    hist.observe_buckets(summary.buckets, summary.sum_s, summary.count,
                         **labels)


def age_histogram(registry):
    """The shared ingest->effect age histogram (labels: engine, edge)."""
    return registry.histogram("pipeline.event_age_seconds",
                              buckets=AGE_BUCKET_EDGES_S)
