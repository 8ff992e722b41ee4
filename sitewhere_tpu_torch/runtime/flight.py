"""Step flight recorder: per-step stage attribution on one monotonic clock.

The port's copy of `sitewhere_tpu/runtime/flight.py`: the same stage
vocabulary, records, export and rollups. Every engine step emits one
fixed-shape record — batch lineage id, tenant mix, event count, and a
segment timeline attributing wall time to the stages of the step path
(pack / guard / H2D / dispatch / lane-fetch / materialize). Records are
stitched across the feeder, submitter and caller threads by *carrying the
record object* through the hand-off structures (the pipelined submitter's
ready-heap tuples) instead of relying on thread-local span stacks, which
lose parentage at every thread hop.

Recording is lock-free: slots are preallocated, claimed with an atomic
``itertools.count`` ticket, and a mark is two list stores of a
``perf_counter()`` float. No allocation and no string formatting until
export.

All timestamps share ``time.perf_counter()`` so segments from different
threads are directly comparable: that is what makes
``h2d_overlap_fraction`` (how much of this step's staging-side work ran
while the previous step's dispatch was in flight) computable at export
time without any runtime coordination.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Stage vocabulary — fixed order, fixed index per stage.  The index is
# resolved once at module import; the hot path indexes preallocated
# lists, never touching a dict keyed by a freshly built string.
STAGES: Tuple[str, ...] = (
    "pack",            # host: batch -> wire blob (batch_to_blob)
    "route_host",      # sharded host fallback: arena router route_batch
    "route_device",    # sharded device path: flat-blob pack for radix route
    "guard",           # host: wait on staging-ring transfer guard
    "stage_wait",      # host: backpressure wait for a free staging-ring slot
    "h2d",             # host: device_put submit (async; segment = submit cost)
    "dispatch",        # host: jit step call until handles returned
    "device_compute",  # device: dispatch start -> outputs ready (needs sync)
    "model_eval",      # host: resolve anomaly-model fires from fetched lanes
    "lane_fetch",      # host: the one device_get of the alert+command lanes
    "materialize",     # host: decode lanes + emit alert events
    "actuate",         # host: decode command lanes + resolve policy fires
    "command_fanout",  # host: dispatch resolved commands to destinations
)
_STAGE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(STAGES)}
N_STAGES = len(STAGES)

# Staging-side stages: work that a feeder thread can run ahead while the
# step thread still has the previous step's dispatch in flight.  Overlap
# of these segments with the preceding record's dispatch window is the
# ``h2d_overlap_fraction``.
# ``stage_wait`` is deliberately NOT here: time spent blocked on a full
# staging ring is backpressure, not productive staging work — counting it
# would inflate the overlap fraction exactly when the ring stalls.
_STAGING_STAGES = ("pack", "route_host", "route_device", "guard", "h2d")


class StepRecord:
    """One preallocated flight-record slot.

    ``begin``/``end`` are fixed-length float lists indexed by stage; a
    negative value means "not recorded".  ``reset`` re-arms the slot for
    reuse without reallocating.
    """

    __slots__ = ("seq", "gen", "engine", "events", "tenant_mix",
                 "begin", "end", "created", "age", "ring", "commands",
                 "cards")

    def __init__(self) -> None:
        self.seq = -1            # lineage id (recorder-wide monotonic)
        self.gen = -1            # ring generation (claim ticket)
        self.engine = ""         # engine scope name
        self.events = 0
        self.tenant_mix: Optional[Tuple[int, ...]] = None
        self.begin: List[float] = [-1.0] * N_STAGES
        self.end: List[float] = [-1.0] * N_STAGES
        self.created = 0.0
        # event-age ride-along (runtime/eventage.py): an open AgeSidecar
        # while the batch is in flight, replaced by the closed AgeSummary
        # at materialize — export only reads the closed form
        self.age = None
        # staging-ring snapshot at slot-acquire time: (occupancy, depth),
        # None when the step never touched the ring
        self.ring: Optional[Tuple[int, int]] = None
        # command fires resolved from this step's command lane (actuate
        # stage); drives the detection_to_actuation age edge
        self.commands = 0
        # a step over several cards: per block, its card and what ran
        # there ({"block", "card", "h2d", "exchange", "step"}), else None
        self.cards: Optional[List[Dict]] = None

    # -- hot path -----------------------------------------------------
    def reset(self, seq: int, gen: int, engine: str) -> None:
        self.seq = seq
        self.gen = gen
        self.engine = engine
        self.events = 0
        self.tenant_mix = None
        b, e = self.begin, self.end
        for i in range(N_STAGES):
            b[i] = -1.0
            e[i] = -1.0
        self.created = time.perf_counter()
        self.age = None
        self.ring = None
        self.commands = 0
        self.cards = None

    def mark(self, stage: str, t0: float, t1: float) -> None:
        """Record a completed segment from explicit timestamps."""
        i = _STAGE_INDEX[stage]
        self.begin[i] = t0
        self.end[i] = t1

    def begin_stage(self, stage: str) -> None:
        self.begin[_STAGE_INDEX[stage]] = time.perf_counter()

    def end_stage(self, stage: str) -> None:
        self.end[_STAGE_INDEX[stage]] = time.perf_counter()

    # -- cold path (export / tests) -----------------------------------
    def stage_s(self, stage: str) -> float:
        """Duration of one stage in seconds, 0.0 if unrecorded."""
        i = _STAGE_INDEX[stage]
        if self.begin[i] < 0.0 or self.end[i] < 0.0:
            return 0.0
        return max(0.0, self.end[i] - self.begin[i])

    def span_bounds(self) -> Optional[Tuple[float, float]]:
        """(first begin, last end) across recorded segments."""
        first = None
        last = None
        for i in range(N_STAGES):
            if self.begin[i] >= 0.0 and self.end[i] >= 0.0:
                first = self.begin[i] if first is None else min(
                    first, self.begin[i])
                last = self.end[i] if last is None else max(
                    last, self.end[i])
        if first is None or last is None:
            return None
        return first, last

    def export(self) -> Dict:
        """Dict form for the REST endpoint / bench.  Allocates — never
        called from the hot path."""
        stages = {}
        sum_s = 0.0
        crit = ""
        crit_s = -1.0
        for i, name in enumerate(STAGES):
            if self.begin[i] < 0.0 or self.end[i] < 0.0:
                continue
            dur = max(0.0, self.end[i] - self.begin[i])
            stages[name] = {
                "begin_s": self.begin[i],
                "ms": round(dur * 1e3, 6),
            }
            sum_s += dur
            if dur > crit_s:
                crit_s = dur
                crit = name
        bounds = self.span_bounds()
        span_s = (bounds[1] - bounds[0]) if bounds else 0.0
        out = {
            "seq": self.seq,
            "engine": self.engine,
            "events": self.events,
            "stages": stages,
            "sum_ms": round(sum_s * 1e3, 6),
            "span_ms": round(span_s * 1e3, 6),
            "critical_stage": crit,
        }
        if self.tenant_mix is not None:
            out["tenant_mix"] = list(self.tenant_mix)
        if self.ring is not None:
            out["ring"] = {"occupancy": self.ring[0],
                           "depth": self.ring[1]}
        if self.cards is not None:
            out["cards"] = [dict(c) for c in self.cards]
        age = self.age
        if age is not None and hasattr(age, "export"):
            exported = age.export()
            if exported.get("count"):
                out["age"] = exported
        return out


class FlightRecorder:
    """Fixed-capacity ring of preallocated :class:`StepRecord` slots.

    ``begin_step`` claims the next slot with an atomic counter ticket
    (``itertools.count`` advances under the GIL without a lock) and
    re-arms it; concurrent writers from feeder/submitter/caller threads
    each hold a distinct slot, so marks never contend.  Export walks the
    ring snapshot-style, tolerating slots being rewritten mid-walk by
    checking the generation ticket before and after the copy.
    """

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = int(capacity)
        self._slots = [StepRecord() for _ in range(self.capacity)]
        self._ticket = itertools.count()
        self._export_lock = threading.Lock()

    # -- hot path -----------------------------------------------------
    def begin_step(self, engine: str = "") -> StepRecord:
        gen = next(self._ticket)
        rec = self._slots[gen % self.capacity]
        rec.reset(seq=gen, gen=gen, engine=engine)
        return rec

    # -- cold path ----------------------------------------------------
    def _stable_records(self, last_n: int) -> List[StepRecord]:
        """Copy out the most recent completed slots, newest last.

        A slot is taken only if its generation ticket is unchanged
        across the copy (it wasn't re-armed mid-read)."""
        # itertools.count cannot be peeked without advancing; take the
        # high-water mark from the slots themselves instead.
        top = max((s.gen for s in self._slots), default=-1)
        out: List[StepRecord] = []
        lo = max(0, top - min(last_n, self.capacity) + 1)
        for gen in range(lo, top + 1):
            slot = self._slots[gen % self.capacity]
            if slot.gen != gen:
                continue
            copy = StepRecord()
            copy.seq = slot.seq
            copy.gen = slot.gen
            copy.engine = slot.engine
            copy.events = slot.events
            copy.tenant_mix = slot.tenant_mix
            copy.begin = list(slot.begin)
            copy.end = list(slot.end)
            copy.created = slot.created
            copy.age = slot.age
            copy.ring = slot.ring
            copy.cards = slot.cards
            if slot.gen != gen:  # re-armed while we copied: discard
                continue
            out.append(copy)
        return out

    def export(self, last_n: int = 64) -> Dict:
        """Records + rollups for ``GET /api/instance/flight``."""
        with self._export_lock:
            recs = self._stable_records(last_n)
        records = [r.export() for r in recs]
        return {
            "capacity": self.capacity,
            "count": len(records),
            "stages": list(STAGES),
            "records": records,
            "rollups": self._rollups(recs),
        }

    def _rollups(self, recs: Sequence[StepRecord]) -> Dict:
        """Window aggregates: per-stage occupancy, sum-vs-max decomposed
        sync time, h2d overlap fraction, critical-path histogram."""
        if not recs:
            return {"steps": 0}
        window_lo = None
        window_hi = None
        stage_tot = [0.0] * N_STAGES
        sum_ms: List[float] = []
        max_ms: List[float] = []
        crit_count: Dict[str, int] = {}
        events = 0
        for r in recs:
            bounds = r.span_bounds()
            if bounds is None:
                continue
            window_lo = bounds[0] if window_lo is None else min(
                window_lo, bounds[0])
            window_hi = bounds[1] if window_hi is None else max(
                window_hi, bounds[1])
            rec_sum = 0.0
            rec_max = 0.0
            crit = ""
            for i in range(N_STAGES):
                if r.begin[i] < 0.0 or r.end[i] < 0.0:
                    continue
                dur = max(0.0, r.end[i] - r.begin[i])
                stage_tot[i] += dur
                rec_sum += dur
                if dur > rec_max:
                    rec_max = dur
                    crit = STAGES[i]
            sum_ms.append(rec_sum * 1e3)
            max_ms.append(rec_max * 1e3)
            if crit:
                crit_count[crit] = crit_count.get(crit, 0) + 1
            events += r.events
        if window_lo is None or window_hi is None:
            return {"steps": 0}
        wall = max(window_hi - window_lo, 1e-9)
        occupancy = {
            STAGES[i]: round(stage_tot[i] / wall, 4)
            for i in range(N_STAGES) if stage_tot[i] > 0.0
        }
        n = len(sum_ms)
        # ingest->effect event-age rollup: merge the closed AgeSummary
        # ride-alongs across the window and derive p50/p99 from the log2
        # buckets (runtime/eventage.py) — the flight endpoint's answer to
        # "how old were events when their effects landed"
        age_total = None
        for r in recs:
            age = r.age
            if age is None or not hasattr(age, "buckets") \
                    or not getattr(age, "count", 0):
                continue
            if age_total is None:
                from sitewhere_tpu_torch.runtime.eventage import AgeSummary
                age_total = AgeSummary()
            age_total.merge(age)
        out_age = age_total.export() if age_total is not None else None
        # staging-ring occupancy rollup: how full the H2D ring ran across
        # the window (mean/max of the at-acquire snapshots).  A ring
        # pinned at depth means the feeder is transfer-bound; zero means
        # the ring never engaged (serial path or depth 1 idle).
        ring_occ = [r.ring[0] for r in recs if r.ring is not None]
        ring_depth = max((r.ring[1] for r in recs if r.ring is not None),
                         default=0)
        ring_out = None
        if ring_occ:
            ring_out = {
                "depth": ring_depth,
                "mean_occupancy": round(sum(ring_occ) / len(ring_occ), 3),
                "max_occupancy": max(ring_occ),
            }
        return {
            "steps": n,
            "events": events,
            "window_ms": round(wall * 1e3, 3),
            **({"event_age": out_age} if out_age else {}),
            **({"staging_ring": ring_out} if ring_out else {}),
            "stage_occupancy": occupancy,
            # sum-vs-max: if the pipeline overlapped perfectly, wall per
            # step converges to the max stage cost; serial execution
            # pays the sum.  Both are exported so the ratio is readable.
            "sync_total_ms": {
                "sum_of_stages": round(sum(sum_ms) / n, 4),
                "max_stage": round(sum(max_ms) / n, 4),
            },
            "critical_stage_counts": crit_count,
            "h2d_overlap_fraction": round(
                self._h2d_overlap_fraction(recs), 4),
        }

    @staticmethod
    def _h2d_overlap_fraction(recs: Sequence[StepRecord]) -> float:
        """Fraction of staging-side work (pack/route/guard/h2d) that ran
        while the *previous* record's dispatch window was still open.

        Zero for a serial submit loop; approaches 1.0 when a feeder
        stages batch N+1 entirely under batch N's dispatch.  Computable
        offline because every mark shares one monotonic clock."""
        di = _STAGE_INDEX["dispatch"]
        staging_idx = [_STAGE_INDEX[s] for s in _STAGING_STAGES]
        total = 0.0
        overlapped = 0.0
        by_seq = sorted(recs, key=lambda r: r.seq)
        for prev, cur in zip(by_seq, by_seq[1:]):
            if prev.begin[di] < 0.0 or prev.end[di] < 0.0:
                continue
            d0, d1 = prev.begin[di], prev.end[di]
            for i in staging_idx:
                if cur.begin[i] < 0.0 or cur.end[i] < 0.0:
                    continue
                b, e = cur.begin[i], cur.end[i]
                total += max(0.0, e - b)
                overlapped += max(0.0, min(e, d1) - max(b, d0))
        if total <= 0.0:
            return 0.0
        return min(1.0, overlapped / total)


# Process-wide recorder: engines default to this.  Mirrors GLOBAL_METRICS.
GLOBAL_FLIGHT = FlightRecorder()
