"""Metrics registry: counters, meters (rates), timers with percentiles.

The port's copy of `sitewhere_tpu/runtime/metrics.py`: the same registry,
the same metric names and the same Prometheus text for the same call
sequence (tests/test_torch_runtime.py). A lock-cheap in-process registry;
timers keep a bounded reservoir for p50/p95/p99, histograms keep labelled
cumulative buckets.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional


def _prom_name(name: str) -> str:
    """Metric key -> prometheus-legal name (dots and dashes collapse to
    underscores; leading digits get a prefix)."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    return f"m_{out}" if out and out[0].isdigit() else out


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Meter:
    """Event rate: total count + exponentially-weighted 1-minute rate."""

    def __init__(self) -> None:
        self.count = 0
        self._rate = 0.0
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            now = time.monotonic()
            dt = now - self._last
            self.count += n
            if dt > 0:
                inst = n / dt
                alpha = min(1.0, dt / 60.0)
                self._rate += alpha * (inst - self._rate)
                self._last = now

    @property
    def one_minute_rate(self) -> float:
        return self._rate


class Timer:
    """Duration histogram with a sliding reservoir (last `capacity` samples)."""

    def __init__(self, capacity: int = 2048) -> None:
        self._samples: List[float] = []
        self._capacity = capacity
        self._idx = 0
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            if len(self._samples) < self._capacity:
                self._samples.append(seconds)
            else:
                self._samples[self._idx] = seconds
                self._idx = (self._idx + 1) % self._capacity

    class _Ctx:
        def __init__(self, timer: "Timer"):
            self._timer = timer

        def __enter__(self) -> "Timer._Ctx":
            self._start = time.perf_counter()
            return self

        def __exit__(self, *exc) -> None:
            self._timer.update(time.perf_counter() - self._start)

    def time(self) -> "Timer._Ctx":
        return Timer._Ctx(self)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            ordered = sorted(self._samples)
            k = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
            return ordered[k]

    def snapshot(self) -> Dict[str, float]:
        # One lock acquisition, one sorted copy — percentile() used to be
        # called per quantile, re-locking and re-sorting the reservoir
        # three times per snapshot.
        with self._lock:
            count, total = self.count, self.total
            ordered = sorted(self._samples)

        def pct(q: float) -> float:
            if not ordered:
                return 0.0
            k = min(len(ordered) - 1,
                    max(0, int(round(q * (len(ordered) - 1)))))
            return ordered[k]

        return {
            "count": count,
            "total_s": total,
            "mean_s": (total / count) if count else 0.0,
            "p50_s": pct(0.50),
            "p95_s": pct(0.95),
            "p99_s": pct(0.99),
        }


# Default buckets for step-path latencies (seconds): sub-ms device steps
# through multi-second stalls, roughly logarithmic.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)

# Cardinality guard: a histogram family never grows past this many
# labeled children. The label vocabularies are meant to be fixed (stage
# names, engine names, bounded tenant indices) — an unbounded label
# (device token, batch id) would grow the exposition without limit, so
# past the cap observations land on a per-family `_overflow` child and
# `metrics.label_overflow` counts the spills (loud, never silent).
MAX_LABEL_CHILDREN = 64


class Histogram:
    """Prometheus-style bucketed histogram with optional labels.

    Unlike :class:`Timer`'s sliding reservoir (whose p50/p95/p99 are
    scrape-time approximations that cannot be aggregated across
    instances), cumulative buckets survive aggregation and let the
    scraper compute any quantile.  Labels (e.g. ``stage=``, ``tenant=``)
    key independent child series: each distinct label set carries its
    own bucket counts, ``_sum`` and ``_count``."""

    class _Child:
        __slots__ = ("counts", "total", "count")

        def __init__(self, n_buckets: int) -> None:
            self.counts = [0] * n_buckets  # cumulative at export, raw here
            self.total = 0.0
            self.count = 0

    def __init__(self, buckets: Optional[tuple] = None,
                 max_children: int = MAX_LABEL_CHILDREN) -> None:
        self.buckets = tuple(buckets if buckets is not None
                             else DEFAULT_BUCKETS)
        self.max_children = max_children
        self._children: Dict[tuple, "Histogram._Child"] = {}
        self._lock = threading.Lock()

    def child(self, **labels: str) -> "Histogram._Child":
        key = tuple(sorted(labels.items()))
        overflowed = False
        with self._lock:
            ch = self._children.get(key)
            if ch is None:
                if key and len(self._children) >= self.max_children:
                    # cardinality cap: spill to the family's _overflow
                    # child (same label keys, sentinel values) instead of
                    # growing the exposition unboundedly
                    key = tuple((lk, "_overflow") for lk, _ in key)
                    ch = self._children.get(key)
                    overflowed = True
                if ch is None:
                    ch = Histogram._Child(len(self.buckets))
                    self._children[key] = ch
        if overflowed:
            # outside self._lock; the registry lock nests independently
            GLOBAL_METRICS.counter("metrics.label_overflow").inc()
        return ch

    def observe(self, seconds: float, **labels: str) -> None:
        ch = self.child(**labels)
        with self._lock:
            ch.total += seconds
            ch.count += 1
            # raw per-bucket counts; cumulated at export so observe is
            # a single increment
            for i, ub in enumerate(self.buckets):
                if seconds <= ub:
                    ch.counts[i] += 1
                    break

    def observe_buckets(self, bucket_counts, sum_value: float, count: int,
                        **labels: str) -> None:
        """Aggregate-observe: fold precomputed raw per-bucket counts in
        one call (the age sidecar closes a whole batch this way — never
        a per-event observe loop on the hot path). The first
        ``len(self.buckets)`` entries align with ``self.buckets``; any
        trailing entries count only toward ``_count`` (the +Inf
        bucket)."""
        ch = self.child(**labels)
        with self._lock:
            ch.total += sum_value
            ch.count += count
            counts = ch.counts
            n = len(counts)
            for i, c in enumerate(bucket_counts):
                if c and i < n:
                    counts[i] += c

    def snapshot(self) -> Dict:
        with self._lock:
            out = {}
            for key, ch in self._children.items():
                cum = []
                running = 0
                for c in ch.counts:
                    running += c
                    cum.append(running)
                out[key] = {"buckets": cum, "sum_s": ch.total,
                            "count": ch.count}
            return out


class MetricsRegistry:
    """Named metric registry; names are prefixed by component/tenant scope the
    way TenantEngineLifecycleComponent prefixes metric names."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._meters: Dict[str, Meter] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def histogram(self, name: str,
                  buckets: Optional[tuple] = None) -> Histogram:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = Histogram(buckets)
                self._histograms[name] = hist
            return hist

    def scoped(self, prefix: str) -> "ScopedMetrics":
        return ScopedMetrics(self, prefix)

    def report(self) -> Dict[str, Dict]:
        """Serializable snapshot (reference: Slf4j reporter every 20s)."""
        with self._lock:
            counters = dict(self._counters)
            meters = dict(self._meters)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        return {
            "counters": {k: v.value for k, v in counters.items()},
            "meters": {k: {"count": v.count, "m1_rate": v.one_minute_rate}
                       for k, v in meters.items()},
            "timers": {k: v.snapshot() for k, v in timers.items()},
            "histograms": {
                k: {"&".join(f"{lk}={lv}" for lk, lv in key) or "_": snap
                    for key, snap in v.snapshot().items()}
                for k, v in histograms.items()},
        }

    def prometheus_text(self, extra_gauges: Optional[Dict[str, float]] = None
                        ) -> str:
        """Prometheus text exposition (version 0.0.4) of every registered
        metric — the role of the reference's Dropwizard reporters
        (Microservice.java:146,244-246), scrapeable at GET /metrics.
        Counters/meter-counts become prometheus counters, meter 1-minute
        rates and `extra_gauges` become gauges, timers become summaries
        with p50/p95/p99 quantiles."""
        with self._lock:
            counters = dict(self._counters)
            meters = dict(self._meters)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        lines: List[str] = []

        def emit(name: str, kind: str, value, labels: str = "") -> None:
            if kind:
                lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name}{labels} {value}")

        for key in sorted(counters):
            emit(f"swtpu_{_prom_name(key)}_total", "counter",
                 counters[key].value)
        for key in sorted(meters):
            meter = meters[key]
            base = f"swtpu_{_prom_name(key)}"
            emit(f"{base}_total", "counter", meter.count)
            emit(f"{base}_m1_rate", "gauge",
                 round(meter.one_minute_rate, 6))
        for key in sorted(timers):
            snap = timers[key].snapshot()
            base = f"swtpu_{_prom_name(key)}_seconds"
            lines.append(f"# TYPE {base} summary")
            for quantile in ("p50", "p95", "p99"):
                lines.append(
                    f'{base}{{quantile="0.{quantile[1:]}"}} '
                    f'{snap[f"{quantile}_s"]:.9f}')
            lines.append(f"{base}_count {snap['count']}")
            # true accumulated total, not the lossy mean*count round-trip
            lines.append(f"{base}_sum {snap['total_s']:.9f}")
        for key in sorted(histograms):
            hist = histograms[key]
            # histograms carry their unit in the registry name
            # (step_stage_seconds, step_tenant_events) — no blanket
            # _seconds suffix like the duration-only timers get
            base = f"swtpu_{_prom_name(key)}"
            lines.append(f"# TYPE {base} histogram")
            for labelkey, snap in sorted(hist.snapshot().items()):
                label_pairs = [
                    f'{_prom_name(lk)}="{lv}"' for lk, lv in labelkey]
                prefix = ",".join(label_pairs)
                sep = "," if prefix else ""
                for ub, cum in zip(hist.buckets, snap["buckets"]):
                    lines.append(
                        f'{base}_bucket{{{prefix}{sep}le="{ub:g}"}} {cum}')
                lines.append(
                    f'{base}_bucket{{{prefix}{sep}le="+Inf"}} '
                    f'{snap["count"]}')
                lbl = f"{{{prefix}}}" if prefix else ""
                lines.append(f'{base}_sum{lbl} {snap["sum_s"]:.9f}')
                lines.append(f'{base}_count{lbl} {snap["count"]}')
        # extra gauges may carry a literal label block in the key
        # (`hbm.table_bytes{table="device_state"}`): one TYPE line per
        # family, labels pass through verbatim
        extras = extra_gauges or {}
        typed: set = set()
        for key in sorted(extras):
            name, brace, labelrest = key.partition("{")
            base = f"swtpu_{_prom_name(name)}"
            if base not in typed:
                lines.append(f"# TYPE {base} gauge")
                typed.add(base)
            labels = ("{" + labelrest) if brace else ""
            lines.append(f"{base}{labels} {extras[key]}")
        return "\n".join(lines) + "\n"


class ScopedMetrics:
    def __init__(self, registry: MetricsRegistry, prefix: str):
        self._registry = registry
        self._prefix = prefix

    def counter(self, name: str) -> Counter:
        return self._registry.counter(f"{self._prefix}.{name}")

    def meter(self, name: str) -> Meter:
        return self._registry.meter(f"{self._prefix}.{name}")

    def timer(self, name: str) -> Timer:
        return self._registry.timer(f"{self._prefix}.{name}")

    def histogram(self, name: str,
                  buckets: Optional[tuple] = None) -> Histogram:
        return self._registry.histogram(f"{self._prefix}.{name}", buckets)


GLOBAL_METRICS = MetricsRegistry()
