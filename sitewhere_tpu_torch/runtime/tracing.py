"""Lightweight distributed-tracing spans.

Reference: OpenTracing + Jaeger spans around lifecycle ops and gRPC calls
(sitewhere-grpc-model tracing/ServerTracingInterceptor.java,
TracerUtils.java:17-37). Here: in-proc span tree with a ring-buffer exporter
that the REST API can dump (counterpart of `sitewhere_tpu/runtime/tracing.py`;
`torch.profiler` covers the device side).

Cross-thread parentage: the active-span stack is thread-local, so a span
opened on a feeder thread cannot see its logical parent on the submit
thread.  `TraceContext` carries (trace_id, span_id) explicitly across the
hop — `Tracer.span(..., parent=ctx)` overrides the stack lookup, and
`extract_traceparent`/`inject_traceparent` map the same context to the
W3C `traceparent` header for REST ingress/egress.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass(frozen=True)
class TraceContext:
    """Explicit parent handoff across thread hops and the wire."""
    trace_id: str
    span_id: str


_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def extract_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C `traceparent` header -> TraceContext (None if absent/invalid)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)


def inject_traceparent(span: "Span") -> str:
    """Span -> W3C `traceparent` header value (ids zero-padded)."""
    return f"00-{span.trace_id:0>32}-{span.span_id:0>16}-01"


def format_traceparent(ctx: TraceContext) -> str:
    """TraceContext -> W3C `traceparent` value — the wire form carried
    inside busnet RPC envelopes and gossip payloads (runtime/busnet.py,
    parallel/cluster.py), symmetric with `extract_traceparent`."""
    return f"00-{ctx.trace_id:0>32}-{ctx.span_id:0>16}-01"


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    operation: str
    start_ms: float
    end_ms: Optional[float] = None
    tags: Dict[str, str] = field(default_factory=dict)
    logs: List[str] = field(default_factory=list)

    @property
    def duration_ms(self) -> float:
        # snapshot the end once: `end_ms or time.time()` re-read the
        # clock on every evaluation for unfinished spans, and the falsy
        # `or` treated end_ms == 0.0 as unfinished
        end = self.end_ms
        if end is None:
            end = time.time() * 1000
        return end - self.start_ms

    def context(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def to_dict(self) -> Dict:
        return {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id, "operation": self.operation,
            "startMs": self.start_ms, "durationMs": self.duration_ms,
            "tags": dict(self.tags), "logs": list(self.logs),
        }


class Tracer:
    """Per-thread active-span stacks + bounded finished-span buffer.

    The stacks are keyed by thread ident in a plain dict (not
    ``threading.local``): feeder/stager threads die on engine restart,
    and a thread-local would strand their entries invisibly — worse,
    idents recycle, so a reused ident could adopt a dead thread's stale
    parentage.  ``finished()``/``stats()`` sweep stacks whose thread no
    longer exists (thread hygiene; regression-tested)."""

    def __init__(self, capacity: int = 4096):
        self._finished: Deque[Span] = deque(maxlen=capacity)
        self._stacks: Dict[int, List[Span]] = {}
        self._lock = threading.Lock()
        self.error_count = 0
        self.finished_count = 0

    def _stack(self) -> List[Span]:
        ident = threading.get_ident()
        stack = self._stacks.get(ident)
        if stack is None:
            with self._lock:
                stack = self._stacks.setdefault(ident, [])
        return stack

    def _sweep_dead_threads(self) -> None:
        """Drop per-thread stacks whose thread is gone. Caller holds
        ``self._lock``."""
        if not self._stacks:
            return
        live = {t.ident for t in threading.enumerate()}
        for ident in [i for i in self._stacks if i not in live]:
            del self._stacks[ident]

    @contextlib.contextmanager
    def span(self, operation: str,
             parent: Optional[TraceContext] = None, **tags: str):
        stack = self._stack()
        if parent is None:
            active = stack[-1] if stack else None
            if active is not None:
                parent = active.context()
        span = Span(
            trace_id=parent.trace_id if parent else uuid.uuid4().hex[:16],
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent.span_id if parent else None,
            operation=operation,
            start_ms=time.time() * 1000,
            # defensive copy: tag values are stringified here so later
            # mutation of caller-held objects can't rewrite history
            tags={str(k): str(v) for k, v in tags.items()},
        )
        stack.append(span)
        errored = False
        try:
            yield span
        except BaseException as exc:
            errored = True
            span.tags["error"] = "true"
            span.logs.append(repr(exc))
            raise
        finally:
            span.end_ms = time.time() * 1000
            stack.pop()
            with self._lock:
                self._finished.append(span)
                self.finished_count += 1
                if errored or span.tags.get("error") == "true":
                    self.error_count += 1
                    errored = True
            if errored:
                # error spans surface in the metrics registry so the
                # scrape path sees them without dumping the span buffer
                from .metrics import GLOBAL_METRICS
                GLOBAL_METRICS.counter("tracing.span_errors").inc()

    def active(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def active_context(self) -> Optional[TraceContext]:
        span = self.active()
        return span.context() if span is not None else None

    def current_traceparent(self) -> Optional[str]:
        """W3C `traceparent` of this thread's active span (None when no
        span is open) — what busnet RPC envelopes stamp."""
        span = self.active()
        return inject_traceparent(span) if span is not None else None

    def finished(self, limit: int = 100) -> List[Dict]:
        with self._lock:
            self._sweep_dead_threads()
            spans = list(self._finished)[-limit:]
        return [s.to_dict() for s in spans]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            self._sweep_dead_threads()
            return {"finished": self.finished_count,
                    "errors": self.error_count,
                    "thread_stacks": len(self._stacks)}


GLOBAL_TRACER = Tracer()
