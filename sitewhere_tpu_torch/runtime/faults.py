"""Deterministic fault injection: seeded, schedule-driven fault plans.

The port's copy of `sitewhere_tpu/runtime/faults.py` (and of
`runtime/bus.py:jittered`, the retry backoff the engine uses). A
:class:`FaultPlan` is a seeded schedule over *named fault points* threaded
through the hot path and control plane:

  pack_fail             host pack (batch -> wire blob)
  h2d_error             host -> device staging transfer
  dispatch_error        step dispatch (the graph replay on the card)
  lane_fetch_error      the alert + command lane D2H fetch
  busnet_drop           bus server eats a response (lost-reply)
  busnet_delay          bus server stalls before replying
  busnet_partition      bus server refuses every op for a window
  checkpoint_torn_write checkpoint dir renamed with truncated state
  feeder_thread_death   pipelined-feeder stager thread dies
  rest_worker_stall     REST worker thread stalls mid-request

The points the port does not run yet (bus, checkpoint, REST, feeder
processes, command delivery) stay in the vocabulary so a plan written for
the reference loads unchanged. Disarmed, :func:`fault_point` is one
module-global load and an identity test — no dict lookup, no allocation,
no lock.

Determinism: each fault point draws from its own ``random.Random``
stream keyed (seed, point), and fires are further gated by exact
``after`` / ``times`` hit windows, so a drill's schedule replays
bit-for-bit from its seed regardless of thread interleaving elsewhere —
the same calls fire under the same plan here as in the reference.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

FAULT_POINTS = (
    "pack_fail",
    "h2d_error",
    "dispatch_error",
    "lane_fetch_error",
    "busnet_drop",
    "busnet_delay",
    "busnet_partition",
    "checkpoint_torn_write",
    "feeder_thread_death",
    "feeder_process_death",
    "rest_worker_stall",
    "command_delivery_error",
)

# points whose firing is an *error* raised into the caller (the rest are
# directives the call site interprets: delays, drops, windows)
_RAISING_POINTS = frozenset((
    "pack_fail", "h2d_error", "dispatch_error", "lane_fetch_error",
    "checkpoint_torn_write", "feeder_thread_death",
    # feeder_process_death extends the thread-death drill to feeder
    # PROCESSES: fired mid-blob in the feeder worker's ship loop, the
    # worker dies WITHOUT committing or releasing its lease (os._exit in
    # `serve --feeder`; abandoned thread in the in-proc drill) — the
    # takeover path, not the error path, must recover it.
    "feeder_process_death",
    # raised into CommandFanout's per-fire delivery attempt: the fan-out
    # retries in line, then parks the fire on the dead-letter list — the
    # drill asserts delivered + parked == lane rows (conservation)
    "command_delivery_error",
))


class FaultError(RuntimeError):
    """An injected fault. Distinct from organic errors so drills can
    assert the failure they observed is the one they scheduled."""

    def __init__(self, point: str):
        super().__init__(f"injected fault: {point}")
        self.point = point


class FaultRule:
    """One schedule entry: fire `point` with probability `p` on each hit,
    skipping the first `after` hits, at most `times` fires total.
    `delay_s` is the stall for delay-mode points; `duration_s` opens a
    window (busnet_partition) instead of firing per-hit."""

    __slots__ = ("point", "p", "times", "after", "delay_s", "duration_s",
                 "hits", "fires", "window_until", "_rng")

    def __init__(self, point: str, p: float = 1.0,
                 times: Optional[int] = None, after: int = 0,
                 delay_s: float = 0.0, duration_s: float = 0.0):
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point '{point}' "
                             f"(known: {', '.join(FAULT_POINTS)})")
        self.point = point
        self.p = float(p)
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.delay_s = float(delay_s)
        self.duration_s = float(duration_s)
        self.hits = 0
        self.fires = 0
        self.window_until = 0.0
        self._rng: Optional[random.Random] = None

    def bind(self, seed: int) -> None:
        # per-point stream: concurrent draws at OTHER points never
        # perturb this point's schedule
        self._rng = random.Random(f"{seed}:{self.point}")

    def should_fire(self) -> bool:
        self.hits += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.hits <= self.after:
            return False
        if self.p < 1.0:
            rng = self._rng or random.Random(self.point)
            if rng.random() >= self.p:
                return False
        self.fires += 1
        return True

    def to_json(self) -> Dict:
        return {"point": self.point, "p": self.p, "times": self.times,
                "after": self.after, "delay_s": self.delay_s,
                "duration_s": self.duration_s,
                "hits": self.hits, "fires": self.fires}


class FaultPlan:
    """A seeded set of :class:`FaultRule` entries, armed process-wide via
    :func:`arm`. Thread-safe: rule bookkeeping is tiny and guarded by one
    lock only on the armed (drill) path — the disarmed path never enters
    this class."""

    def __init__(self, seed: int = 0,
                 rules: Optional[List[FaultRule]] = None):
        self.seed = int(seed)
        self._rules: Dict[str, List[FaultRule]] = {}
        self._lock = threading.Lock()
        for rule in rules or []:
            self.add(rule)

    @classmethod
    def from_json(cls, doc: Dict) -> "FaultPlan":
        rules = []
        for r in doc.get("rules", []):
            rules.append(FaultRule(
                r["point"], p=r.get("p", 1.0), times=r.get("times"),
                after=r.get("after", 0), delay_s=r.get("delay_s", 0.0),
                duration_s=r.get("duration_s", 0.0)))
        return cls(seed=doc.get("seed", 0), rules=rules)

    def add(self, rule: FaultRule) -> None:
        rule.bind(self.seed)
        self._rules.setdefault(rule.point, []).append(rule)

    def check(self, point: str) -> Optional[FaultRule]:
        """The armed-path half of :func:`fault_point`: returns the rule
        that fired (None otherwise). Window-mode rules report fired for
        the whole open window."""
        rules = self._rules.get(point)
        if not rules:
            return None
        with self._lock:
            now = time.monotonic()
            for rule in rules:
                if rule.duration_s > 0.0:
                    if now < rule.window_until:
                        return rule
                    if rule.should_fire():
                        rule.window_until = now + rule.duration_s
                        return rule
                elif rule.should_fire():
                    return rule
        return None

    def report(self) -> Dict:
        with self._lock:
            return {"seed": self.seed,
                    "rules": [r.to_json()
                              for rs in self._rules.values() for r in rs]}


# Process-wide armed plan. None (the common case) keeps fault_point a
# two-instruction no-op; drills swap in a plan via arm()/disarm().
_ACTIVE: Optional[FaultPlan] = None
_INJECTED = GLOBAL_METRICS.counter("faults.injected")


def arm(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def fault_point(point: str) -> Optional[FaultRule]:
    """Hot-path hook. Disarmed: one global load + identity test, nothing
    else. Armed: raising points
    raise :class:`FaultError`; delay-mode points sleep `delay_s` then
    return; directive points (busnet_drop/partition) return the fired
    rule for the call site to interpret."""
    plan = _ACTIVE
    if plan is None:
        return None
    rule = plan.check(point)
    if rule is None:
        return None
    _INJECTED.inc()
    # per-point counters are computed names; the `faults.point.` prefix
    # convention is the reference's (docs/OBSERVABILITY.md)
    GLOBAL_METRICS.counter(f"faults.point.{point}").inc()
    if rule.delay_s > 0.0 and point not in _RAISING_POINTS:
        time.sleep(rule.delay_s)
        return rule
    if point in _RAISING_POINTS:
        raise FaultError(point)
    return rule


def jittered(backoff_s: float) -> float:
    """Equal-jitter a retry backoff into [backoff/2, backoff], so retries
    of many callers do not run in lockstep while keeping a floor of half
    the deterministic backoff (the reference's `runtime/bus.py:jittered`)."""
    return backoff_s * (0.5 + 0.5 * random.random())
