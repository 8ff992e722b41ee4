"""Per-engine health state machine: healthy → degraded → draining → failed.

The degradation ladder the fault drills exercise:

  healthy    steady state; every submit lands first try
  degraded   transient failures being absorbed — the engine is retrying
             (H2D / dispatch) or the admission controller is shedding
  draining   poison work is being moved aside: a batch exhausted its
             retry budget and parked on a dead-letter topic; the engine
             keeps stepping but an operator owes it a replay
  failed     a step failure survived every retry AND could not be parked
             (or state was lost mid-donation) — sticky until reset()

Recovery: `recover_after` consecutive clean submits walk degraded or
draining back to healthy. `failed` never self-clears — the supervisor
(gang restart) or an operator reset is the only way back, mirroring the
reference's tenant-engine failed state.

The port's copy of `sitewhere_tpu/runtime/health.py`: the same ladder,
codes (0=healthy 1=degraded 2=draining 3=failed) and `recover_after`,
each transition counted on the engine-scoped ``health_transitions``
counter.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

LOGGER = logging.getLogger("sitewhere.health")

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
FAILED = "failed"

STATE_ORDER = (HEALTHY, DEGRADED, DRAINING, FAILED)
STATE_CODES = {name: i for i, name in enumerate(STATE_ORDER)}


class EngineHealth:
    """Tiny lock-guarded state machine; note_* calls are O(1) and only
    appear on failure paths (note_success is a counter bump + one branch,
    cheap enough for every submit)."""

    def __init__(self, name: str, metrics=None, recover_after: int = 8,
                 ring_size: int = 32):
        self.name = name
        self.recover_after = int(recover_after)
        self.state = HEALTHY
        self.transitions = 0
        self.last_transition_ms: Optional[int] = None
        self.last_cause: Optional[str] = None
        # recent transitions (state, cause, timestamp) for post-incident
        # triage — counters say HOW MANY, the ring says WHAT happened
        self._ring: "deque[Dict]" = deque(maxlen=int(ring_size))
        self._streak = 0  # consecutive clean submits while impaired
        self._lock = threading.Lock()
        self._transition_counter = (
            metrics.counter("health_transitions") if metrics is not None
            else None)

    @property
    def code(self) -> int:
        return STATE_CODES[self.state]

    def _move(self, state: str, cause: str) -> None:
        # caller holds the lock
        if self.state == state:
            return
        LOGGER.info("engine '%s' health %s -> %s (%s)",
                    self.name, self.state, state, cause)
        self.state = state
        self.transitions += 1
        self.last_transition_ms = int(time.time() * 1000)
        self.last_cause = cause
        self._ring.append({"state": state, "cause": cause,
                           "at_ms": self.last_transition_ms})
        self._streak = 0
        if self._transition_counter is not None:
            self._transition_counter.inc()

    # -- events --------------------------------------------------------
    def note_success(self) -> None:
        if self.state == HEALTHY:
            return
        with self._lock:
            if self.state in (DEGRADED, DRAINING):
                self._streak += 1
                if self._streak >= self.recover_after:
                    self._move(HEALTHY, "recovered")

    def note_retry(self, cause: str = "transient step failure") -> None:
        with self._lock:
            if self.state == HEALTHY:
                self._move(DEGRADED, cause)
            else:
                self._streak = 0

    def note_shed(self) -> None:
        with self._lock:
            if self.state == HEALTHY:
                self._move(DEGRADED, "admission shedding")
            else:
                self._streak = 0

    def note_poison(self, cause: str = "batch parked on dead-letter"
                    ) -> None:
        with self._lock:
            if self.state != FAILED:
                self._move(DRAINING, cause)

    def note_fatal(self, cause: str = "unrecoverable step failure") -> None:
        with self._lock:
            self._move(FAILED, cause)

    def reset(self) -> None:
        with self._lock:
            self._move(HEALTHY, "operator reset")

    def recent_transitions(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def to_json(self) -> Dict:
        return {"state": self.state, "code": self.code,
                "transitions": self.transitions,
                "last_transition_ms": self.last_transition_ms,
                "last_cause": self.last_cause,
                "recent": self.recent_transitions()}
