"""H2D staging-buffer ring: bounded, ordered, guarded slots.

Counterpart of `sitewhere_tpu/pipeline/staging.py`, with the same grant
order, backpressure, counters and guard-free release on error paths. Every
staged transfer on the hot path (`PipelineEngine.stage_blob`, which the
pipelined feeder calls) first acquires a ring slot; the ring bounds how
many transfers can be in flight (backpressure when full), keeps each
slot's fixed device destination for reuse, and preserves dispatch order
via ordered acquisition.

Why ordered acquisition matters: stagers pack concurrently, so the
stager holding sequence N can reach the ring AFTER the stagers holding
N+1 and N+2. Granting free slots in arrival order could then fill the
ring with later sequences while the step thread waits for N — every
slot held by a step that cannot dispatch until N does. ``acquire``
therefore grants a free slot to the LOWEST pending order key; callers
without an order (serial submit paths) draw keys from a high counter so
they never starve an ordered feeder. The feeder additionally bounds its
stage-ahead window to the ring depth (pipeline/feed.py), so the earliest
unstaged sequence always finds a slot.

On the card a slot owns its fixed device buffers (`RingSlot.buffers`, one
a card: the single engine's [WIRE_ROWS, B] int32, a sharded engine's one
a card block; allocated at the slot's first use and reused across steps);
the H2D copy runs on a side stream into a view of each, and the
guard is a `torch.cuda.Event` recorded after the consuming step on the
compute stream. Where the reference blocks on a guard
(`block_until_ready()`), this ring calls `guard.synchronize()`. On the CPU
the engine stages plain copies and releases with no guard.

Slot lifecycle::

    acquire(order)        wait for a free slot (counting full_waits and
                          marking the flight "stage_wait" segment when
                          the ring is full), then wait on the slot's
                          guard (recorded after the previous consumer)
                          and drop the previous transfer's view
    slot.device_blob = .. the transfer's device tensor parks here
    release(guard)        slot returns to the free pool; `guard` is the
                          consuming step's event (or None on an error
                          path — reuse then skips the guard wait)
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional

# order keys for callers that do not pass one (serial submit paths):
# drawn from a counter starting far above any plausible feeder sequence,
# so an ordered feeder's keys always win the grant when both wait
_UNORDERED_BASE = 1 << 60


class RingSlot:
    """One staging destination: its fixed buffers, one a card (none until
    the engine allocates them; the single engine allocates none on the
    CPU), the transfer most recently staged into this slot, and the guard
    proving its consumer is done with it."""

    __slots__ = ("index", "buffers", "device_blob", "guard", "in_flight")

    def __init__(self, index: int) -> None:
        self.index = index
        # fixed device destinations, one a card (empty until the engine
        # allocates them)
        self.buffers = []
        self.device_blob = None   # last transfer staged here
        self.guard = None         # consuming step's event
        self.in_flight = False


class StagedBlob:
    """Handle for a wire blob whose H2D transfer went through a ring slot
    (PipelineEngine.stage_blob): `blob` is the device tensor, `ready` the
    event recorded after its copy on the H2D stream (None on the CPU),
    `slot`/`ring` let submit_blob release the slot with the consuming
    step's event as the reuse guard."""

    __slots__ = ("blob", "slot", "ring", "ready")

    def __init__(self, blob, slot: RingSlot, ring: "StagingRing",
                 ready=None) -> None:
        self.blob = blob
        self.slot = slot
        self.ring = ring
        self.ready = ready


class StagingRing:
    """Fixed-depth ring of staging slots with ordered, backpressured
    acquisition (module docstring has the full contract).

    `metrics` is the owning engine's scoped registry; the ring counts
    `staging_ring.full_waits` there (every acquire that found no free
    slot) so a stalled ring is visible per engine.
    """

    def __init__(self, depth: int, metrics=None) -> None:
        self.depth = max(1, int(depth))
        self._slots = [RingSlot(i) for i in range(self.depth)]
        self._free: List[RingSlot] = list(self._slots)
        self._cv = threading.Condition()
        self._waiters: List = []              # heap of (key, tiebreak)
        self._tiebreak = itertools.count()
        self._unordered = itertools.count(_UNORDERED_BASE)
        self.full_waits = 0
        self.acquires = 0
        self._full_counter = (metrics.counter("staging_ring.full_waits")
                              if metrics is not None else None)

    # -- hot path -----------------------------------------------------
    def acquire(self, order: Optional[int] = None, flight_rec=None,
                blocking: bool = True) -> Optional[RingSlot]:
        """Take a free slot, granting in `order` (lowest pending key
        first). Blocks while the ring is full — the backpressure edge —
        counting `full_waits` and marking the flight record's
        "stage_wait" segment. `blocking=False` returns None instead of
        waiting. After the grant, waits on the slot's guard so the
        previous occupant's consumer is provably done before its buffer
        is written again."""
        key = (order if order is not None else next(self._unordered),
               next(self._tiebreak))
        waited = False
        with self._cv:
            if not blocking:
                if not self._free:
                    return None
                slot = self._free.pop(0)
                slot.in_flight = True
            else:
                heapq.heappush(self._waiters, key)
                while not (self._free and self._waiters[0] == key):
                    if not waited and not self._free:
                        # the ring-full wait is the backpressure signal;
                        # an ordering wait (slot free, earlier sequence
                        # pending) is not "full" and stays uncounted
                        waited = True
                        self.full_waits += 1
                        if self._full_counter is not None:
                            self._full_counter.inc()
                        if flight_rec is not None:
                            flight_rec.begin_stage("stage_wait")
                    self._cv.wait(timeout=0.1)
                heapq.heappop(self._waiters)
                slot = self._free.pop(0)
                slot.in_flight = True
                self._cv.notify_all()   # next-lowest waiter re-checks
            self.acquires += 1
        if waited and flight_rec is not None:
            flight_rec.end_stage("stage_wait")
        guard, slot.guard = slot.guard, None
        if guard is not None:
            # reuse must wait for the slot's previous consumer; by the
            # time a ring cycles back this is almost always done
            if flight_rec is not None:
                flight_rec.begin_stage("guard")
            try:
                guard.synchronize()
            except Exception:
                pass  # a failed step still implies the transfer finished
            if flight_rec is not None:
                flight_rec.end_stage("guard")
        slot.device_blob = None
        return slot

    def release(self, slot: RingSlot, guard=None) -> None:
        """Return `slot` to the free pool. `guard` is the consuming step's
        event; None (error paths) makes the next reuse skip the guard
        wait."""
        with self._cv:
            if not slot.in_flight:
                return  # double-release guard (error-path idempotence)
            slot.guard = guard
            slot.in_flight = False
            self._free.append(slot)
            self._cv.notify_all()

    # -- telemetry ----------------------------------------------------
    def occupancy(self) -> int:
        """Slots currently acquired (in flight)."""
        with self._cv:
            return self.depth - len(self._free)

    def resident_bytes(self, card: Optional[int] = None) -> int:
        """Device bytes the ring holds (the HBM ledger's `staging_ring`
        row): each slot's fixed buffers (with `card`, only its buffer on
        that card block), or, for a slot without any, the transfer parked
        in it."""
        total = 0
        for slot in self._slots:
            held = slot.buffers or [slot.device_blob]
            if card is not None and slot.buffers:
                held = held[card:card + 1]
            total += sum(int(getattr(h, "nbytes", 0) or 0) for h in held)
        return total

    def state(self) -> dict:
        """Snapshot for diagnosis: per-slot in-flight bits plus the
        backpressure counters — a stalled ring shows every slot in flight
        and `full_waits` climbing."""
        with self._cv:
            return {
                "depth": self.depth,
                "occupancy": self.depth - len(self._free),
                "in_flight": [s.in_flight for s in self._slots],
                "full_waits": self.full_waits,
                "acquires": self.acquires,
            }
