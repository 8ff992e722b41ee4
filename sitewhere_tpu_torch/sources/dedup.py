"""Event deduplicators (IDeviceEventDeduplicator).

Reference: deduplicator/AlternateIdDeduplicator.java — checks the event
store for an existing event with the same alternate id — and
GroovyEventDeduplicator.java (scripted predicate). Here the alternate-id
check is a bounded in-memory set backed by an optional event-management
lookup, so the hot path stays off the store for recent duplicates.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from sitewhere_tpu_torch.model.event import DeviceEventBatch
from sitewhere_tpu_torch.sources.decoders import DecodedRequest


class AlternateIdDeduplicator:
    """Duplicate if any event in the request carries an alternate_id seen
    before (recent-window LRU, then the event store)."""

    def __init__(self, event_management=None, window: int = 100_000):
        self.event_management = event_management
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._window = window

    def _alternate_ids(self, request: DecodedRequest):
        req = request.request
        if isinstance(req, DeviceEventBatch):
            for ev in req.all_events():
                if ev.alternate_id:
                    yield ev.alternate_id
        elif getattr(req, "alternate_id", ""):
            yield req.alternate_id

    def is_duplicate(self, request: DecodedRequest) -> bool:
        """Pure check — does NOT record the request's ids. Callers must
        invoke remember() only after the request is accepted; otherwise a
        rejected mixed batch would poison the window and a later retry of
        its never-persisted events would be dropped."""
        for alt in self._alternate_ids(request):
            if alt in self._seen:
                return True
            if (self.event_management is not None and
                    self.event_management.get_event_by_alternate_id(alt)
                    is not None):
                self._remember(alt)  # store-confirmed duplicate: cache it
                return True
        return False

    def remember(self, request: DecodedRequest) -> None:
        """Record an ACCEPTED request's alternate ids."""
        for alt in self._alternate_ids(request):
            self._remember(alt)

    def _remember(self, alt: str) -> None:
        self._seen[alt] = None
        self._seen.move_to_end(alt)
        while len(self._seen) > self._window:
            self._seen.popitem(last=False)

    # -- checkpoint ride-along -----------------------------------------
    # The LRU window is process-local; without carrying it through the
    # instance checkpoint, every crash forgets the recent-duplicate set
    # and re-admits duplicates the store lookup is too slow to catch.
    def export_window(self, limit: Optional[int] = None) -> List[str]:
        """Oldest-first recent-id window, optionally truncated to the
        NEWEST `limit` entries (bounded checkpoint payload)."""
        ids = list(self._seen)
        if limit is not None and len(ids) > limit:
            ids = ids[-limit:]
        return ids

    def restore_window(self, ids: Iterable[str]) -> None:
        """Re-seed the window (oldest-first order preserves LRU age)."""
        for alt in ids:
            self._remember(alt)


class SequenceWatermarkDeduplicator:
    """Duplicate if the request carries a replayed `(id_prefix, id_seq)`
    at-or-below a per-prefix high-watermark.

    The eventlog stamps every persisted row with a process-unique
    `id_prefix` and a monotonic `id_seq`; the instance checkpoint
    captures the per-prefix maxima. After a crash-replay, stragglers
    that slipped past the replay barrier (a partial batch at the budget
    boundary) still identify themselves by a watermarked source row —
    this deduplicator drops them, the post-replay half of the
    exactly-once-effects contract. Requests without sequence metadata
    (live traffic from a new incarnation) always pass."""

    def __init__(self,
                 watermarks: Optional[Dict[str, int]] = None):
        self._marks: Dict[str, int] = {
            p: int(s) for p, s in (watermarks or {}).items()}

    def _sequence_of(self, request: DecodedRequest
                     ) -> Optional[Tuple[str, int]]:
        meta = getattr(request, "metadata", None) or {}
        prefix = meta.get("id_prefix")
        seq = meta.get("id_seq")
        if prefix is None or seq is None:
            return None
        return str(prefix), int(seq)

    def is_duplicate(self, request: DecodedRequest) -> bool:
        seq = self._sequence_of(request)
        if seq is None:
            return False
        return self.is_duplicate_row(*seq)

    def is_duplicate_row(self, prefix: str, seq: int) -> bool:
        mark = self._marks.get(prefix)
        return mark is not None and int(seq) <= mark

    def observe(self, prefix: str, seq: int) -> None:
        if int(seq) > self._marks.get(prefix, -1):
            self._marks[prefix] = int(seq)

    def merge(self, watermarks: Dict[str, int]) -> None:
        for prefix, seq in watermarks.items():
            self.observe(prefix, seq)

    def export(self) -> Dict[str, int]:
        return dict(self._marks)

    def remember(self, request: DecodedRequest) -> None:
        seq = self._sequence_of(request)
        if seq is not None:
            self.observe(*seq)


class ScriptedDeduplicator:
    """Predicate-callable deduplicator (GroovyEventDeduplicator):
    `fn(request) -> True if duplicate`."""

    def __init__(self, fn: Callable[[DecodedRequest], bool]):
        self.fn = fn

    def is_duplicate(self, request: DecodedRequest) -> bool:
        return bool(self.fn(request))

    def remember(self, request: DecodedRequest) -> None:
        pass  # scripted predicates carry their own state
