"""Inbound event sources: receivers -> decode -> dedup -> bus topics.

Reference flow (InboundEventSource.java:189-210 / :247-294):
  onEncodedEventReceived -> decodePayload -> [deduplicator] ->
  handleDecodedRequest: events -> DecodedEventsProducer,
  registrations -> deviceRegistrationProducer,
  decode failures -> onFailedDecode -> failed-decode topic.

Here the producers publish msgpack-serialized requests onto the in-proc bus
(runtime/bus.py) keyed by device token, preserving per-device ordering into
the TPU packing stage downstream (pipeline/inbound.py; bulk alternative:
sources/fastlane.py).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import msgpack

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.common import _asdict
from sitewhere_tpu_torch.model.event import (
    DeviceCommandResponse, DeviceEventBatch, DeviceRegistrationRequest,
    DeviceStreamData)
from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
from sitewhere_tpu_torch.runtime.flight import GLOBAL_FLIGHT
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS, MetricsRegistry
from sitewhere_tpu_torch.runtime.recovery import take_dedup_seed
from sitewhere_tpu_torch.sources.decoders import DecodedRequest, DecodeError


class IngestShedError(SiteWhereError):
    """Client-visible NACK for an ingest request shed under overload —
    maps to HTTP 429 through the REST error path, and to a counted drop
    for fire-and-forget receivers (MQTT-style QoS contract)."""

    def __init__(self, message: str = "ingest shed: pipeline over budget"):
        super().__init__(message, http_status=429)


class AdmissionController:
    """Front-door overload shedding for event ingest.

    The reference gets backpressure for free from Kafka's bounded producer
    buffer; the in-proc bus is unbounded, so without a front door a slow
    fused step lets the decoded-events backlog (and its memory) grow
    without limit while client latency silently rots. This controller
    sheds AT ADMISSION — a counted, client-visible 429/NACK — when either
    budget is breached:

      * ``step_budget_ms``   — the flight recorder's mean per-step sync
        cost (``sync_total_ms.sum_of_stages`` over the last ``window``
        steps) exceeds the budget: the pipeline itself is too slow.
      * ``queue_depth_budget`` — the pluggable ``queue_depth`` provider
        (typically the decoded-events topic backlog) exceeds the budget:
        the pipeline is fine but ingest is outrunning it.

    ``admit()`` amortizes the rollup read by caching the decision for
    ``check_every`` admissions; disabled (both budgets zero — the
    default) it is two attribute loads, cheap enough for the perf gate's
    ``fault_injection_overhead`` pin. Module singleton ``GLOBAL_ADMISSION``
    mirrors GLOBAL_METRICS/GLOBAL_FLIGHT: sources are built deep inside
    tenant engines with no instance handle to thread a controller
    through."""

    def __init__(self, flight=None, step_budget_ms: float = 0.0,
                 queue_depth_budget: int = 0, queue_depth=None,
                 check_every: int = 64, window: int = 32):
        self._flight = flight
        self.step_budget_ms = float(step_budget_ms)
        self.queue_depth_budget = int(queue_depth_budget)
        self.queue_depth = queue_depth
        self.check_every = max(1, int(check_every))
        self.window = int(window)
        self._lock = threading.Lock()
        self._admits = 0
        self._shedding = False
        self._last_step_ms = 0.0
        self._last_depth = 0
        self._shed_counter = GLOBAL_METRICS.counter("admission.shed")
        self._remote_shed_counter = GLOBAL_METRICS.counter(
            "admission.shed_remote")

    @property
    def enabled(self) -> bool:
        return self.step_budget_ms > 0.0 or self.queue_depth_budget > 0

    def configure(self, step_budget_ms: Optional[float] = None,
                  queue_depth_budget: Optional[int] = None,
                  queue_depth=None, check_every: Optional[int] = None
                  ) -> None:
        """Rewire budgets (instance boot / tests). Passing None leaves a
        field unchanged; the cached decision resets either way."""
        with self._lock:
            if step_budget_ms is not None:
                self.step_budget_ms = float(step_budget_ms)
            if queue_depth_budget is not None:
                self.queue_depth_budget = int(queue_depth_budget)
            if queue_depth is not None:
                self.queue_depth = queue_depth
            if check_every is not None:
                self.check_every = max(1, int(check_every))
            self._admits = 0
            self._shedding = False

    def _refresh(self) -> None:
        breach = False
        if self.step_budget_ms > 0.0:
            flight = self._flight or GLOBAL_FLIGHT
            roll = flight.export(last_n=self.window).get("rollups", {})
            if roll.get("steps", 0):
                self._last_step_ms = float(
                    roll["sync_total_ms"]["sum_of_stages"])
                breach = self._last_step_ms > self.step_budget_ms
        if not breach and self.queue_depth_budget > 0 \
                and self.queue_depth is not None:
            try:
                self._last_depth = int(self.queue_depth())
            except Exception:
                self._last_depth = 0
            breach = self._last_depth > self.queue_depth_budget
        self._shedding = breach

    def admit(self) -> bool:
        """One admission decision; False means shed (the caller counts it
        per-source and raises IngestShedError). Refreshes from the flight
        rollups every ``check_every`` calls."""
        if not self.enabled:
            return True
        with self._lock:
            if self._admits % self.check_every == 0:
                self._refresh()
            self._admits += 1
            if self._shedding:
                self._shed_counter.inc()
                return False
            return True

    def admit_remote(self) -> bool:
        """Admission decision for a REMOTE producer (a feeder shipping a
        packed blob over busnet, feeders/service.py). Same budgets and
        cadence as admit(); a shed is additionally counted under
        `admission.shed_remote` so operators can tell propagated
        structured-429 refusals from local front-door sheds — the remote
        refusal happens before the payload is even decoded, where the
        local path sheds before pack."""
        ok = self.admit()
        if not ok:
            self._remote_shed_counter.inc()
        return ok

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "shedding": self._shedding,
                "step_budget_ms": self.step_budget_ms,
                "last_step_ms": round(self._last_step_ms, 3),
                "queue_depth_budget": self.queue_depth_budget,
                "last_queue_depth": self._last_depth,
                "shed_total": self._shed_counter.value,
                "check_every": self.check_every,
            }


GLOBAL_ADMISSION = AdmissionController()


def _pack_request(source_id: str, request: DecodedRequest) -> bytes:
    req = request.request
    kind = type(req).__name__
    return msgpack.packb({
        "sourceId": source_id,
        "deviceToken": request.device_token,
        "kind": kind,
        "request": _asdict(req),
        "metadata": request.metadata,
    }, use_bin_type=True)


class InboundEventSource(LifecycleComponent):
    """One configured event source: N receivers + decoder (+ deduplicator).

    Receivers call `on_encoded_event_received(payload, metadata)` from any
    thread; routing onto the bus is thread-safe.
    """

    def __init__(self, source_id: str, decoder, receivers: List[Any],
                 bus: EventBus, naming: Optional[TopicNaming] = None,
                 tenant: str = "default", deduplicator=None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"event-source:{source_id}")
        self.source_id = source_id
        self.decoder = decoder
        self.receivers = receivers
        self.deduplicator = deduplicator
        self.bus = bus
        self.naming = naming or TopicNaming()
        self.tenant = tenant
        m = (metrics or MetricsRegistry()).scoped(f"source.{source_id}")
        self.decoded_meter = m.meter("decoded")
        self.failed_counter = m.counter("failed_decode")
        self.duplicate_counter = m.counter("duplicates")
        self.shed_counter = m.counter("shed")

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        # a boot restore may have staged this source's checkpointed
        # recent-duplicate window (runtime/recovery.py): claim it before
        # receivers deliver, or the first post-crash duplicates slip by
        restore = getattr(self.deduplicator, "restore_window", None)
        if restore is not None:
            seed = take_dedup_seed(self.tenant, self.source_id)
            if seed:
                restore(seed)
        for receiver in self.receivers:
            receiver.bind(self)
            receiver.start()

    def on_stop(self, monitor) -> None:
        for receiver in self.receivers:
            receiver.stop()

    # -- ingest ------------------------------------------------------------
    def on_encoded_event_received(self, payload: bytes,
                                  metadata: Optional[Dict[str, str]] = None
                                  ) -> None:
        """Receiver entry point (InboundEventSource.onEncodedEventReceived)."""
        try:
            requests = self.decoder.decode(payload, metadata)
        except DecodeError as exc:
            self.failed_counter.inc()
            self.bus.publish(
                self.naming.event_source_failed_decode_events(self.tenant),
                b"", msgpack.packb({"sourceId": self.source_id,
                                    "error": str(exc), "payload": payload},
                                   use_bin_type=True))
            return
        for request in requests:
            if metadata:  # receiver context (e.g. mqtt.topic) rides along
                request.metadata = {**metadata, **request.metadata}
            try:
                self.handle_decoded_request(request)
            except IngestShedError:
                # fire-and-forget receiver threads (MQTT-style) have no
                # reply channel: the shed is already counted per-source
                # and globally; swallowing keeps the receiver loop alive
                pass

    def handle_decoded_request(self, request: DecodedRequest) -> None:
        if isinstance(request.request, (DeviceEventBatch,
                                        DeviceCommandResponse,
                                        DeviceStreamData)) \
                and not GLOBAL_ADMISSION.admit():
            # event traffic only — registrations are rare control-plane
            # requests and always admit
            self.shed_counter.inc()
            raise IngestShedError(
                f"ingest shed at source '{self.source_id}': "
                "pipeline over budget")
        if self.deduplicator is not None:
            if self.deduplicator.is_duplicate(request):
                self.duplicate_counter.inc()
                return
        key = request.device_token.encode()
        payload = _pack_request(self.source_id, request)
        req = request.request
        if isinstance(req, DeviceRegistrationRequest):
            topic = self.naming.inbound_device_registration_events(self.tenant)
        elif isinstance(req, (DeviceEventBatch, DeviceCommandResponse,
                              DeviceStreamData)):
            topic = self.naming.event_source_decoded_events(self.tenant)
            self.decoded_meter.mark(
                len(req.all_events()) if isinstance(req, DeviceEventBatch)
                else 1)
        else:
            raise TypeError(f"undecodable request type {type(req).__name__}")
        self.bus.publish(topic, key, payload)
        if self.deduplicator is not None:
            self.deduplicator.remember(request)  # only after acceptance


class EventSourcesManager(LifecycleComponent):
    """Hosts all event sources of one tenant (EventSourcesManager.java)."""

    def __init__(self, sources: Optional[List[InboundEventSource]] = None):
        super().__init__("event-sources-manager")
        self.sources: List[InboundEventSource] = []
        for source in sources or []:
            self.add_source(source)

    def add_source(self, source: InboundEventSource) -> None:
        self.sources.append(source)
        self.add_nested(source)

    def source(self, source_id: str) -> Optional[InboundEventSource]:
        for s in self.sources:
            if s.source_id == source_id:
                return s
        return None
