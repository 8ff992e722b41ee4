"""Bulk wire-frame ingest lane: bytes -> packed EventBatch, no per-event
Python objects.

Counterpart of `sitewhere_tpu/sources/fastlane.py`. The reference decodes
every event payload into Java POJOs and hands them through Kafka stage by
stage (InboundEventSource.onEncodedEventReceived ->
ProtobufDeviceEventDecoder -> DecodedEventsProducer, InboundEventSource.java
:189-294); this lane is the batch alternative: the native single-pass frame
decode (`native.decode_hot_frames`), batched token interning straight off
the decoder's (bytes, offsets) columns, and `EventPacker.pack_columns`. It
has no Python lane: the plain decoder (transport/wire.py) is what the tests
hold the native one against.

Control frames (registration, acks, stream data) are surfaced to the caller
for the normal object path — they are rare and not throughput-critical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.ops.pack import EventBatch, EventPacker
from sitewhere_tpu_torch.runtime.bus import TopicNaming
from sitewhere_tpu_torch.runtime.eventage import (AgeSidecar, age_histogram,
                                            observe_summary)
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS, MetricsRegistry
from sitewhere_tpu_torch.runtime.tracing import GLOBAL_TRACER
from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireError, encode_frame)


@dataclass
class FastIngestResult:
    batches: List[EventBatch] = field(default_factory=list)
    n_events: int = 0
    # control frames for the object path: (MessageType value, payload bytes)
    control_frames: List[Tuple[int, bytes]] = field(default_factory=list)
    # bytes of a trailing partial frame the caller must keep buffered
    remainder: bytes = b""
    # device tokens of all hot events as (joined bytes, offsets[n+1]);
    # row i of the concatenated batches is tokens[offsets[i]:offsets[i+1]]
    # (kept in columnar form so the rare consumers — unregistered-device
    # routing — pay the string cost, not the hot path)
    tokens: Tuple[bytes, np.ndarray] = (b"", None)

    def token_at(self, row: int) -> str:
        buf, off = self.tokens
        return buf[int(off[row]):int(off[row + 1])].decode(
            errors="surrogateescape")


class FastWireIngest:
    """Turn concatenated wire frames into ready-to-submit EventBatches.

    Device tokens are looked up (NOT interned — unknown devices must stay
    index 0 so the pipeline flags them unregistered, pipeline/step.py
    stage 1); measurement names and alert types are interned on the fly like
    `EventPacker.pack_events` does.
    """

    def __init__(self, packer: EventPacker):
        self.packer = packer

    def ingest(self, data: bytes) -> FastIngestResult:
        from sitewhere_tpu_torch import native

        cols = native.decode_hot_frames(data)
        res = FastIngestResult(control_frames=cols.others,
                               remainder=data[cols.consumed:],
                               n_events=cols.n, tokens=cols.tokens)
        if cols.n == 0:
            return res
        tok_buf, tok_off = cols.tokens
        device_idx = self.packer.devices.lookup_offsets(tok_buf, tok_off)
        name_buf, name_off = cols.names
        mm_idx = self.packer.measurements.intern_offsets(
            name_buf, name_off, skip_empty=True)
        at_buf, at_off = cols.alert_types
        alert_type_idx = self.packer.alert_types.intern_offsets(
            at_buf, at_off, skip_empty=True)
        res.batches = self._pack(
            device_idx, cols.event_type, cols.ts_ms, mm_idx, cols.value,
            cols.lat, cols.lon, cols.elevation, alert_type_idx,
            cols.alert_level)
        return res

    # -- packing -----------------------------------------------------------

    def _pack(self, device_idx, event_type, ts_ms, mm_idx, value, lat, lon,
              elevation, alert_type_idx, alert_level) -> List[EventBatch]:
        B = self.packer.batch_size
        out: List[EventBatch] = []
        for s in range(0, len(device_idx), B):
            e = s + B
            out.append(self.packer.pack_columns(
                device_idx[s:e], event_type[s:e], ts_ms[s:e],
                mm_idx=mm_idx[s:e], value=value[s:e], lat=lat[s:e],
                lon=lon[s:e], elevation=elevation[s:e],
                alert_type_idx=alert_type_idx[s:e],
                alert_level=alert_level[s:e]))
        return out


class BulkWireIngestService(LifecycleComponent):
    """A receiver sink that runs the bulk lane end-to-end.

    Receivers deliver raw wire bytes here (same `on_encoded_event_received`
    contract as InboundEventSource); each delivery is decoded in bulk,
    submitted to the fused pipeline step, and appended to the columnar event
    log — the high-rate alternative to the object pipeline
    (sources/manager.py -> bus -> pipeline/inbound.py), the way the
    reference's BulkEventStorageStrategy is the alternative to
    UnaryEventStorageStrategy (service-inbound-processing).

    Control frames (registration etc.) are re-framed and handed to
    `control_sink` — typically InboundEventSource.on_encoded_event_received
    of a normal source, so registration/acks flow the standard path.
    Unregistered hot events route their tokens to the unregistered topic.
    """

    def __init__(self, engine, eventlog=None, events=None, bus=None,
                 tenant: str = "default", naming=None, control_sink=None,
                 persist_rule_alerts: bool = True, registry=None,
                 metrics=None, persist_async: bool = False,
                 persist_depth: int = 8, trace_sample_n: int = 0):
        super().__init__(f"bulk-wire-ingest:{tenant}")
        self.engine = engine
        self.lane = FastWireIngest(engine.packer)
        self.eventlog = eventlog
        # persist_async moves the columnar append onto a writer thread
        # (persist/worker.py, the DeviceEventBuffer role) so the durable
        # append overlaps the next delivery's decode+step instead of
        # serializing after it; the bounded queue backpressures ingest
        # when the datastore is the bottleneck.
        self.persister = None
        if persist_async and eventlog is not None:
            from sitewhere_tpu_torch.persist.worker import AsyncEventPersister
            self.persister = self.add_nested(AsyncEventPersister(
                eventlog, engine.packer, tenant=tenant, bus=bus,
                naming=naming, registry=registry, depth=persist_depth,
                metrics=metrics))
        self.events = events
        self.registry = registry
        self.bus = bus
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.control_sink = control_sink
        self.persist_rule_alerts = persist_rule_alerts
        m = (metrics or MetricsRegistry()).scoped("bulk_ingest")
        self.events_meter = m.meter("events")
        self.unregistered_counter = m.counter("unregistered")
        self.failed_counter = m.counter("failed_decode")
        self._remainder = b""
        # ingest->effect age telemetry (runtime/eventage.py): the age
        # histogram lives on the SCRAPED registry (global by default)
        # under labels (engine, edge); journey tracing samples one
        # delivery in trace_sample_n with a span whose traceparent rides
        # any busnet RPC issued while processing it (0 = off).
        self._age_hist = age_histogram(metrics if metrics is not None
                                       else GLOBAL_METRICS)
        self._engine_label = getattr(engine, "name", "pipeline")
        self.trace_sample_n = int(trace_sample_n)
        self._delivery_seq = 0

    def on_encoded_event_received(self, payload: bytes,
                                  metadata=None) -> None:
        # one ingest stamp per delivery (sources/receivers.py); popped so
        # decoders never see the float. Direct callers without a stamp
        # age from "now" (ages ~0 — still counted).
        received_at = None
        if metadata is not None:
            received_at = metadata.pop("received_at", None)
        self._delivery_seq += 1
        n = self.trace_sample_n
        if n > 0 and self._delivery_seq % n == 0:
            with GLOBAL_TRACER.span("ingest.journey", tenant=self.tenant,
                                    delivery=str(self._delivery_seq)):
                self._handle_delivery(payload, metadata, received_at)
        else:
            self._handle_delivery(payload, metadata, received_at)

    def _handle_delivery(self, payload: bytes, metadata,
                         received_at) -> None:
        data = self._remainder + payload if self._remainder else payload
        try:
            res = self.lane.ingest(data)
        except (WireError, ValueError) as exc:
            # corrupt delivery: drop buffered bytes so the stream re-syncs at
            # the next delivery, and route to the failed-decode topic like
            # the object path (InboundEventSource.onFailedDecode)
            self._remainder = b""
            self.failed_counter.inc()
            if self.bus is not None:
                self.bus.publish(
                    self.naming.event_source_failed_decode_events(self.tenant),
                    str(exc).encode(), payload)
            return
        self._remainder = res.remainder
        if res.control_frames and self.control_sink is not None:
            for mtype, body in res.control_frames:
                try:
                    frame = encode_frame(MessageType(mtype), body)
                except ValueError:  # unknown control msg_type: skip
                    self.failed_counter.inc()
                    continue
                self.control_sink(frame, metadata)
        row = 0
        for batch in res.batches:
            age = AgeSidecar()
            age.add(received_at, min(batch.batch_size, res.n_events - row))
            alert_batch, outputs = self.engine.submit_routed(batch, age=age)
            persisted = True
            if self.persister is not None:
                self.persister.submit(batch, self.tenant)
            elif self.eventlog is not None:
                self.eventlog.append_batch(self.tenant, batch,
                                           self.engine.packer,
                                           registry=self.registry)
            else:
                persisted = False
            if persisted:
                # persist edge: durable append handed off (close() is
                # pure — the engine separately closed the materialize
                # edge on the same sidecar)
                observe_summary(self._age_hist, age.close(),
                                engine=self._engine_label, edge="persist")
            self._route_unregistered(res, batch, row)
            self._persist_alerts(alert_batch, outputs, age=age)
            row += batch.batch_size
        self.events_meter.mark(res.n_events)

    def _route_unregistered(self, res: FastIngestResult, batch: EventBatch,
                            row0: int) -> None:
        """Route events whose device has no active assignment to the
        unregistered-device topic (flat host-side check against the registry
        mirror, so it works identically for single-chip and sharded engines
        whose outputs are in routed [S, B] layout)."""
        snap = self._registry_snapshot()
        device_idx = np.asarray(batch.device_idx)
        valid = np.asarray(batch.valid)
        status = snap.assignment_status[device_idx]
        rows = np.nonzero(valid & (status != 1))[0]
        if rows.size == 0:
            return
        self.unregistered_counter.inc(int(rows.size))
        if self.bus is None:
            return
        topic = self.naming.inbound_unregistered_device_events(self.tenant)
        for r in rows:
            if row0 + int(r) < res.n_events:
                token = res.token_at(row0 + int(r))
                self.bus.publish(topic, token.encode(), token.encode())

    def _registry_snapshot(self):
        tensors = self.engine.registry
        cached = getattr(self, "_snap", None)
        if cached is None or cached.version != tensors.version:
            self._snap = tensors.snapshot()
        return self._snap

    def _persist_alerts(self, batch, outputs, age=None) -> None:
        if not self.persist_rule_alerts or self.events is None \
                or self.registry is None:
            return
        alerts = list(self.engine.materialize_alerts(batch, outputs))
        for alert in alerts:
            device = self.registry.get_device_by_token(alert.device_id)
            if device is None:
                continue
            assignment = self.registry.get_active_assignment(device.id)
            if assignment is not None:
                self.events.add_alerts(assignment.token, alert)
        if alerts and age is not None:
            # alert edge: rule alerts reached the event store
            observe_summary(self._age_hist, age.close(),
                            engine=self._engine_label, edge="alert")
