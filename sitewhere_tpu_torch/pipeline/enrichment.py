"""Outbound payload enrichment: persisted events -> enriched topics.

Reference: service-inbound-processing PersistedEventsConsumer.java:41 ->
OutboundPayloadEnrichmentLogic.java:54-93 — for every event read back from
inbound-persisted-events, re-resolve the assignment + device, attach a
GDeviceEventContext, and publish to inbound-enriched-events (all events) and
inbound-enriched-command-invocations (command invocations only, :89-92), keyed
by device token for per-device ordering.

Note: the *hot* consumers of enrichment (rule eval + device state)
do NOT read these topics — they run inside the engine's step
(pipeline/step.py) against the registry mirror, so enrichment is a gather, not
an RPC. These topics exist for the control-plane consumers the reference
fans out to: outbound connectors, command delivery, and external readers.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import List, Optional

import msgpack

from sitewhere_tpu_torch.model.event import (
    DeviceEvent, DeviceEventContext, DeviceEventType, event_from_dict)
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry


def pack_enriched(context: DeviceEventContext, event: DeviceEvent) -> bytes:
    """GEnrichedEventPayload: context envelope + event."""
    return msgpack.packb({"context": asdict(context),
                          "event": event.to_dict()}, use_bin_type=True)


def unpack_enriched(payload: bytes):
    """-> (DeviceEventContext, DeviceEvent)"""
    data = msgpack.unpackb(payload, raw=False)
    ctx = DeviceEventContext(**data["context"])
    return ctx, event_from_dict(data["event"])


class PayloadEnrichment(LifecycleComponent):
    """Consumes inbound-persisted-events and republishes enriched payloads.

    The reference re-fetches assignment + device over gRPC per event
    (OutboundPayloadEnrichmentLogic.java:60-76); here it is two dict lookups
    against the in-proc registry.
    """

    def __init__(self, bus: EventBus, registry, tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"enrichment:{tenant}")
        self.bus = bus
        self.registry = registry
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        m = (metrics or MetricsRegistry()).scoped("enrichment")
        self.enriched_meter = m.meter("enriched")
        self.failed_counter = m.counter("failed")
        self._host = ConsumerHost(
            bus, self.naming.inbound_persisted_events(tenant),
            group_id=f"enrichment-{tenant}", handler=self._process)

    def on_start(self, monitor) -> None:
        self._host.start()

    def on_stop(self, monitor) -> None:
        self._host.stop()

    # -- processing --------------------------------------------------------
    def _context_for(self, event: DeviceEvent) -> DeviceEventContext:
        from sitewhere_tpu_torch.persist.event_management import context_for_assignment
        return context_for_assignment(self.registry,
                                      event.device_assignment_id, self.tenant)

    def _process(self, records: List[Record]) -> None:
        enriched_topic = self.naming.inbound_enriched_events(self.tenant)
        command_topic = self.naming.inbound_enriched_command_invocations(
            self.tenant)
        for record in records:
            try:
                event = event_from_dict(msgpack.unpackb(record.value, raw=False))
                context = self._context_for(event)
            except Exception:
                self.failed_counter.inc()
                continue
            payload = pack_enriched(context, event)
            key = context.device_token.encode()
            self.bus.publish(enriched_topic, key, payload)
            if event.event_type == DeviceEventType.COMMAND_INVOCATION:
                self.bus.publish(command_topic, key, payload)
            self.enriched_meter.mark(1)
