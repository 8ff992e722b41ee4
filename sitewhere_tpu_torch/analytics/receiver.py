"""Streaming micro-batch receiver: the sitewhere-spark bridge, in-proc
(counterpart of `sitewhere_tpu/analytics/receiver.py`).

Reference: sitewhere-spark/SiteWhereReceiver.java:31 — a Spark Streaming
`Receiver<IDeviceEvent>` subscribing to Hazelcast event topics and calling
`store(event)` per message so Spark can window them. Here the receiver is a
lifecycle component consuming `inbound-enriched-events` with its own group
(so it never steals records from connectors/command delivery), decoding the
enriched envelope, and handing micro-batches of (context, event) pairs to a
user callback — the integration point for external stream processors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from sitewhere_tpu_torch.model.event import DeviceEvent, DeviceEventContext
from sitewhere_tpu_torch.pipeline.enrichment import unpack_enriched
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

MicroBatch = List[Tuple[DeviceEventContext, DeviceEvent]]


class EventStreamReceiver(LifecycleComponent):
    """Delivers enriched events to `handler` in micro-batches."""

    def __init__(self, bus: EventBus, tenant: str,
                 handler: Callable[[MicroBatch], None],
                 naming: Optional[TopicNaming] = None,
                 group_id: Optional[str] = None, max_batch: int = 4096,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"stream-receiver:{tenant}")
        self.tenant = tenant
        self.handler = handler
        naming = naming or TopicNaming()
        m = (metrics or MetricsRegistry()).scoped("stream_receiver")
        self.received_meter = m.meter("received")
        self.failed_counter = m.counter("decode_failed")
        self._host = ConsumerHost(
            bus, naming.inbound_enriched_events(tenant),
            group_id=group_id or f"stream-receiver-{tenant}",
            handler=self._process, max_records=max_batch)

    def on_start(self, monitor) -> None:
        self._host.start()

    def on_stop(self, monitor) -> None:
        self._host.stop()

    def _process(self, records: List[Record]) -> None:
        batch: MicroBatch = []
        for record in records:
            try:
                batch.append(unpack_enriched(record.value))
            except Exception:
                self.failed_counter.inc()
        if batch:
            self.received_meter.mark(len(batch))
            self.handler(batch)
