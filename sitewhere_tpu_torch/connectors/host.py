"""Connector host: drives connectors from the enriched-events topic.

Reference: KafkaOutboundConnectorHost.java:44 — each IOutboundConnector is
wrapped in a host with its OWN consumer group (:86) reading
inbound-enriched-events, so connectors consume independently and a failed
connector replays from its own committed offset. The manager mirrors
OutboundConnectorsManager.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from sitewhere_tpu_torch.connectors.base import OutboundConnector
from sitewhere_tpu_torch.model.event import DeviceEvent, DeviceEventContext
from sitewhere_tpu_torch.pipeline.enrichment import unpack_enriched
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.connectors")


class OutboundConnectorHost(LifecycleComponent):
    """One connector + one consumer group on the enriched topic."""

    def __init__(self, bus: EventBus, connector: OutboundConnector,
                 tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"connector-host:{connector.connector_id}")
        self.bus = bus
        self.connector = connector
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.add_nested(connector)
        m = (metrics or MetricsRegistry()).scoped(
            f"connector.{connector.connector_id}")
        self.processed_meter = m.meter("processed")
        self.filtered_counter = m.counter("filtered")
        self.failed_counter = m.counter("failed")
        self._host = ConsumerHost(
            bus, self.naming.inbound_enriched_events(tenant),
            group_id=f"connector-{connector.connector_id}-{tenant}",
            handler=self.process)

    def on_start(self, monitor) -> None:
        self._host.start()

    def on_stop(self, monitor) -> None:
        self._host.stop()

    def process(self, records: List[Record]) -> None:
        """Decode + filter a poll batch, hand survivors to the connector
        (KafkaOutboundConnectorHost.java:173). Public for synchronous tests."""
        batch: List[Tuple[DeviceEventContext, DeviceEvent]] = []
        for record in records:
            try:
                context, event = unpack_enriched(record.value)
            except Exception:
                self.failed_counter.inc()
                continue
            if self.connector.accepts(context, event):
                batch.append((context, event))
            else:
                self.filtered_counter.inc()
        if batch:
            self.connector.process_batch(batch)
            self.processed_meter.mark(len(batch))


class OutboundConnectorsManager(LifecycleComponent):
    """Hosts all connectors of one tenant (OutboundConnectorsManager)."""

    def __init__(self, bus: EventBus, tenant: str = "default",
                 naming: Optional[TopicNaming] = None):
        super().__init__("outbound-connectors-manager")
        self.bus = bus
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.hosts: List[OutboundConnectorHost] = []

    def add_connector(self, connector: OutboundConnector) -> OutboundConnectorHost:
        host = OutboundConnectorHost(self.bus, connector, self.tenant,
                                     self.naming)
        self.hosts.append(host)
        self.add_nested(host)
        return host
