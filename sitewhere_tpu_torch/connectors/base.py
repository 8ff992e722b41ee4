"""Outbound connector SPI: enriched events -> external systems.

Reference: service-outbound-connectors — IOutboundConnector processes every
enriched event that passes its filters; implementations fan out to MQTT,
RabbitMQ, SQS, EventHub, InitialState, dweet.io, Solr. Events arrive in
batches (KafkaOutboundConnectorHost.java:173 hands the poll batch to a
processor), and each connector owns its consumer group so a slow sink never
backpressures the others.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Tuple

from sitewhere_tpu_torch.model.event import (
    DeviceAlert, DeviceCommandInvocation, DeviceCommandResponse, DeviceEvent,
    DeviceEventContext, DeviceLocation, DeviceMeasurement, DeviceStateChange,
    dispatch_event)
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent


class EventFilterProtocol(Protocol):
    """include/exclude gate (spi/connector/IDeviceEventFilter)."""

    def accepts(self, context: DeviceEventContext,
                event: DeviceEvent) -> bool: ...


class OutboundConnector(LifecycleComponent):
    """Base connector: override the per-type hooks or `process_batch` for
    bulk sinks (the reference's batch-capable connectors index whole
    batches at once)."""

    def __init__(self, connector_id: str,
                 filters: Optional[List[EventFilterProtocol]] = None):
        super().__init__(f"connector:{connector_id}")
        self.connector_id = connector_id
        self.filters = filters or []

    # -- filtering ---------------------------------------------------------
    def accepts(self, context: DeviceEventContext, event: DeviceEvent) -> bool:
        return all(f.accepts(context, event) for f in self.filters)

    # -- processing --------------------------------------------------------
    def process_batch(self, batch: List[Tuple[DeviceEventContext,
                                              DeviceEvent]]) -> None:
        """Default: dispatch each event to its typed hook."""
        for context, event in batch:
            dispatch_event(self, context, event)

    # typed no-op hooks (IOutboundConnector onMeasurements/onLocation/...)
    def on_measurement(self, context, event: DeviceMeasurement) -> None: ...
    def on_location(self, context, event: DeviceLocation) -> None: ...
    def on_alert(self, context, event: DeviceAlert) -> None: ...
    def on_command_invocation(self, context,
                              event: DeviceCommandInvocation) -> None: ...
    def on_command_response(self, context,
                            event: DeviceCommandResponse) -> None: ...
    def on_state_change(self, context, event: DeviceStateChange) -> None: ...
    def on_stream_data(self, context, event) -> None: ...
