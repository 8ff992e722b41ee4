"""Outbound connectors (reference: service-outbound-connectors)."""

from sitewhere_tpu_torch.connectors.base import OutboundConnector
from sitewhere_tpu_torch.connectors.filters import (
    AreaFilter, DeviceTypeFilter, EventTypeFilter, FilterOperation,
    ScriptedFilter)
from sitewhere_tpu_torch.connectors.host import (
    OutboundConnectorHost, OutboundConnectorsManager)
from sitewhere_tpu_torch.connectors.sinks import (
    CollectingConnector, DeviceEventMulticaster, DweetConnector,
    EventHubConnector, EventIndexConnector, HttpPostConnector,
    InitialStateConnector, MqttOutboundConnector, RabbitMqConnector,
    ScriptedConnector, SqsConnector, all_devices_of_type_route,
    event_to_json)

__all__ = [
    "AreaFilter", "CollectingConnector", "DeviceEventMulticaster",
    "DeviceTypeFilter", "DweetConnector", "EventHubConnector",
    "EventIndexConnector",
    "EventTypeFilter", "FilterOperation", "HttpPostConnector",
    "InitialStateConnector", "MqttOutboundConnector", "OutboundConnector",
    "RabbitMqConnector",
    "OutboundConnectorHost", "OutboundConnectorsManager",
    "ScriptedConnector", "ScriptedFilter", "SqsConnector",
    "all_devices_of_type_route", "event_to_json",
]
