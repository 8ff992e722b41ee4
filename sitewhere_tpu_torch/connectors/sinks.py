"""Concrete outbound connectors.

Reference: service-outbound-connectors — MQTT (MqttOutboundConnector),
Solr indexing (solr/SolrOutboundConnector.java), Groovy scripted, the SaaS
sinks (dweet.io, InitialState — thin layers over HTTP POST here), AWS SQS
(gated on the optional boto3 client like the broker receivers in
sources/receivers_ext.py), plus multicasting with route builders
(spi/multicast/IDeviceEventMulticaster, groovy/routing/GroovyRouteBuilder).
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.connectors.base import OutboundConnector
from sitewhere_tpu_torch.model.event import DeviceEvent, DeviceEventContext
from sitewhere_tpu_torch.sources.receivers import EventLoopThread
from sitewhere_tpu_torch.transport.mqtt import MqttClient

LOGGER = logging.getLogger("sitewhere.connectors")


def event_to_json(context: DeviceEventContext, event: DeviceEvent) -> bytes:
    payload = event.to_dict()
    payload["device"] = context.device_token
    payload["area"] = context.area_id
    payload["assignment"] = context.assignment_id
    return json.dumps(payload, default=str).encode("utf-8")


class MqttOutboundConnector(OutboundConnector):
    """Publish every accepted event as JSON to an MQTT topic; with a
    multicaster, to one topic per route (MqttOutboundConnector.java)."""

    def __init__(self, connector_id: str, host: str, port: int,
                 topic: str = "SW/outbound", filters=None,
                 multicaster: Optional["DeviceEventMulticaster"] = None,
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(connector_id, filters)
        self.host = host
        self.port = port
        self.topic = topic
        self.multicaster = multicaster
        self._loop_thread = loop_thread
        self._client: Optional[MqttClient] = None

    @property
    def loop_thread(self) -> EventLoopThread:
        if self._loop_thread is None:
            self._loop_thread = EventLoopThread.shared()
        return self._loop_thread

    def on_start(self, monitor) -> None:
        client = MqttClient(self.host, self.port,
                            client_id=f"connector-{self.connector_id}")
        self.loop_thread.run(client.connect())
        self._client = client

    def on_stop(self, monitor) -> None:
        if self._client is not None:
            self.loop_thread.run(self._client.disconnect())
            self._client = None

    def process_batch(self, batch: List[Tuple[DeviceEventContext,
                                              DeviceEvent]]) -> None:
        if self._client is None:
            raise RuntimeError(f"connector {self.connector_id} not started")
        for context, event in batch:
            payload = event_to_json(context, event)
            topics = ([r for r in self.multicaster.routes(context, event)]
                      if self.multicaster else [self.topic])
            for topic in topics:
                self.loop_thread.run(self._client.publish(topic, payload))


class ScriptedConnector(OutboundConnector):
    """User callable `(context, event) -> None` per event (Groovy connector
    extension point)."""

    def __init__(self, connector_id: str,
                 script: Callable[[DeviceEventContext, DeviceEvent], None],
                 filters=None):
        super().__init__(connector_id, filters)
        self.script = script

    @classmethod
    def from_manager(cls, connector_id: str, manager, script_id: str,
                     scope: str = "global", entry: str = "process",
                     filters=None) -> "ScriptedConnector":
        """Bind to a managed script's active version (runtime/scripts.py)."""
        return cls(connector_id, manager.resolve(scope, script_id, entry),
                   filters=filters)

    def process_batch(self, batch) -> None:
        for context, event in batch:
            self.script(context, event)


class EventIndexConnector(OutboundConnector):
    """Feed accepted events into an EventSearchIndex (search/index.py) —
    the role SolrOutboundConnector plays for the reference's event search."""

    def __init__(self, connector_id: str, index, filters=None):
        super().__init__(connector_id, filters)
        self.index = index

    def process_batch(self, batch) -> None:
        self.index.add_batch(batch)


class CollectingConnector(OutboundConnector):
    """Collect events in memory — test double and debugging tap."""

    def __init__(self, connector_id: str = "collector", filters=None):
        super().__init__(connector_id, filters)
        self.collected: List[Tuple[DeviceEventContext, DeviceEvent]] = []

    def process_batch(self, batch) -> None:
        self.collected.extend(batch)


class HttpPostConnector(OutboundConnector):
    """POST JSON events to an HTTP endpoint — the generic base the SaaS
    connectors below specialize via `_url_for`/`_post`."""

    def __init__(self, connector_id: str, url: str, filters=None,
                 timeout_s: float = 5.0):
        super().__init__(connector_id, filters)
        self.url = url
        self.timeout_s = timeout_s

    def _url_for(self, context: DeviceEventContext,
                 event: DeviceEvent) -> str:
        return self.url

    def _post(self, url: str, data: bytes,
              headers: Optional[Dict[str, str]] = None) -> None:
        import urllib.request
        request = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST")
        urllib.request.urlopen(request, timeout=self.timeout_s).read()

    def process_batch(self, batch) -> None:
        for context, event in batch:
            self._post(self._url_for(context, event),
                       event_to_json(context, event))


class DweetConnector(HttpPostConnector):
    """dweet.io connector (DweetIoConnector): each event posts to the
    per-thing dweet endpoint, the thing name defaulting to the device
    token."""

    def __init__(self, connector_id: str = "dweet", thing_prefix: str = "",
                 base_url: str = "https://dweet.io", filters=None,
                 timeout_s: float = 5.0):
        super().__init__(connector_id, base_url, filters=filters,
                         timeout_s=timeout_s)
        self.thing_prefix = thing_prefix

    def _url_for(self, context, event) -> str:
        from urllib.parse import quote
        thing = quote(f"{self.thing_prefix}{context.device_token}", safe="")
        return f"{self.url}/dweet/for/{thing}"


class InitialStateConnector(HttpPostConnector):
    """InitialState events-API connector (InitialStateEventProcessor): posts
    measurement values, location coordinates, and alert messages to a
    bucket keyed by the access-key header."""

    def __init__(self, connector_id: str = "initial-state",
                 streaming_access_key: str = "",
                 base_url: str = "https://groker.initialstate.com/api/events",
                 filters=None, timeout_s: float = 5.0):
        super().__init__(connector_id, base_url, filters=filters,
                         timeout_s=timeout_s)
        self.access_key = streaming_access_key

    @staticmethod
    def _line(context, event):
        name = getattr(event, "name", None) or event.event_type.name.lower()
        value = getattr(event, "value", None)
        if value is None and hasattr(event, "latitude"):
            value = f"{event.latitude},{event.longitude}"
        if value is None:  # alerts and other valueless events: string value
            value = getattr(event, "message", None) or \
                getattr(event, "type", None) or name
        return {"key": f"{context.device_token}.{name}", "value": value,
                "epoch": event.event_date / 1000.0}

    def process_batch(self, batch) -> None:
        lines = [self._line(context, event) for context, event in batch]
        if lines:
            self._post(self.url, json.dumps(lines).encode(),
                       headers={"X-IS-AccessKey": self.access_key,
                                "Accept-Version": "~0"})


class SqsConnector(OutboundConnector):
    """AWS SQS connector (SqsOutboundEventProcessor) over `boto3` when
    available (optional dependency — start() fails with a clear error
    otherwise, matching the receiver adapters in sources/receivers_ext.py).
    """

    def __init__(self, connector_id: str, queue_url: str, region: str =
                 "us-east-1", filters=None):
        super().__init__(connector_id, filters)
        self.queue_url = queue_url
        self.region = region
        self._client = None

    def on_start(self, monitor) -> None:
        from sitewhere_tpu_torch.sources.receivers_ext import require_optional
        boto3 = require_optional("boto3", "AWS SQS")
        self._client = boto3.client("sqs", region_name=self.region)

    def process_batch(self, batch) -> None:
        for context, event in batch:
            self._client.send_message(
                QueueUrl=self.queue_url,
                MessageBody=event_to_json(context, event).decode())


class RabbitMqConnector(OutboundConnector):
    """RabbitMQ outbound sink (RabbitMqOutboundConnector.java): publish
    each accepted event as JSON to an exchange/routing key over `pika`
    when available (optional dependency — start() fails with a clear 501
    gating error otherwise, like the inbound AmqpEventReceiver)."""

    def __init__(self, connector_id: str, url: str = "amqp://localhost",
                 exchange: str = "", routing_key: str = "sitewhere.events",
                 durable: bool = False, filters=None,
                 multicaster: Optional["DeviceEventMulticaster"] = None):
        super().__init__(connector_id, filters)
        self.url = url
        self.exchange = exchange
        self.routing_key = routing_key
        self.durable = durable
        self.multicaster = multicaster
        self._connection = None
        self._channel = None

    def on_start(self, monitor) -> None:
        from sitewhere_tpu_torch.sources.receivers_ext import require_optional
        pika = require_optional("pika", "RabbitMQ")
        self._connection = pika.BlockingConnection(
            pika.URLParameters(self.url))
        self._channel = self._connection.channel()
        if self.exchange:
            self._channel.exchange_declare(exchange=self.exchange,
                                           durable=self.durable)
        else:
            self._channel.queue_declare(queue=self.routing_key,
                                        durable=self.durable)

    def on_stop(self, monitor) -> None:
        if self._connection is not None:
            self._connection.close()
            self._connection = self._channel = None

    def process_batch(self, batch: List[Tuple[DeviceEventContext,
                                              DeviceEvent]]) -> None:
        if self._channel is None:
            raise RuntimeError(f"connector {self.connector_id} not started")
        for context, event in batch:
            payload = event_to_json(context, event)
            keys = (self.multicaster.routes(context, event)
                    if self.multicaster else [self.routing_key])
            for key in keys:
                self._channel.basic_publish(exchange=self.exchange,
                                            routing_key=key, body=payload)


class EventHubConnector(OutboundConnector):
    """Azure Event Hub outbound sink (EventHubOutboundConnector.java) over
    `azure-eventhub` when available (same optional-dependency gating as
    the inbound EventHubEventReceiver). Events batch per process_batch
    call — the hub client's native batching unit."""

    def __init__(self, connector_id: str, connection_str: str,
                 eventhub_name: str, filters=None):
        super().__init__(connector_id, filters)
        self.connection_str = connection_str
        self.eventhub_name = eventhub_name
        self._producer = None
        self._event_cls = None

    def on_start(self, monitor) -> None:
        from sitewhere_tpu_torch.sources.receivers_ext import require_optional
        eventhub = require_optional("azure.eventhub", "Azure Event Hub")
        self._event_cls = eventhub.EventData
        self._producer = eventhub.EventHubProducerClient.from_connection_string(
            self.connection_str, eventhub_name=self.eventhub_name)

    def on_stop(self, monitor) -> None:
        if self._producer is not None:
            self._producer.close()
            self._producer = None

    def process_batch(self, batch: List[Tuple[DeviceEventContext,
                                              DeviceEvent]]) -> None:
        if self._producer is None:
            raise RuntimeError(f"connector {self.connector_id} not started")
        hub_batch = self._producer.create_batch()
        for context, event in batch:
            data = self._event_cls(event_to_json(context, event))
            try:
                hub_batch.add(data)
            except ValueError:
                # hub batch size limit (~1 MB): flush and keep going
                self._producer.send_batch(hub_batch)
                hub_batch = self._producer.create_batch()
                hub_batch.add(data)
        self._producer.send_batch(hub_batch)


class DeviceEventMulticaster:
    """Compute delivery routes per event (IDeviceEventMulticaster). Route
    builders are callables `(context, event) -> list[str]`
    (GroovyRouteBuilder's extension point)."""

    def __init__(self, builders: Optional[List[Callable[..., List[str]]]] = None):
        self.builders = builders or []

    def add_builder(self, builder: Callable[..., List[str]]) -> None:
        self.builders.append(builder)

    def routes(self, context: DeviceEventContext,
               event: DeviceEvent) -> List[str]:
        out: List[str] = []
        for builder in self.builders:
            out.extend(builder(context, event))
        return out


def all_devices_of_type_route(registry, device_type_token: str,
                              topic_pattern: str = "SW/{token}/broadcast"
                              ) -> Callable[..., List[str]]:
    """AllWithSpecificationStringMulticaster: route an event to a topic per
    device of the given type."""
    def builder(context: DeviceEventContext, event: DeviceEvent) -> List[str]:
        device_type = registry.get_device_type_by_token(device_type_token)
        return [topic_pattern.format(token=d.token)
                for d in registry.devices.all()
                if d.device_type_id == device_type.id]
    return builder
