"""Extended inbound receivers: polling REST + external-broker adapters.

Reference: service-event-sources ships receiver implementations for every
transport its users run — ActiveMQ broker/client, RabbitMQ, Azure EventHub,
polling REST (PollingRestInboundEventReceiver) alongside MQTT/CoAP/sockets.
The in-image equivalents:

- `PollingRestReceiver` — fully functional (stdlib urllib): polls an HTTP
  endpoint on an interval and forwards the body as an encoded payload.
- `AmqpEventReceiver` / `EventHubEventReceiver` / `StompEventReceiver` —
  adapters over the respective client libraries (pika / azure-eventhub /
  stomp.py). The libraries are optional dependencies: construction succeeds
  (config can be parsed/validated anywhere), `start()` raises a clear
  SiteWhereError when the client library is absent. The adapter pattern —
  client thread consuming deliveries into `on_encoded_event_received` — is
  identical to the reference's receiver classes.
"""

from __future__ import annotations

import importlib
import logging
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.sources.receivers import _ReceiverBase

LOGGER = logging.getLogger("sitewhere.sources.ext")


def require_optional(import_name: str, human_name: str):
    """Import an optional client library or raise a clear 501 gating error
    (shared by the broker receivers here and connectors/sinks.py)."""
    try:
        return importlib.import_module(import_name)
    except ImportError as exc:
        raise SiteWhereError(
            f"this component requires the optional {human_name} client "
            f"library ('{import_name}'), which is not installed in this "
            f"image; use the MQTT/CoAP/socket/HTTP transports or install "
            f"it in your deployment", http_status=501) from exc


class PollingRestReceiver(_ReceiverBase):
    """Periodically GETs a URL and forwards non-empty response bodies
    (PollingRestInboundEventReceiver). An `ETag`/`Last-Modified` aware
    variant is unnecessary here: servers that support conditional GETs
    return 304 with an empty body, which is dropped."""

    def __init__(self, url: str, interval_s: float = 10.0,
                 headers: Optional[Dict[str, str]] = None,
                 timeout_s: float = 10.0):
        super().__init__()
        self.url = url
        self.interval_s = interval_s
        self.headers = dict(headers or {})
        self.timeout_s = timeout_s
        self.poll_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"poll-rest:{self.url}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def poll_once(self) -> Optional[bytes]:
        """One poll cycle (public so tests/ops can drive it synchronously).
        Any failure — network, protocol, downstream handler — is counted,
        never raised: the polling loop must survive a misbehaving endpoint."""
        request = urllib.request.Request(self.url, headers=self.headers)
        try:
            with urllib.request.urlopen(request,
                                        timeout=self.timeout_s) as resp:
                body = resp.read()
        except Exception:
            self.poll_errors += 1
            return None
        if body:
            try:
                self.source.on_encoded_event_received(
                    body, {"rest.url": self.url})
            except Exception:
                self.poll_errors += 1
                LOGGER.exception("polling-REST delivery failed for %s",
                                 self.url)
        return body

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.interval_s)


class _OptionalClientReceiver(_ReceiverBase):
    """Base for receivers whose client library is an optional dependency."""

    #: override: (import name, human name)
    _LIB: tuple = ("", "")

    def _require_lib(self):
        return require_optional(self._LIB[0], self._LIB[1])


class AmqpEventReceiver(_OptionalClientReceiver):
    """RabbitMQ/AMQP queue consumer (RabbitMqInboundEventReceiver) over the
    `pika` client when available."""

    _LIB = ("pika", "AMQP (RabbitMQ)")

    def __init__(self, url: str = "amqp://localhost", queue: str = "sitewhere",
                 durable: bool = True):
        super().__init__()
        self.url = url
        self.queue = queue
        self.durable = durable
        self._conn = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        pika = self._require_lib()
        params = pika.URLParameters(self.url)
        self._conn = pika.BlockingConnection(params)
        self._channel = self._conn.channel()
        self._channel.queue_declare(queue=self.queue, durable=self.durable)

        def on_message(ch, method, properties, body):
            self.source.on_encoded_event_received(
                body, {"amqp.queue": self.queue})
            ch.basic_ack(delivery_tag=method.delivery_tag)

        self._channel.basic_consume(queue=self.queue,
                                    on_message_callback=on_message)
        self._thread = threading.Thread(target=self._channel.start_consuming,
                                        daemon=True, name="amqp-receiver")
        self._thread.start()

    def stop(self) -> None:
        if self._conn is not None:
            # pika's BlockingConnection is single-threaded: the consumer
            # thread owns it, so stop via its thread-safe callback and join
            try:
                self._conn.add_callback_threadsafe(
                    self._channel.stop_consuming)
                if self._thread is not None:
                    self._thread.join(timeout=5)
                self._conn.close()
            except Exception:
                pass
            self._conn = None


class EventHubEventReceiver(_OptionalClientReceiver):
    """Azure EventHub consumer (EventHubInboundEventReceiver) over
    `azure.eventhub` when available."""

    _LIB = ("azure.eventhub", "Azure EventHub")

    def __init__(self, connection_str: str, eventhub_name: str,
                 consumer_group: str = "$Default"):
        super().__init__()
        self.connection_str = connection_str
        self.eventhub_name = eventhub_name
        self.consumer_group = consumer_group
        self._client = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        eventhub = self._require_lib()
        self._client = eventhub.EventHubConsumerClient.from_connection_string(
            self.connection_str, consumer_group=self.consumer_group,
            eventhub_name=self.eventhub_name)

        def on_event(partition_context, event):
            self.source.on_encoded_event_received(
                event.body_as_bytes(),
                {"eventhub.partition": partition_context.partition_id})
            partition_context.update_checkpoint(event)

        self._thread = threading.Thread(
            target=lambda: self._client.receive(on_event=on_event),
            daemon=True, name="eventhub-receiver")
        self._thread.start()

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


class StompEventReceiver(_OptionalClientReceiver):
    """ActiveMQ/STOMP subscriber (ActiveMQInboundEventReceiver) over
    `stomp.py` when available."""

    _LIB = ("stomp", "STOMP (ActiveMQ)")

    def __init__(self, host: str = "localhost", port: int = 61613,
                 destination: str = "/queue/sitewhere"):
        super().__init__()
        self.host = host
        self.port = port
        self.destination = destination
        self._conn = None

    def start(self) -> None:
        stomp = self._require_lib()
        receiver = self

        class Listener(stomp.ConnectionListener):
            def on_message(self, frame):
                receiver.source.on_encoded_event_received(
                    frame.body if isinstance(frame.body, bytes)
                    else frame.body.encode(),
                    {"stomp.destination": receiver.destination})

        self._conn = stomp.Connection([(self.host, self.port)])
        self._conn.set_listener("sitewhere", Listener())
        self._conn.connect(wait=True)
        self._conn.subscribe(destination=self.destination, id="sitewhere",
                             ack="auto")

    def stop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.disconnect()
            except Exception:
                pass
            self._conn = None
