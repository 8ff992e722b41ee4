"""Inbound event receivers: transport listeners feeding an event source.

Reference: service-event-sources receiver zoo — MQTT
(mqtt/MqttInboundEventReceiver.java:39, subscribe :100), raw sockets
(socket/SocketInboundEventReceiver.java), WebSocket, CoAP
(coap/CoapServerEventReceiver.java), HTTP polling. Each receiver binds to
an InboundEventSource and forwards raw payloads to
`on_encoded_event_received` (same contract as IInboundEventReceiver).

All asyncio transports run on one shared background event-loop thread so a
tenant with many receivers costs one thread, mirroring the reference's
shared executor pools.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict, List, Optional


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread; receivers submit
    coroutines with `run(coro)`."""

    _shared: Optional["EventLoopThread"] = None
    _shared_lock = threading.Lock()

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="receiver-loop")
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout_s: float = 10.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout_s)

    @classmethod
    def shared(cls) -> "EventLoopThread":
        with cls._shared_lock:
            if cls._shared is None or not cls._shared._thread.is_alive():
                cls._shared = cls()
            return cls._shared


class _ReceiverBase:
    def __init__(self, loop_thread: Optional[EventLoopThread] = None):
        self._loop_thread = loop_thread
        self.source = None

    @property
    def loop_thread(self) -> EventLoopThread:
        if self._loop_thread is None:
            self._loop_thread = EventLoopThread.shared()
        return self._loop_thread

    def bind(self, source) -> None:
        self.source = source

    async def _forward(self, payload: bytes,
                       metadata: Optional[Dict[str, str]] = None) -> None:
        # decode + bus publish are cheap/non-blocking; run inline on the loop
        metadata = metadata or {}
        # ingest-edge age stamp: one monotonic clock read per DELIVERY
        # (a payload of N events shares it) — the open edge of the
        # ingest->effect age waterfall (runtime/eventage.py). Kept as a
        # float; the ingest service pops it before metadata reaches
        # decoders.
        metadata.setdefault("received_at", time.perf_counter())
        self.source.on_encoded_event_received(payload, metadata)


class MqttEventReceiver(_ReceiverBase):
    """Subscribes to a topic filter on an MQTT broker (the in-proc
    MqttBroker or any external one) — MqttInboundEventReceiver."""

    def __init__(self, host: str, port: int, topic: str = "SW/+/input/#",
                 qos: int = 1, client_id: str = "",
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self.topic = topic
        self.qos = qos
        self.client_id = client_id
        self._client = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.mqtt import MqttClient

        async def go():
            self._client = MqttClient(self.host, self.port, self.client_id)
            await self._client.connect()

            async def on_message(topic: str, payload: bytes):
                await self._forward(payload, {"mqtt.topic": topic})

            await self._client.subscribe(self.topic, on_message, qos=self.qos)

        self.loop_thread.run(go())

    def stop(self) -> None:
        if self._client is not None:
            self.loop_thread.run(self._client.disconnect())
            self._client = None


class StompBrokerEventReceiver(_ReceiverBase):
    """EMBEDDED-broker STOMP receiver: hosts an in-process STOMP broker
    (transport/stomp.py) and consumes device events from one of its
    destinations — the ActiveMQBrokerEventReceiver role
    (service-event-sources activemq/ActiveMQBrokerEventReceiver.java:42
    hosts an in-JVM ActiveMQ broker the devices connect TO). The
    client-side adapters (receivers_ext.StompEventReceiver, AMQP) cover
    the EXTERNAL-broker slot; this closes the embedded one with no
    middleware dependency."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 destination: str = "/queue/sitewhere",
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self.destination = destination
        self._broker = None
        self._consumer = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.stomp import StompBroker, StompClient

        async def go():
            self._broker = StompBroker(self.host, self.port)
            await self._broker.start()
            self.port = self._broker.port
            # in-proc consumer rides the same public protocol the
            # devices use — nothing broker-internal to maintain. Connect
            # on the broker's bind address (loopback only when bound to
            # the wildcard, where 127.0.0.1 is always reachable).
            connect_host = (self.host if self.host not in ("", "0.0.0.0",
                                                           "::")
                            else "127.0.0.1")
            self._consumer = StompClient(connect_host, self.port)
            await self._consumer.connect()

            async def on_message(headers, body: bytes):
                await self._forward(body, {
                    "stomp.destination": headers.get("destination",
                                                     self.destination)})

            await self._consumer.subscribe(self.destination, on_message)

        self.loop_thread.run(go())

    def stop(self) -> None:
        async def go():
            if self._consumer is not None:
                await self._consumer.disconnect()
            if self._broker is not None:
                await self._broker.stop()

        self.loop_thread.run(go())
        self._consumer = None
        self._broker = None


class SocketEventReceiver(_ReceiverBase):
    """TCP wire-frame listener (SocketInboundEventReceiver)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self._server = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.servers import SocketEventServer

        async def go():
            self._server = SocketEventServer(self._forward, self.host,
                                             self.port)
            await self._server.start()
            self.port = self._server.port

        self.loop_thread.run(go())

    def stop(self) -> None:
        if self._server is not None:
            self.loop_thread.run(self._server.stop())
            self._server = None


class WebSocketEventReceiver(_ReceiverBase):
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self._server = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.servers import WebSocketEventServer

        async def go():
            self._server = WebSocketEventServer(self._forward, self.host,
                                                self.port)
            await self._server.start()
            self.port = self._server.port

        self.loop_thread.run(go())

    def stop(self) -> None:
        if self._server is not None:
            self.loop_thread.run(self._server.stop())
            self._server = None


class HttpEventReceiver(_ReceiverBase):
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 path: str = "/events",
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self.path = path
        self._server = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.servers import HttpEventServer

        async def go():
            self._server = HttpEventServer(self._forward, self.host,
                                           self.port, self.path)
            await self._server.start()
            self.port = self._server.port

        self.loop_thread.run(go())

    def stop(self) -> None:
        if self._server is not None:
            self.loop_thread.run(self._server.stop())
            self._server = None


class CoapEventReceiver(_ReceiverBase):
    """CoAP POST/PUT listener (CoapServerEventReceiver)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__(loop_thread)
        self.host = host
        self.port = port
        self._server = None

    def start(self) -> None:
        from sitewhere_tpu_torch.transport.coap import CoapServer

        def handler(path: str, payload: bytes, method: int):
            self.source.on_encoded_event_received(
                payload, {"coap.path": path,
                          "received_at": time.perf_counter()})
            return b""

        async def go():
            self._server = CoapServer(handler, self.host, self.port)
            await self._server.start()
            self.port = self._server.port

        self.loop_thread.run(go())

    def stop(self) -> None:
        if self._server is not None:
            self.loop_thread.run(self._server.stop())
            self._server = None
