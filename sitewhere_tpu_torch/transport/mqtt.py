"""In-process MQTT 3.1.1 broker + asyncio client.

Reference: the platform's device side speaks MQTT everywhere — inbound
events (service-event-sources mqtt/MqttInboundEventReceiver.java:39),
outbound commands (service-command-delivery
destination/mqtt/MqttCommandDeliveryProvider.java), connectors
(connector/mqtt/MqttOutboundConnector) — against an *external* broker
(HiveMQ/Mosquitto), with an embedded ActiveMQ broker option for self-
contained deployments. Here both ends are in-repo: a minimal, correct
MQTT 3.1.1 broker (CONNECT/PUBLISH QoS0+1/SUBSCRIBE with +/# wildcards/
retain/ping) and a client, so the whole platform runs without external
processes and tests drive real wire traffic (SURVEY.md §4).

Not implemented (not needed by the platform): QoS 2, persistent sessions,
wills. Unknown-flag packets are rejected by disconnect, per spec.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

# packet types
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | 0x80 if n else byte)
        if not n:
            return bytes(out)


async def _read_varint(reader: asyncio.StreamReader) -> int:
    mult, value = 1, 0
    for _ in range(4):
        (byte,) = await reader.readexactly(1)
        value += (byte & 0x7F) * mult
        if not byte & 0x80:
            return value
        mult *= 128
    raise MqttProtocolError("malformed remaining length")


def _utf8(s: str) -> bytes:
    b = s.encode()
    return struct.pack("!H", len(b)) + b


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body


class MqttProtocolError(Exception):
    pass


def topic_matches(flt: str, topic: str) -> bool:
    """MQTT topic filter matching with + (one level) and # (remainder)."""
    fparts = flt.split("/")
    tparts = topic.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return True
        if i >= len(tparts):
            return False
        if fp != "+" and fp != tparts[i]:
            return False
    return len(fparts) == len(tparts)


async def _read_packet(reader: asyncio.StreamReader) -> Tuple[int, int, bytes]:
    (first,) = await reader.readexactly(1)
    length = await _read_varint(reader)
    body = await reader.readexactly(length) if length else b""
    return first >> 4, first & 0x0F, body


@dataclass
class _Session:
    client_id: str
    writer: asyncio.StreamWriter
    subscriptions: Dict[str, int] = field(default_factory=dict)  # filter -> qos
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)

    async def send(self, data: bytes) -> None:
        async with self.lock:
            self.writer.write(data)
            await self.writer.drain()


class MqttBroker:
    """Asyncio MQTT broker. `port=0` binds an ephemeral port (see .port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._sessions: Dict[str, _Session] = {}
        self._retained: Dict[str, Tuple[bytes, int]] = {}  # topic -> (payload, qos)
        self._packet_id = 0
        # observability hook: (client_id, topic, payload) for every publish
        self.on_publish: Optional[Callable[[str, str, bytes], None]] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        for session in list(self._sessions.values()):
            session.writer.close()
        self._sessions.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- connection handling ----------------------------------------------
    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        session: Optional[_Session] = None
        try:
            ptype, _, body = await _read_packet(reader)
            if ptype != CONNECT:
                raise MqttProtocolError("first packet must be CONNECT")
            session = await self._on_connect(body, writer)
            while True:
                ptype, flags, body = await _read_packet(reader)
                if ptype == PUBLISH:
                    await self._on_publish(session, flags, body)
                elif ptype == SUBSCRIBE:
                    await self._on_subscribe(session, body)
                elif ptype == UNSUBSCRIBE:
                    await self._on_unsubscribe(session, body)
                elif ptype == PINGREQ:
                    await session.send(_packet(PINGRESP, 0, b""))
                elif ptype == PUBACK:
                    pass  # QoS1 outbound: fire-and-forget in-proc
                elif ptype == DISCONNECT:
                    break
                else:
                    raise MqttProtocolError(f"unsupported packet {ptype}")
        except (asyncio.IncompleteReadError, ConnectionResetError,
                MqttProtocolError):
            pass
        finally:
            if session is not None and \
                    self._sessions.get(session.client_id) is session:
                # only drop OUR registration — a reconnect with the same
                # client id may already have replaced it (session takeover)
                self._sessions.pop(session.client_id, None)
            writer.close()

    async def _on_connect(self, body: bytes,
                          writer: asyncio.StreamWriter) -> _Session:
        pos = 0
        (proto_len,) = struct.unpack_from("!H", body, pos)
        pos += 2 + proto_len  # b"MQTT"
        pos += 1  # level
        connect_flags = body[pos]
        pos += 1
        pos += 2  # keepalive
        (cid_len,) = struct.unpack_from("!H", body, pos)
        pos += 2
        client_id = body[pos:pos + cid_len].decode() or f"anon-{id(writer)}"
        # will/user/pass fields are parsed past but unused
        session = _Session(client_id=client_id, writer=writer)
        old = self._sessions.pop(client_id, None)
        if old is not None:
            old.writer.close()
        self._sessions[client_id] = session
        await session.send(_packet(CONNACK, 0, b"\x00\x00"))
        return session

    async def _on_publish(self, session: _Session, flags: int,
                          body: bytes) -> None:
        qos = (flags >> 1) & 0x03
        retain = flags & 0x01
        pos = 0
        (tlen,) = struct.unpack_from("!H", body, pos)
        pos += 2
        topic = body[pos:pos + tlen].decode()
        pos += tlen
        if qos > 0:
            (pid,) = struct.unpack_from("!H", body, pos)
            pos += 2
        payload = body[pos:]
        if retain:
            if payload:
                self._retained[topic] = (payload, qos)
            else:
                self._retained.pop(topic, None)
        if qos == 1:
            await session.send(_packet(PUBACK, 0, struct.pack("!H", pid)))
        if self.on_publish is not None:
            self.on_publish(session.client_id, topic, payload)
        await self._fanout(topic, payload)

    async def _fanout(self, topic: str, payload: bytes) -> None:
        for session in list(self._sessions.values()):
            for flt, sub_qos in session.subscriptions.items():
                if topic_matches(flt, topic):
                    await self._deliver(session, topic, payload, sub_qos)
                    break  # one delivery per client even with overlapping subs

    async def _deliver(self, session: _Session, topic: str, payload: bytes,
                       qos: int) -> None:
        if qos == 0:
            body = _utf8(topic) + payload
            pkt = _packet(PUBLISH, 0, body)
        else:
            self._packet_id = (self._packet_id % 0xFFFF) + 1
            body = _utf8(topic) + struct.pack("!H", self._packet_id) + payload
            pkt = _packet(PUBLISH, 0x02, body)
        try:
            await session.send(pkt)
        except (ConnectionResetError, RuntimeError):
            self._sessions.pop(session.client_id, None)

    async def _on_subscribe(self, session: _Session, body: bytes) -> None:
        (pid,) = struct.unpack_from("!H", body, 0)
        pos = 2
        codes = bytearray()
        new_filters: List[str] = []
        while pos < len(body):
            (flen,) = struct.unpack_from("!H", body, pos)
            pos += 2
            flt = body[pos:pos + flen].decode()
            pos += flen
            qos = min(body[pos], 1)  # QoS2 downgraded to 1
            pos += 1
            session.subscriptions[flt] = qos
            codes.append(qos)
            new_filters.append(flt)
        await session.send(_packet(SUBACK, 0,
                                   struct.pack("!H", pid) + bytes(codes)))
        # retained delivery on new subscription
        for flt in new_filters:
            for topic, (payload, qos) in list(self._retained.items()):
                if topic_matches(flt, topic):
                    await self._deliver(session, topic, payload,
                                        min(qos, session.subscriptions[flt]))

    async def _on_unsubscribe(self, session: _Session, body: bytes) -> None:
        (pid,) = struct.unpack_from("!H", body, 0)
        pos = 2
        while pos < len(body):
            (flen,) = struct.unpack_from("!H", body, pos)
            pos += 2
            session.subscriptions.pop(body[pos:pos + flen].decode(), None)
            pos += flen
        await session.send(_packet(UNSUBACK, 0, struct.pack("!H", pid)))


class MqttClient:
    """Asyncio MQTT 3.1.1 client (QoS 0/1, subscribe callbacks)."""

    def __init__(self, host: str, port: int, client_id: str = ""):
        self.host = host
        self.port = port
        self.client_id = client_id or f"swtpu-{id(self):x}"
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._read_task: Optional[asyncio.Task] = None
        self._packet_id = 0
        self._acks: Dict[int, asyncio.Future] = {}
        self._suback: Dict[int, asyncio.Future] = {}
        self._handlers: List[Tuple[str, Callable[[str, bytes],
                                                 Optional[Awaitable]]]] = []
        self._write_lock: Optional[asyncio.Lock] = None

    async def connect(self, timeout_s: float = 5.0) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._write_lock = asyncio.Lock()
        body = (_utf8("MQTT") + bytes([4]) + bytes([0x02])  # clean session
                + struct.pack("!H", 60) + _utf8(self.client_id))
        await self._send(_packet(CONNECT, 0, body))
        ptype, _, _ = await asyncio.wait_for(_read_packet(self._reader),
                                             timeout_s)
        if ptype != CONNACK:
            raise MqttProtocolError("expected CONNACK")
        self._read_task = asyncio.create_task(self._read_loop())

    async def _send(self, data: bytes) -> None:
        async with self._write_lock:
            self._writer.write(data)
            await self._writer.drain()

    def _next_pid(self) -> int:
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        return self._packet_id

    async def publish(self, topic: str, payload: bytes, qos: int = 0,
                      retain: bool = False, timeout_s: float = 5.0) -> None:
        flags = (qos << 1) | (1 if retain else 0)
        if qos == 0:
            await self._send(_packet(PUBLISH, flags, _utf8(topic) + payload))
            return
        pid = self._next_pid()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._acks[pid] = fut
        body = _utf8(topic) + struct.pack("!H", pid) + payload
        await self._send(_packet(PUBLISH, flags, body))
        await asyncio.wait_for(fut, timeout_s)

    async def subscribe(self, topic_filter: str,
                        handler: Callable[[str, bytes], Optional[Awaitable]],
                        qos: int = 1, timeout_s: float = 5.0) -> None:
        pid = self._next_pid()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._suback[pid] = fut
        self._handlers.append((topic_filter, handler))
        body = (struct.pack("!H", pid) + _utf8(topic_filter) + bytes([qos]))
        await self._send(_packet(SUBSCRIBE, 0x02, body))
        await asyncio.wait_for(fut, timeout_s)

    async def ping(self) -> None:
        await self._send(_packet(PINGREQ, 0, b""))

    async def _read_loop(self) -> None:
        try:
            while True:
                ptype, flags, body = await _read_packet(self._reader)
                if ptype == PUBLISH:
                    await self._on_publish(flags, body)
                elif ptype == PUBACK:
                    (pid,) = struct.unpack_from("!H", body, 0)
                    fut = self._acks.pop(pid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(None)
                elif ptype == SUBACK:
                    (pid,) = struct.unpack_from("!H", body, 0)
                    fut = self._suback.pop(pid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(None)
                elif ptype in (PINGRESP, UNSUBACK):
                    pass
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            pass

    async def _on_publish(self, flags: int, body: bytes) -> None:
        qos = (flags >> 1) & 0x03
        (tlen,) = struct.unpack_from("!H", body, 0)
        pos = 2
        topic = body[pos:pos + tlen].decode()
        pos += tlen
        if qos > 0:
            (pid,) = struct.unpack_from("!H", body, pos)
            pos += 2
            await self._send(_packet(PUBACK, 0, struct.pack("!H", pid)))
        payload = body[pos:]
        for flt, handler in self._handlers:
            if topic_matches(flt, topic):
                result = handler(topic, payload)
                if asyncio.iscoroutine(result):
                    await result
                break

    async def disconnect(self) -> None:
        if self._writer is None:
            return
        try:
            await self._send(_packet(DISCONNECT, 0, b""))
        except (ConnectionResetError, RuntimeError):
            pass
        if self._read_task is not None:
            self._read_task.cancel()
        self._writer.close()
        self._writer = None
