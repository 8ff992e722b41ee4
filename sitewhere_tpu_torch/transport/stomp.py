"""In-process STOMP 1.2 broker + client (asyncio, from scratch).

Reference: service-event-sources hosts an in-JVM ActiveMQ broker and
consumes device events from one of its queues
(activemq/ActiveMQBrokerEventReceiver.java) — devices connect TO the
platform's own broker; no external middleware. The rebuild's equivalent
embeds this broker the same way the in-proc MQTT broker
(transport/mqtt.py) fills the HiveMQ/Mosquitto slot: a minimal,
dependency-free server speaking the real public protocol, so any STOMP
client library (stomp.py, stompjs, ActiveMQ's own clients) can publish
events at it.

Protocol subset (STOMP 1.2, https://stomp.github.io/): CONNECT/STOMP ->
CONNECTED; SEND fans out to SUBSCRIBE'd destinations as MESSAGE frames;
UNSUBSCRIBE, DISCONNECT, and `receipt` headers are honored; ACK/NACK are
accepted and ignored (subscriptions are ack:auto); heart-beats are
negotiated off (0,0). Frames: COMMAND line, header lines, blank line,
body, NUL. Bodies honor content-length (binary-safe) and fall back to
read-to-NUL.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

LOGGER = logging.getLogger("sitewhere.stomp")

_NUL = b"\x00"
_EOL = b"\n"
# hard caps — the client controls content-length and the header stream,
# and readexactly() is NOT bounded by the stream limit, so an
# unauthenticated socket could otherwise make the broker buffer
# arbitrary memory (real brokers enforce a max frame size the same way).
# Individual header LINES are already bounded by the asyncio stream
# limit (readline); the count cap bounds the whole header block.
MAX_FRAME_BYTES = 4 * 1024 * 1024
MAX_HEADERS = 128


class StompProtocolError(Exception):
    pass


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\r", "\\r")
            .replace("\n", "\\n").replace(":", "\\c"))


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            mapped = {"\\": "\\", "r": "\r", "n": "\n", "c": ":"}.get(nxt)
            if mapped is None:
                raise StompProtocolError(f"bad escape \\{nxt}")
            out.append(mapped)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def encode_frame(command: str, headers: Dict[str, str],
                 body: bytes = b"") -> bytes:
    lines = [command.encode("ascii")]
    hdrs = dict(headers)
    if body:
        hdrs.setdefault("content-length", str(len(body)))
    for key, value in hdrs.items():
        lines.append(f"{_escape(key)}:{_escape(str(value))}"
                     .encode("utf-8"))
    return _EOL.join(lines) + _EOL + _EOL + body + _NUL


async def read_frame(reader: asyncio.StreamReader
                     ) -> Optional[Tuple[str, Dict[str, str], bytes]]:
    """One frame, or None at EOF. Tolerates heart-beat/blank lines
    between frames."""
    # command line (skip EOLs used as heart-beats)
    while True:
        line = await reader.readline()
        if not line:
            return None
        stripped = line.strip(b"\r\n")
        if stripped:
            break
    command = stripped.decode("utf-8")
    headers: Dict[str, str] = {}
    header_lines = 0
    while True:
        line = await reader.readline()
        if not line:
            return None
        stripped = line.rstrip(b"\r\n")
        if not stripped:
            break
        # bound RAW header lines, not the deduplicated dict size: a
        # stream repeating one header forever would otherwise never trip
        # the cap (setdefault keeps len(headers) at 1) and spin this loop
        # unbounded
        header_lines += 1
        if header_lines > MAX_HEADERS:
            raise StompProtocolError("too many headers")
        key, sep, value = stripped.decode("utf-8").partition(":")
        if not sep:
            raise StompProtocolError(f"malformed header line {line!r}")
        # STOMP 1.2: repeated headers keep the FIRST occurrence
        headers.setdefault(_unescape(key), _unescape(value))
    length = headers.get("content-length")
    if length is not None:
        try:
            nbytes = int(length)
        except ValueError:
            raise StompProtocolError(
                f"bad content-length {length!r}") from None
        if nbytes < 0 or nbytes > MAX_FRAME_BYTES:
            raise StompProtocolError(f"bad content-length {length!r}")
        body = await reader.readexactly(nbytes)
        nul = await reader.readexactly(1)
        if nul != _NUL:
            raise StompProtocolError("frame body not NUL-terminated")
    else:
        try:
            raw = await reader.readuntil(_NUL)
        except asyncio.LimitOverrunError:
            raise StompProtocolError(
                "unframed body exceeds the stream limit; send "
                "content-length") from None
        body = raw[:-1]
    return command, headers, body


class _Subscription:
    def __init__(self, sub_id: str, destination: str, session):
        self.sub_id = sub_id
        self.destination = destination
        self.session = session


class _BrokerSession:
    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.subscriptions: Dict[str, _Subscription] = {}
        self._lock = asyncio.Lock()

    async def send(self, data: bytes) -> None:
        async with self._lock:
            self.writer.write(data)
            await self.writer.drain()


class StompBroker:
    """Embedded STOMP broker (the ActiveMQBrokerEventReceiver's in-JVM
    broker role). Topic semantics: every subscriber of a destination gets
    every message (devices publish telemetry; the platform receiver and
    any debugging consumer can both listen)."""

    # a subscriber that can't drain a frame within this budget is dead
    # weight: drop it rather than let its full TCP buffer stall every
    # publisher to the destination
    SEND_TIMEOUT_S = 10.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        # destination -> list of subscriptions
        self._subs: Dict[str, List[_Subscription]] = {}
        self._sessions: set = set()
        self._message_seq = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # server.close() only stops the LISTENER: established device
        # connections must be closed too, or they'd stay attached to a
        # dead broker silently dropping every SEND
        for session in list(self._sessions):
            session.writer.close()
        self._sessions.clear()
        self._subs.clear()

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        session = _BrokerSession(writer)
        self._sessions.add(session)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                command, headers, body = frame
                if command in ("CONNECT", "STOMP"):
                    await session.send(encode_frame(
                        "CONNECTED", {"version": "1.2",
                                      "heart-beat": "0,0"}))
                elif command == "SEND":
                    await self._on_send(headers, body)
                    await self._maybe_receipt(session, headers)
                elif command == "SUBSCRIBE":
                    self._on_subscribe(session, headers)
                    await self._maybe_receipt(session, headers)
                elif command == "UNSUBSCRIBE":
                    self._on_unsubscribe(session, headers)
                    await self._maybe_receipt(session, headers)
                elif command in ("ACK", "NACK"):
                    pass  # subscriptions are ack:auto
                elif command == "DISCONNECT":
                    await self._maybe_receipt(session, headers)
                    break
                else:
                    await session.send(encode_frame(
                        "ERROR", {"message": f"unsupported {command}"}))
                    break
        except (StompProtocolError, asyncio.IncompleteReadError,
                ConnectionError) as exc:
            LOGGER.debug("stomp session ended: %s", exc)
        finally:
            self._sessions.discard(session)
            for sub in list(session.subscriptions.values()):
                self._drop(sub)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _maybe_receipt(session: _BrokerSession,
                             headers: Dict[str, str]) -> None:
        receipt = headers.get("receipt")
        if receipt:
            await session.send(encode_frame("RECEIPT",
                                            {"receipt-id": receipt}))

    def _on_subscribe(self, session: _BrokerSession,
                      headers: Dict[str, str]) -> None:
        sub_id = headers.get("id")
        destination = headers.get("destination")
        if not sub_id or not destination:
            raise StompProtocolError("SUBSCRIBE requires id + destination")
        sub = _Subscription(sub_id, destination, session)
        session.subscriptions[sub_id] = sub
        self._subs.setdefault(destination, []).append(sub)

    def _on_unsubscribe(self, session: _BrokerSession,
                        headers: Dict[str, str]) -> None:
        sub = session.subscriptions.pop(headers.get("id", ""), None)
        if sub is not None:
            self._drop(sub)

    def _drop(self, sub: _Subscription) -> None:
        subs = self._subs.get(sub.destination, [])
        if sub in subs:
            subs.remove(sub)
        if not subs:
            self._subs.pop(sub.destination, None)

    async def _on_send(self, headers: Dict[str, str], body: bytes) -> None:
        destination = headers.get("destination")
        if not destination:
            raise StompProtocolError("SEND requires destination")
        self._message_seq += 1
        for sub in list(self._subs.get(destination, [])):
            frame = encode_frame("MESSAGE", {
                "destination": destination,
                "message-id": str(self._message_seq),
                "subscription": sub.sub_id,
            }, body)
            try:
                await asyncio.wait_for(sub.session.send(frame),
                                       self.SEND_TIMEOUT_S)
            except asyncio.TimeoutError:
                LOGGER.warning(
                    "dropping stalled subscriber %s on %s (write "
                    "exceeded %.0fs)", sub.sub_id, destination,
                    self.SEND_TIMEOUT_S)
                self._drop(sub)
                sub.session.writer.close()
            except (ConnectionError, OSError):
                self._drop(sub)


class StompClient:
    """Minimal STOMP 1.2 client for the embedded broker (tests, in-proc
    consumers, co-located simulators)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._read_task: Optional[asyncio.Task] = None
        self._connected = asyncio.Event()
        self._sub_seq = 0
        self._handlers: Dict[str, Callable[[Dict[str, str], bytes],
                                           Awaitable[None]]] = {}

    async def connect(self, timeout_s: float = 5.0) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._writer.write(encode_frame(
            "CONNECT", {"accept-version": "1.2", "host": self.host,
                        "heart-beat": "0,0"}))
        await self._writer.drain()
        self._read_task = asyncio.ensure_future(self._read_loop())
        try:
            await asyncio.wait_for(self._connected.wait(), timeout_s)
        except asyncio.TimeoutError:
            # no CONNECTED handshake: don't leak the socket + read task
            # (a reconnect loop would accumulate one of each per try)
            self._read_task.cancel()
            self._read_task = None
            self._writer.close()
            self._writer = None
            self._reader = None
            raise

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                command, headers, body = frame
                if command == "CONNECTED":
                    self._connected.set()
                elif command == "MESSAGE":
                    handler = self._handlers.get(
                        headers.get("subscription", ""))
                    if handler is not None:
                        try:
                            await handler(headers, body)
                        except Exception:
                            # one poison message must not kill the read
                            # loop — the subscription would stay live at
                            # the broker while nothing reads it
                            LOGGER.exception(
                                "stomp message handler failed")
                elif command == "ERROR":
                    LOGGER.warning("stomp error frame: %s",
                                   headers.get("message"))
        except (StompProtocolError, asyncio.IncompleteReadError,
                ConnectionError):
            pass

    async def _send(self, data: bytes) -> None:
        if self._writer is None:
            raise StompProtocolError("not connected")
        self._writer.write(data)
        await self._writer.drain()

    async def send(self, destination: str, body: bytes,
                   headers: Optional[Dict[str, str]] = None) -> None:
        hdrs = {"destination": destination, **(headers or {})}
        await self._send(encode_frame("SEND", hdrs, body))

    async def subscribe(self, destination: str,
                        handler: Callable[[Dict[str, str], bytes],
                                          Awaitable[None]]) -> str:
        self._sub_seq += 1
        sub_id = f"sub-{self._sub_seq}"
        self._handlers[sub_id] = handler
        await self._send(encode_frame(
            "SUBSCRIBE", {"id": sub_id, "destination": destination,
                          "ack": "auto"}))
        return sub_id

    async def disconnect(self) -> None:
        if self._writer is not None:
            try:
                await self._send(encode_frame("DISCONNECT", {}))
            except (StompProtocolError, ConnectionError, OSError):
                pass
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
        if self._read_task is not None:
            self._read_task.cancel()
            self._read_task = None
