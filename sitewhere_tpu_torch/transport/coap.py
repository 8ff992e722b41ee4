"""Minimal CoAP (RFC 7252) UDP server for constrained devices.

Reference: service-event-sources coap/CoapServerEventReceiver.java hosts a
Californium CoAP server; devices POST JSON/binary event payloads to
resource paths. Here: an asyncio DatagramProtocol parsing the CoAP binary
header/options, dispatching POST/PUT to a handler, and answering with a
piggybacked ACK (2.04 Changed / 4.xx on error). Confirmable (CON) and
non-confirmable (NON) requests supported; no observe/blockwise (the
reference doesn't use them for ingest either).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Callable, Optional, Tuple

# method / response codes (class.detail)
GET, POST, PUT, DELETE = 1, 2, 3, 4
CHANGED = (2 << 5) | 4      # 2.04
BAD_REQUEST = (4 << 5) | 0  # 4.00
SERVER_ERROR = (5 << 5) | 0  # 5.00
TYPE_CON, TYPE_NON, TYPE_ACK, TYPE_RST = 0, 1, 2, 3
OPT_URI_PATH = 11


def _parse_options(data: bytes, pos: int) -> Tuple[list, int]:
    """Returns ([(number, value)], payload_start)."""
    options = []
    number = 0
    while pos < len(data):
        byte = data[pos]
        if byte == 0xFF:
            return options, pos + 1
        delta, length = byte >> 4, byte & 0x0F
        pos += 1
        if delta == 13:
            delta = data[pos] + 13
            pos += 1
        elif delta == 14:
            delta = struct.unpack_from("!H", data, pos)[0] + 269
            pos += 2
        if length == 13:
            length = data[pos] + 13
            pos += 1
        elif length == 14:
            length = struct.unpack_from("!H", data, pos)[0] + 269
            pos += 2
        number += delta
        options.append((number, data[pos:pos + length]))
        pos += length
    return options, len(data)


def parse_message(data: bytes):
    """-> (type, code, message_id, token, path, payload) or None if malformed."""
    if len(data) < 4:
        return None
    b0, code, mid = data[0], data[1], struct.unpack_from("!H", data, 2)[0]
    version, mtype, tkl = b0 >> 6, (b0 >> 4) & 0x03, b0 & 0x0F
    if version != 1 or tkl > 8:
        return None
    token = data[4:4 + tkl]
    options, payload_start = _parse_options(data, 4 + tkl)
    path = "/".join(v.decode("utf-8", "replace")
                    for n, v in options if n == OPT_URI_PATH)
    return mtype, code, mid, token, path, data[payload_start:]


def build_response(mtype: int, code: int, mid: int, token: bytes,
                   payload: bytes = b"") -> bytes:
    head = bytes([(1 << 6) | (mtype << 4) | len(token), code]) + \
        struct.pack("!H", mid) + token
    return head + (b"\xff" + payload if payload else b"")


def _encode_option(delta: int, value: bytes) -> bytes:
    def nibble(n: int) -> Tuple[int, bytes]:
        if n < 13:
            return n, b""
        if n < 269:
            return 13, bytes([n - 13])
        return 14, struct.pack("!H", n - 269)

    dn, dext = nibble(delta)
    ln, lext = nibble(len(value))
    return bytes([(dn << 4) | ln]) + dext + lext + value


def build_request(mtype: int, code: int, mid: int, path: str,
                  payload: bytes = b"", token: bytes = b"") -> bytes:
    """Client-side message builder (the piece Californium provides the
    reference's CoapCommandDeliveryProvider)."""
    head = bytes([(1 << 6) | (mtype << 4) | len(token), code]) + \
        struct.pack("!H", mid) + token
    options = b""
    previous = 0
    for segment in path.strip("/").split("/"):
        if not segment:
            continue
        options += _encode_option(OPT_URI_PATH - previous,
                                  segment.encode("utf-8"))
        previous = OPT_URI_PATH
    return head + options + (b"\xff" + payload if payload else b"")


class CoapClient:
    """Minimal CoAP client: POST a payload to host:port/path. CON requests
    wait for the piggybacked ACK; NON requests are fire-and-forget."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._mid = 0

    async def post(self, path: str, payload: bytes, confirmable: bool = True,
                   timeout_s: float = 5.0) -> Optional[int]:
        """Returns the response code for CON, None for NON."""
        self._mid = (self._mid + 1) & 0xFFFF
        mtype = TYPE_CON if confirmable else TYPE_NON
        message = build_request(mtype, POST, self._mid, path, payload)
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()
        mid = self._mid

        class _ClientProtocol(asyncio.DatagramProtocol):
            def connection_made(self, transport) -> None:
                transport.sendto(message)

            def datagram_received(self, data: bytes, addr) -> None:
                parsed = parse_message(data)
                if parsed and parsed[2] == mid and not done.done():
                    done.set_result(parsed[1])

        transport, _ = await loop.create_datagram_endpoint(
            _ClientProtocol, remote_addr=(self.host, self.port))
        try:
            if not confirmable:
                return None
            return await asyncio.wait_for(done, timeout_s)
        finally:
            transport.close()


class CoapServer:
    """`handler(path, payload, method) -> response payload or None` runs for
    every POST/PUT; exceptions map to 5.00."""

    def __init__(self, handler: Callable[[str, bytes, int], Optional[bytes]],
                 host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._transport: Optional[asyncio.DatagramTransport] = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Protocol(self), local_addr=(self.host, self.port))
        self.port = self._transport.get_extra_info("sockname")[1]

    async def stop(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, server: CoapServer):
        self.server = server
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        parsed = parse_message(data)
        if parsed is None:
            return
        mtype, code, mid, token, path, payload = parsed
        if mtype not in (TYPE_CON, TYPE_NON):
            return
        if code not in (POST, PUT):
            self._reply(mtype, BAD_REQUEST, mid, token, addr)
            return
        try:
            result = self.server.handler(path, payload, code)
            self._reply(mtype, CHANGED, mid, token, addr, result or b"")
        except Exception:
            self._reply(mtype, SERVER_ERROR, mid, token, addr)

    def _reply(self, req_type: int, code: int, mid: int, token: bytes,
               addr, payload: bytes = b"") -> None:
        if req_type == TYPE_CON:  # piggybacked ACK
            self.transport.sendto(
                build_response(TYPE_ACK, code, mid, token, payload), addr)
        # NON requests get no response (fire-and-forget ingest)
