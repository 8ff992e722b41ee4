"""Stream/HTTP/WebSocket listener servers for device ingest.

Reference: service-event-sources socket/SocketInboundEventReceiver.java
(raw TCP), WebSocketEventReceiver, and the polling/HTTP receivers. Each
server here accepts device payloads and hands complete binary messages to
an async callback; framing for the TCP path is the wire-protocol frame
header (transport/wire.py), so a connection can stream many events.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional

from aiohttp import web

from sitewhere_tpu_torch.transport.wire import WireError, decode_frames

PayloadHandler = Callable[[bytes], Awaitable[None]]


class SocketEventServer:
    """TCP listener; splits the byte stream into wire frames and forwards
    each complete frame (header included) to the handler."""

    def __init__(self, handler: PayloadHandler, host: str = "127.0.0.1",
                 port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._client, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        buffer = b""
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                buffer += chunk
                try:
                    frames, rest = decode_frames(buffer)
                except WireError:
                    break  # corrupt stream (or frame over cap): drop it
                if frames:
                    # forward the consumed prefix verbatim — no re-encode;
                    # the source's WireDecoder handles multi-frame payloads
                    await self.handler(buffer[:len(buffer) - len(rest)])
                buffer = rest
        finally:
            writer.close()


class WebSocketEventServer:
    """WebSocket listener: each binary message is one complete payload."""

    def __init__(self, handler: PayloadHandler, host: str = "127.0.0.1",
                 port: int = 0, path: str = "/events"):
        self.handler = handler
        self.host = host
        self.port = port
        self.path = path
        self._server = None

    async def start(self) -> None:
        import websockets

        async def on_connection(websocket) -> None:
            async for message in websocket:
                if isinstance(message, str):
                    message = message.encode()
                await self.handler(message)

        self._server = await websockets.serve(on_connection, self.host,
                                              self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


class HttpEventServer:
    """HTTP POST listener (`POST /events`): request body is one payload.
    Covers both the reference's HTTP receiver and its polling REST receiver's
    server half."""

    def __init__(self, handler: PayloadHandler, host: str = "127.0.0.1",
                 port: int = 0, path: str = "/events"):
        self.handler = handler
        self.host = host
        self.port = port
        self.path = path
        self._runner: Optional[web.AppRunner] = None

    async def start(self) -> None:
        app = web.Application()

        async def post(request: web.Request) -> web.Response:
            await self.handler(await request.read())
            return web.json_response({"accepted": True})

        app.router.add_post(self.path, post)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
