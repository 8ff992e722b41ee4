"""Threaded HTTP server hosting the REST gateway.

Reference: service-web-rest is a Spring Boot web app fronting every backend
service via gRPC ApiDemux channels (SURVEY.md §3.5); auth is a JWT filter
(security/jwt/TokenAuthenticationFilter.java) with tokens minted by
`auth/controllers/JwtService.java` from HTTP Basic credentials. Here the
gateway calls tenant engines in-process; the HTTP layer is the stdlib
ThreadingHTTPServer so the framework stays dependency-free.

Auth model (mirrors the reference):
  POST/GET /authapi/jwt         HTTP Basic → {"token": <jwt>}
  everything under /api/**      Authorization: Bearer <jwt>
  tenant routing                X-SiteWhere-Tenant header (tenant token;
                                the reference's X-SiteWhere-Tenant-Id)
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from sitewhere_tpu_torch.errors import AuthError, SiteWhereError
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.web.marshal import to_jsonable
from sitewhere_tpu_torch.web.router import Request, Router

LOGGER = logging.getLogger("sitewhere.web")


class SseStream:
    """Handler return type for server-sent events: the server streams each
    item from `events()` as an SSE `data:` frame (JSON-encoded unless str)
    until the generator ends or the client disconnects. The reference pushes
    the same live feeds over a WebSocket (service-web-rest
    ws/components/TopologyBroadcaster.java); SSE keeps it dependency-free."""

    def __init__(self, events):
        self.events = events  # iterable / generator


class RestServer(LifecycleComponent):
    """HTTP front door for a SiteWhereInstance."""

    def __init__(self, instance, host: str = "127.0.0.1", port: int = 0,
                 token_expiration_minutes: int = 60):
        super().__init__("rest-server")
        self.instance = instance
        self.router = Router()
        self.host = host
        self.port = port
        self.token_expiration_minutes = token_expiration_minutes
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        from sitewhere_tpu_torch.web.controllers import register_all
        register_all(self.router, instance, self)
        from sitewhere_tpu_torch.web.admin import register_admin
        register_admin(self.router)
        from sitewhere_tpu_torch.web.explorer import register_explorer
        register_explorer(self.router)

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to framework logging
                LOGGER.debug("%s %s", self.address_string(), fmt % args)

            def _handle(self):
                server._handle_http(self)

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rest-server", daemon=True)
        self._thread.start()
        LOGGER.info("REST gateway listening on %s:%d", self.host, self.port)

    def on_stop(self, monitor) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- request handling --------------------------------------------------
    def _authenticate_basic(self, header: str) -> str:
        """HTTP Basic credentials → JWT (the /authapi/jwt flow)."""
        try:
            decoded = base64.b64decode(header.split(" ", 1)[1]).decode("utf-8")
            username, password = decoded.split(":", 1)
        except Exception:
            raise AuthError("malformed basic credentials")
        user = self.instance.user_management.authenticate(username, password)
        return self.instance.token_management.generate_token(
            user.username,
            authorities=self.instance.user_management.get_user_authorities(
                user.username),
            expiration_minutes=self.token_expiration_minutes)

    def _claims_for(self, handler: BaseHTTPRequestHandler) -> Optional[dict]:
        header = handler.headers.get("Authorization", "")
        if header.startswith("Bearer "):
            from sitewhere_tpu_torch.security.tokens import InvalidTokenError
            try:
                return self.instance.token_management.get_claims(
                    header.split(" ", 1)[1])
            except InvalidTokenError as err:
                raise AuthError(str(err))
        return None

    def _handle_http(self, handler: BaseHTTPRequestHandler) -> None:
        try:
            parsed = urlparse(handler.path)
            body: Any = None
            raw_body: Optional[bytes] = None
            length = int(handler.headers.get("Content-Length") or 0)
            if length:
                raw_body = handler.rfile.read(length)
                ctype = handler.headers.get("Content-Type", "")
                if "json" in ctype or not ctype:
                    body = json.loads(raw_body) if raw_body.strip() else None
                else:
                    body = raw_body

            # token minting endpoint (basic auth, no bearer required)
            if parsed.path.rstrip("/") == "/authapi/jwt":
                auth_header = handler.headers.get("Authorization", "")
                if not auth_header.startswith("Basic "):
                    raise AuthError("basic authentication required")
                token = self._authenticate_basic(auth_header)
                self._respond(handler, 200, {"token": token})
                return

            request = Request(
                method=handler.command, path=parsed.path,
                query=self.router.parse_query(parsed.query), body=body,
                raw_body=raw_body,
                headers={k: v for k, v in handler.headers.items()},
                claims=self._claims_for(handler),
                tenant=handler.headers.get(
                    "X-SiteWhere-Tenant",
                    handler.headers.get("X-SiteWhere-Tenant-Id")))
            # W3C trace-context ingress: an incoming `traceparent` header
            # parents the dispatch span (and, via the tracer's
            # thread-local stack, every span the handler opens on this
            # thread); the response echoes the server span's context so
            # callers can stitch their traces to ours.
            from sitewhere_tpu_torch.runtime.faults import fault_point
            from sitewhere_tpu_torch.runtime.tracing import (
                GLOBAL_TRACER, extract_traceparent, inject_traceparent)
            # drill: a stalled REST worker (delay-mode rule) holds this
            # thread mid-request — ThreadingHTTPServer keeps serving on
            # the others, which is exactly what the drill verifies
            fault_point("rest_worker_stall")
            parent_ctx = extract_traceparent(
                handler.headers.get("traceparent"))
            with GLOBAL_TRACER.span(
                    f"rest.{handler.command.lower()}",
                    parent=parent_ctx, path=parsed.path) as span:
                handler._sw_traceparent = inject_traceparent(span)
                result = self.router.dispatch(request)
            if isinstance(result, SseStream):
                self._stream_sse(handler, result)
                return
            status, ctype = 200, None
            if isinstance(result, tuple):
                if len(result) == 3:
                    status, result, ctype = result
                else:
                    status, result = result
            self._respond(handler, status, result, ctype)
        except SiteWhereError as err:
            self._respond(handler, err.http_status,
                          {"message": str(err), "errorCode": int(err.code)})
        except json.JSONDecodeError as err:
            self._respond(handler, 400, {"message": f"invalid JSON: {err}"})
        except Exception as err:  # controller bug — surface as 500
            LOGGER.exception("unhandled REST error")
            self._respond(handler, 500, {"message": str(err)})

    def _stream_sse(self, handler: BaseHTTPRequestHandler,
                    stream: SseStream) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        try:
            for event in stream.events:
                if isinstance(event, str) and event.startswith(":"):
                    frame = f"{event}\n\n"     # SSE comment (keepalive)
                elif isinstance(event, str):
                    frame = f"data: {event}\n\n"
                else:
                    frame = f"data: {json.dumps(to_jsonable(event))}\n\n"
                handler.wfile.write(frame.encode())
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away — the generator's finally cleans up
        except Exception:
            # the 200 header block is committed: a second send_response
            # would corrupt the stream, so terminate it instead
            LOGGER.exception("SSE stream generator failed")
        finally:
            close = getattr(stream.events, "close", None)
            if close is not None:
                close()

    def _respond(self, handler: BaseHTTPRequestHandler, status: int,
                 payload: Any, ctype: Optional[str] = None) -> None:
        if isinstance(payload, bytes):
            data = payload
            ctype = ctype or "application/octet-stream"
        else:
            data = json.dumps(to_jsonable(payload)).encode("utf-8")
            ctype = "application/json"
        try:
            handler.send_response(status)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(len(data)))
            traceparent = getattr(handler, "_sw_traceparent", None)
            if traceparent:
                handler.send_header("traceparent", traceparent)
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass
