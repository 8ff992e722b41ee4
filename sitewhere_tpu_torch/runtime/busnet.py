"""Networked bus edge: TCP producer/consumer endpoint for the event bus.

Counterpart of `sitewhere_tpu/runtime/busnet.py`, frame for frame: a client
of either package talks to a server of the other (tests/test_torch_busnet.py).
Reference: Kafka is a *network* broker — any process can produce to or
consume from a topic (MicroserviceKafkaConsumer.java:115-121 polls over the
wire). The in-proc `runtime.bus.EventBus` replaces the broker for the
single-host fast path; this module is the edge complement: the card host's
process runs `BusServer` over its bus, and edge processes (gateway boxes,
protocol bridges, feeder workers) use `BusClient` / `RemoteConsumerHost` to
publish and consume over TCP with the same at-least-once committed-offset
semantics.

Protocol: length-prefixed msgpack frames, one request -> one response per
frame, pipelined per connection. Batched publishes amortize round-trips
(the DeviceEventBuffer trade); polls long-poll server-side so edge
consumers don't spin.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

import msgpack

from sitewhere_tpu_torch.runtime.bus import (EventBus, Record, batch_extent,
                                             jittered)
from sitewhere_tpu_torch.runtime.faults import fault_point
from sitewhere_tpu_torch.runtime.recovery import EpochFence, StaleEpochError
from sitewhere_tpu_torch.runtime.tracing import (GLOBAL_TRACER,
                                                 extract_traceparent)

_LEN = struct.Struct("<I")
_MAX_FRAME = 64 * 1024 * 1024


class BusNetError(Exception):
    """Protocol or transport failure on the networked bus edge."""


class StaleEpochBusError(BusNetError, StaleEpochError):
    """Fencing rejection over the wire: a request stamped with an epoch
    below the server's fenced floor for its resource. Catchable as a
    BusNetError (publishers park, consumers back off — the zombie's
    rows never reach live state) AND as the structured StaleEpochError
    (resource/epoch/floor ride the exception)."""


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise BusNetError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(sock: socket.socket, obj) -> None:
    payload = msgpack.packb(obj, use_bin_type=True)
    if len(payload) > _MAX_FRAME:
        raise BusNetError(f"frame {len(payload)} exceeds {_MAX_FRAME}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket):
    (length,) = _LEN.unpack(_read_exact(sock, _LEN.size))
    if length > _MAX_FRAME:
        raise BusNetError(f"frame {length} exceeds {_MAX_FRAME}")
    return msgpack.unpackb(_read_exact(sock, length), raw=False)


class _GroupCoordinator:
    """Networked consumer-group membership: each connected consumer of a
    (topic, group) is a member and owns a disjoint partition subset
    (index i of n members owns partitions p with p % n == i — the Kafka
    range/round-robin assignment role). Members poll and commit ONLY their
    partitions, so one member's commit can never advance offsets past
    another member's in-flight batch; on member loss its partitions re-seek
    to committed and reassign to the survivors (rebalance + replay)."""

    def __init__(self, bus: EventBus):
        self.bus = bus
        self._members: dict = {}   # (topic, group) -> list of member ids
        self._lock = threading.Lock()

    def _ensure(self, topic: str, group: str, member: int) -> bool:
        """Register membership; True when this call changed the group."""
        with self._lock:
            members = self._members.setdefault((topic, group), [])
            if member not in members:
                members.append(member)
                return True
            return False

    def owned(self, topic: str, group: str, member: int) -> List[int]:
        if self._ensure(topic, group, member):
            # Rebalance: partitions just moved between members, and a
            # previous owner's uncommitted position advances must not leak
            # to the new owner — everyone replays from committed
            # (at-least-once; duplicates possible, loss not).
            self.bus.consumer(topic, group).seek_to_committed()
        n_parts = len(self.bus.topic(topic).partitions)
        with self._lock:
            members = self._members[(topic, group)]
            index = members.index(member)
            count = len(members)
        return [p for p in range(n_parts) if p % count == index]

    def leave_all(self, member: int) -> None:
        with self._lock:
            affected = [(key, members) for key, members in
                        self._members.items() if member in members]
            for _, members in affected:
                members.remove(member)
        for (topic, group), _ in affected:
            # released partitions replay from committed on the next owner
            self.bus.consumer(topic, group).seek_to_committed()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        bus: EventBus = self.server.bus  # type: ignore[attr-defined]
        coordinator = self.server.coordinator  # type: ignore[attr-defined]
        member = id(self)
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    req = _recv_frame(sock)
                except (BusNetError, OSError):
                    return  # client went away (or stop() severed us)
                # drill directives (runtime/faults.py; no-ops disarmed):
                # a partition window severs every connection on arrival,
                # a drop eats the RESPONSE after the op ran (the
                # lost-reply case BusClient._rpc's pre_retry exists for),
                # a delay stalls the reply in flight.
                if fault_point("busnet_partition") is not None:
                    return
                try:
                    # W3C trace propagation: a client-stamped envelope
                    # opens a server span parented on the caller's
                    # context, stitching feeder -> mesh-host journeys.
                    # Unstamped requests (the overwhelming steady state)
                    # pay one dict lookup.
                    ctx = extract_traceparent(req.get("traceparent"))
                    if ctx is not None:
                        with GLOBAL_TRACER.span(
                                f"busnet.{req.get('op')}", parent=ctx,
                                topic=str(req.get("topic", ""))):
                            resp = self._dispatch(
                                bus, coordinator, member, req,
                                self.server.fence,  # type: ignore[attr-defined]
                                getattr(self.server,
                                        "telemetry_provider", None),
                                getattr(self.server, "op_handlers", None))
                    else:
                        resp = self._dispatch(
                            bus, coordinator, member, req,
                            self.server.fence,  # type: ignore[attr-defined]
                            getattr(self.server, "telemetry_provider",
                                    None),
                            getattr(self.server, "op_handlers", None))
                    fault_point("busnet_delay")
                    if fault_point("busnet_drop") is not None:
                        return
                    _send_frame(sock, resp)
                except (BusNetError, OSError):
                    return
                except Exception as exc:  # report, keep the connection
                    try:
                        _send_frame(sock, {"ok": False, "error": str(exc)})
                    except (BusNetError, OSError):
                        return
        finally:
            untrack = getattr(self.server, "untrack_connection", None)
            if untrack is not None:
                untrack(sock)
            coordinator.leave_all(member)

    @staticmethod
    def _dispatch(bus: EventBus, coordinator: _GroupCoordinator,
                  member: int, req, fence: EpochFence,
                  telemetry_provider: Optional[Callable[[], dict]] = None,
                  op_handlers: Optional[dict] = None) -> dict:
        op = req.get("op")

        def _parts(topic: str, group: str):
            # Explicit partition pinning: a leased owner (feeders/) names
            # the partitions its lease covers instead of taking the
            # connection-scoped group assignment — ownership then follows
            # the LEASE (durable, fenced, stealable at epoch+1), not the
            # TCP connection. Absent, the coordinator assignment applies.
            pinned = req.get("partitions")
            if pinned is not None:
                return [int(p) for p in pinned]
            return coordinator.owned(topic, group, member)

        # Epoch fencing (runtime/recovery.py): a request stamped with a
        # fencing identity is admitted only at-or-above the resource's
        # fenced floor. Floors auto-learn from admitted traffic (a
        # restarted writer's newer epoch fences its old incarnation) and
        # are raised explicitly by the takeover broadcast below — the
        # zombie/split-brain write guard. Unstamped requests pass
        # (backward compatible; fencing is opt-in per writer). Two stamp
        # forms check the same floors: the single `fence` identity, and
        # the multi-key `fences` list ([key, epoch] pairs) consume-side
        # ops use to cover every leased partition in one request — a
        # fenced-out zombie's poll/commit/seek must bounce BEFORE it can
        # move the shared server-side cursor (records a zombie silently
        # skips past would otherwise look like replays downstream and be
        # dropped — permanent loss, not duplicates).
        fence_key = req.get("fence")

        def _stale_reply():
            checks = []
            if fence_key is not None:
                checks.append((str(fence_key), int(req.get("epoch", 0))))
            for pair in req.get("fences") or []:
                checks.append((str(pair[0]), int(pair[1])))
            for key, epoch in checks:
                if not fence.admit(key, epoch):
                    floor = fence.floor(key)
                    return {"ok": False, "stale_epoch": True,
                            "fence": key, "epoch": epoch, "floor": floor,
                            "error": f"stale epoch {epoch} < fenced "
                                     f"floor {floor} for '{key}'"}
            return None

        if op != "fence":
            stale = _stale_reply()
            if stale is not None:
                return stale
        if op == "fence":
            # takeover broadcast: raise the floor for a (usually dead)
            # writer's identity so its surviving incarnation is rejected
            floor = fence.fence(str(req["key"]), int(req["epoch"]))
            return {"ok": True, "floor": floor}
        if op == "publish":
            topic = bus.topic(req["topic"])
            records = req["records"]
            if not records:
                return {"ok": True, "count": 0, "last": None}
            last = topic.publish_many(records)
            return {"ok": True, "count": len(records), "last": list(last)}
        if op == "poll":
            topic, group = req["topic"], req["group"]
            owned = _parts(topic, group)
            consumer = bus.consumer(topic, group)
            commit_at = req.get("commit_at")
            if commit_at:
                # piggybacked EXPLICIT-offset commit of the previous batch:
                # edge consumers save a full round trip per batch
                # (poll+commit -> one request). Explicit offsets (not
                # commit-position) so a later failed batch can never be
                # committed by accident.
                bus.commit_at(consumer,
                              {int(k): int(v) for k, v in commit_at.items()},
                              partitions=owned)
            until = req.get("until")
            if until is not None:
                until = {int(k): int(v) for k, v in until.items()}
            batch = consumer.poll(req.get("max", 4096),
                                  timeout_s=min(float(req.get("timeout_s",
                                                              0.0)), 30.0),
                                  partitions=owned, until=until)
            if fence_key is not None or req.get("fences"):
                # re-validate AFTER the poll: a takeover that raised the
                # floor while this poll was in flight must not let the
                # zombie's cursor advance stand — rewind to committed
                # (idempotent with the successor's own seek) and reject,
                # so no record is silently skipped past
                stale = _stale_reply()
                if stale is not None:
                    consumer.seek_to_committed(partitions=owned)
                    return stale
            return {"ok": True, "records": [
                [r.partition, r.offset, r.key, r.value, r.timestamp_ms]
                for r in batch]}
        if op == "commit":
            topic, group = req["topic"], req["group"]
            owned = _parts(topic, group)
            bus.commit(bus.consumer(topic, group), partitions=owned)
            return {"ok": True}
        if op == "commit_at":
            topic, group = req["topic"], req["group"]
            owned = _parts(topic, group)
            bus.commit_at(bus.consumer(topic, group),
                          {int(k): int(v)
                           for k, v in req.get("offsets", {}).items()},
                          partitions=owned)
            return {"ok": True}
        if op == "seek_committed":
            topic, group = req["topic"], req["group"]
            owned = _parts(topic, group)
            bus.consumer(topic, group).seek_to_committed(partitions=owned)
            return {"ok": True}
        if op == "end_offsets":
            return {"ok": True,
                    "offsets": bus.topic(req["topic"]).end_offsets()}
        if op == "topics":
            return {"ok": True, "topics": bus.topics()}
        if op == "ping":
            return {"ok": True, "ts": int(time.time() * 1000)}
        if op == "telemetry":
            # cluster fan-in: hand back this process's observability
            # snapshot (metrics/flight/age/prometheus text) assembled by
            # whatever the host wired in via BusServer.telemetry_provider
            if telemetry_provider is None:
                return {"ok": False, "error": "no telemetry provider"}
            return {"ok": True, "telemetry": telemetry_provider()}
        if op_handlers:
            handler = op_handlers.get(op)
            if handler is not None:
                # pluggable subsystem ops (BusServer.register_op): the
                # handler sees the raw request AFTER the fence admit above
                # and returns the response dict (ok/error convention)
                return handler(req)
        return {"ok": False, "error": f"unknown op {op!r}"}


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._connections: set = set()
        self._connections_lock = threading.Lock()

    def process_request(self, request, client_address):
        # Track in the accept loop, not the handler thread: registration
        # must happen-before shutdown() returns, or a connection accepted
        # during stop() would escape sever_connections().
        self.track_connection(request)
        super().process_request(request, client_address)

    def track_connection(self, sock) -> None:
        with self._connections_lock:
            self._connections.add(sock)

    def untrack_connection(self, sock) -> None:
        with self._connections_lock:
            self._connections.discard(sock)

    def sever_connections(self) -> None:
        """Force-close live client connections. Without this, a stopped
        server's handler threads keep serving clients against the OLD bus
        instance — publishes 'succeed' into dead state and are lost when
        a replacement server takes the port."""
        with self._connections_lock:
            conns = list(self._connections)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class BusServer:
    """Expose an EventBus on TCP (the broker's network face)."""

    def __init__(self, bus: EventBus, host: str = "127.0.0.1",
                 port: int = 0):
        self.bus = bus
        self._server = _Server((host, port), _Handler)
        self._server.bus = bus  # type: ignore[attr-defined]
        self._server.coordinator = _GroupCoordinator(bus)  # type: ignore[attr-defined]
        self._server.fence = EpochFence()  # type: ignore[attr-defined]
        self._server.telemetry_provider = None  # type: ignore[attr-defined]
        self._server.op_handlers = {}  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    def register_op(self, name: str,
                    handler: Callable[[dict], dict]) -> None:
        """Mount a subsystem op on this server's dispatch table (e.g. the
        feeder fleet's `feeder_*` family, feeders/service.py). The
        handler receives the raw request dict after epoch-fence admission
        and returns the response dict; exceptions become `{"ok": False,
        "error": ...}` replies on a healthy connection. Built-in ops
        cannot be shadowed — dispatch consults the registry last."""
        self._server.op_handlers[str(name)] = handler  # type: ignore[attr-defined]

    @property
    def fence(self) -> EpochFence:
        """The server's per-resource epoch floors (fencing state)."""
        return self._server.fence  # type: ignore[attr-defined]

    @property
    def telemetry_provider(self) -> Optional[Callable[[], dict]]:
        """Zero-arg callable answering the `telemetry` op (cluster
        fan-in); None rejects the op."""
        return self._server.telemetry_provider  # type: ignore[attr-defined]

    @telemetry_provider.setter
    def telemetry_provider(self, fn: Optional[Callable[[], dict]]) -> None:
        self._server.telemetry_provider = fn  # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="bus-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server.sever_connections()
        self._thread.join(timeout=5.0)
        self._thread = None


class BusClient:
    """Edge-process handle onto a remote bus. Thread-safe (one in-flight
    request per connection); reconnects on transport failure — safe because
    every operation is idempotent-or-at-least-once (a retried publish can
    duplicate, exactly the at-least-once contract)."""

    def __init__(self, host: str, port: int, timeout_s: float = 35.0,
                 retries: int = 2):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.retries = retries
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # fencing identity: once set, every request is stamped with
        # (fence, epoch) and the server rejects it below the floor
        self._fence_key: Optional[str] = None
        self._epoch = 0

    def set_epoch(self, fence_key: str, epoch: int) -> None:
        """Adopt a fencing identity: stamp subsequent requests with this
        resource key + epoch (minted by runtime/recovery.py at boot or
        takeover)."""
        self._fence_key = str(fence_key)
        self._epoch = int(epoch)

    def fence(self, key: str, epoch: int) -> int:
        """Raise the server's floor for `key` to at least `epoch` (the
        takeover broadcast); returns the resulting floor."""
        return int(self._rpc({"op": "fence", "key": str(key),
                              "epoch": int(epoch)})["floor"])

    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self._sock

    def _rpc(self, req: dict, pre_retry: Optional[dict] = None) -> dict:
        """One request/response. On transport failure, reconnect and retry;
        `pre_retry` is sent first after a reconnect — poll uses it to re-seek
        the server-side cursor to committed, because a poll whose RESPONSE
        was lost already advanced the position (retrying blindly would skip
        those records and the next commit would lose them permanently)."""
        if self._fence_key is not None and req.get("op") != "fence" \
                and "fence" not in req:
            req = dict(req, fence=self._fence_key, epoch=self._epoch)
        if "traceparent" not in req:
            # trace propagation mirrors the fence stamp: when the calling
            # thread has an active span (sampled journeys, REST ingress),
            # its W3C context rides the envelope so the server span
            # stitches into the same trace. No span -> one dict lookup.
            tp = GLOBAL_TRACER.current_traceparent()
            if tp is not None:
                req = dict(req, traceparent=tp)
        with self._lock:
            last: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                try:
                    sock = self._connect()
                    if pre_retry is not None and attempt > 0:
                        _send_frame(sock, pre_retry)
                        ack = _recv_frame(sock)
                        if not ack.get("ok"):
                            raise BusNetError(
                                ack.get("error", "pre-retry failed"))
                    _send_frame(sock, req)
                    resp = _recv_frame(sock)
                    if not resp.get("ok"):
                        if resp.get("stale_epoch"):
                            # fenced: structured, non-retryable — the
                            # socket stays healthy, the WRITER is dead
                            raise StaleEpochBusError(
                                str(resp.get("fence", "")),
                                int(resp.get("epoch", 0)),
                                int(resp.get("floor", 0)))
                        raise BusNetError(resp.get("error", "request failed"))
                    return resp
                except (OSError, BusNetError) as exc:
                    if isinstance(exc, BusNetError) and self._sock is not None:
                        # protocol-level error on a healthy connection:
                        # don't burn the socket or retry a rejected request
                        if str(exc) != "connection closed":
                            raise
                    last = exc
                    self.close()
                    if attempt < self.retries:
                        # capped exponential backoff with equal jitter:
                        # immediate lockstep reconnects from every client
                        # hammer exactly the server trying to come back
                        time.sleep(jittered(min(0.05 * (2 ** attempt),
                                                1.0)))
            raise BusNetError(f"bus rpc failed after retries: {last}")

    def publish(self, topic: str, key: bytes, value: bytes
                ) -> Tuple[int, int]:
        resp = self._rpc({"op": "publish", "topic": topic,
                          "records": [[key, value]]})
        part, offset = resp["last"]
        return part, offset

    def publish_batch(self, topic: str,
                      records: List[Tuple[bytes, bytes]]) -> int:
        if not records:
            return 0
        return self._rpc({"op": "publish", "topic": topic,
                          "records": [[k, v] for k, v in records]})["count"]

    def poll(self, topic: str, group: str, max_records: int = 4096,
             timeout_s: float = 0.0,
             until: Optional[dict] = None,
             commit_at: Optional[dict] = None,
             partitions: Optional[List[int]] = None,
             fences: Optional[List] = None) -> List[Record]:
        req = {"op": "poll", "topic": topic, "group": group,
               "max": max_records, "timeout_s": timeout_s}
        if commit_at:
            req["commit_at"] = {str(k): int(v) for k, v in commit_at.items()}
        if until is not None:
            req["until"] = {str(k): int(v) for k, v in until.items()}
        pre_retry = {"op": "seek_committed", "topic": topic, "group": group}
        if partitions is not None:
            # lease-pinned consumption (feeders/): poll exactly the named
            # partitions regardless of the coordinator's connection-scoped
            # assignment; the re-seek after a lost reply pins the same set
            req["partitions"] = [int(p) for p in partitions]
            pre_retry["partitions"] = [int(p) for p in partitions]
        if fences:
            # per-partition epoch stamps: a fenced-out caller bounces
            # with stale_epoch instead of advancing the shared cursor;
            # the lost-reply re-seek carries the same stamps so a
            # zombie's retry cannot rewind a successor's partition
            stamps = [[str(k), int(e)] for k, e in fences]
            req["fences"] = stamps
            pre_retry["fences"] = stamps
        resp = self._rpc(req, pre_retry=pre_retry)
        return [Record(topic, part, offset, key, value, ts)
                for part, offset, key, value, ts in resp["records"]]

    def commit(self, topic: str, group: str) -> None:
        self._rpc({"op": "commit", "topic": topic, "group": group})

    def commit_at(self, topic: str, group: str, offsets: dict,
                  partitions: Optional[List[int]] = None,
                  fences: Optional[List] = None) -> None:
        """Commit explicit per-partition exclusive end offsets."""
        req = {"op": "commit_at", "topic": topic, "group": group,
               "offsets": {str(k): int(v) for k, v in offsets.items()}}
        if partitions is not None:
            req["partitions"] = [int(p) for p in partitions]
        if fences:
            req["fences"] = [[str(k), int(e)] for k, e in fences]
        self._rpc(req)

    def seek_committed(self, topic: str, group: str,
                       partitions: Optional[List[int]] = None,
                       fences: Optional[List] = None) -> None:
        req = {"op": "seek_committed", "topic": topic, "group": group}
        if partitions is not None:
            # pinned seek (feeders/): rewind ONLY the named partitions —
            # a lease takeover must re-read its predecessor's uncommitted
            # tail without disturbing other live feeders' cursors
            req["partitions"] = [int(p) for p in partitions]
        if fences:
            req["fences"] = [[str(k), int(e)] for k, e in fences]
        self._rpc(req)

    def end_offsets(self, topic: str) -> List[int]:
        return self._rpc({"op": "end_offsets", "topic": topic})["offsets"]

    def topics(self) -> List[str]:
        return self._rpc({"op": "topics"})["topics"]

    def call(self, op: str, **fields) -> dict:
        """Invoke a registered subsystem op (BusServer.register_op) —
        same fencing stamp, tracing envelope, and reconnect/backoff
        policy as the built-in ops. Returns the full response dict."""
        return self._rpc(dict(fields, op=str(op)))

    def telemetry(self) -> dict:
        """Fetch the remote process's observability snapshot (cluster
        telemetry fan-in)."""
        return self._rpc({"op": "telemetry"})["telemetry"]

    def ping(self) -> bool:
        try:
            return bool(self._rpc({"op": "ping"})["ok"])
        except BusNetError:
            return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class RemoteConsumerHost:
    """ConsumerHost twin for edge processes: poll/commit over a BusClient.
    Handler exceptions leave offsets uncommitted server-side; the host
    re-seeks to committed so the batch redelivers (at-least-once) — with
    the same exponential-backoff retry budget and dead-letter parking as
    the in-proc ConsumerHost, so a poison batch can't spin an edge
    consumer forever."""

    def __init__(self, client: BusClient, topic_name: str, group_id: str,
                 handler: Callable[[List[Record]], None],
                 max_records: int = 4096, poll_timeout_s: float = 0.5,
                 max_retries: int = 12, max_backoff_s: float = 30.0,
                 dead_letter_topic: Optional[str] = None):
        self._client = client
        self._topic_name = topic_name
        self._group_id = group_id
        self._handler = handler
        self._max_records = max_records
        self._poll_timeout_s = poll_timeout_s
        self._max_retries = max_retries
        self._max_backoff_s = max_backoff_s
        self.dead_letter_topic = (dead_letter_topic
                                  or f"{topic_name}.dead-letter")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors = 0
        self.dead_lettered = 0
        # ((partition, offset) of the failing batch head, retries,
        # per-partition exclusive end offsets of the first failing batch)
        self._failing: Optional[tuple] = None
        # a successfully-handled batch's commit (its EXPLICIT per-partition
        # extent) piggybacks on the NEXT poll request — one round trip per
        # batch instead of two; flushed explicitly on stop and before
        # failure-path seeks
        self._pending_extent: Optional[dict] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"remote-consumer-{self._group_id}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._client.seek_committed(self._topic_name, self._group_id)
        except BusNetError:
            pass  # server unreachable at boot: first poll retries anyway
        while not self._stop.is_set():
            try:
                # retry cycles re-poll exactly the original failing batch's
                # per-partition extent (see ConsumerHost._run — records
                # arriving during backoff must not be parked with the
                # poison)
                until = self._failing[2] if self._failing else None
                batch = self._client.poll(self._topic_name, self._group_id,
                                          self._max_records,
                                          timeout_s=self._poll_timeout_s,
                                          until=until,
                                          commit_at=self._pending_extent)
                self._pending_extent = None
            except BusNetError:
                self.errors += 1
                # a failed poll may have advanced the server-side cursor
                # (lost response): rewind to committed before polling again
                try:
                    self._client.seek_committed(self._topic_name,
                                                self._group_id)
                except BusNetError:
                    pass
                time.sleep(jittered(0.3))  # desync reconnecting consumers
                continue
            if not batch:
                if self._failing:
                    # empty extent poll (partition reassigned by a
                    # rebalance, lost seek, retention): abandon the retry
                    # cycle instead of hot-spinning RPCs on it forever
                    self._failing = None
                    try:
                        self._client.seek_committed(self._topic_name,
                                                    self._group_id)
                    except BusNetError:
                        pass
                    self._stop.wait(0.2)
                continue
            try:
                self._handler(batch)
                self._pending_extent = batch_extent(batch)  # next poll commits
                self._failing = None
            except Exception:
                self.errors += 1
                # the PREVIOUS batch's deferred commit must land before any
                # seek_to_committed below, or its records would rejoin (and
                # eventually be dead-lettered with) the failing batch
                self._flush_pending_commit()
                fingerprint = (batch[0].partition, batch[0].offset)
                if self._failing and self._failing[0] == fingerprint:
                    retries = self._failing[1] + 1
                    extent = self._failing[2]
                else:
                    retries = 1
                    extent = batch_extent(batch)
                self._failing = (fingerprint, retries, extent)
                try:
                    if retries > self._max_retries:
                        self._client.publish_batch(
                            self.dead_letter_topic,
                            [(r.key, r.value) for r in batch])
                        self.dead_lettered += len(batch)
                        self._client.commit(self._topic_name, self._group_id)
                        self._failing = None
                    else:
                        self._client.seek_committed(self._topic_name,
                                                    self._group_id)
                        self._stop.wait(jittered(
                            min(0.05 * (2 ** (retries - 1)),
                                self._max_backoff_s)))
                except BusNetError:
                    pass

    def _flush_pending_commit(self, bounded: bool = False) -> None:
        if self._pending_extent is None:
            return
        old = (self._client.timeout_s, self._client.retries)
        if bounded:
            # shutdown must stay bounded: one short attempt, not the
            # client's full reconnect/retry budget (~minutes against a
            # hung server). An unflushed commit only costs redelivery.
            self._client.timeout_s, self._client.retries = 2.0, 0
        try:
            self._client.commit_at(self._topic_name, self._group_id,
                                   self._pending_extent)
            self._pending_extent = None
        except BusNetError:
            pass  # stays pending; redelivery is legal (at-least-once)
        finally:
            if bounded:
                self._client.timeout_s, self._client.retries = old

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        # flush the last handled batch's deferred commit (otherwise a
        # clean shutdown would redeliver it on the next start — legal
        # under at-least-once, but wasteful)
        self._flush_pending_commit(bounded=True)
