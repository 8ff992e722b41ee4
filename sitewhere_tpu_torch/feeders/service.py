"""Landing-host blob-ingest endpoint: the feeder fleet's landing zone.

Counterpart of `sitewhere_tpu/feeders/service.py`, for one engine or a
`ShardedPipelineEngine` (S shards in card blocks) on the port's cards.
Mounts the ``feeder_*`` op family on the serve process's BusServer
(runtime/busnet.py ``register_op``). With feeders attached, the landing
host's per-step work on this path is H2D-into-StagingRing + the captured
step — no decode, no interning, no pack; the flight records it opens carry
only ``h2d``/``dispatch`` (and ``stage_wait``/``guard`` backpressure)
segments. Blob handlers run on busnet's connection threads, one at a time
under ``_step_lock``, so the engine's first capture of a static
configuration may happen on one of them (the engine captures on its own
reserved stream, pipeline/graph.py ``capture_stream``).

Sharded landing: a feeder packs a sharded engine's blob in the device-
routing flat layout (`[rows, S*B]`, worker.py `_pack_blob`) and says
whether the host-route guard found that it fits every shard's lanes. A
blob that fits stages through the ring (the ordered grant, as one
engine's blobs take it) and dispatches as it is: the step routes it in
its prologue. One that does not is the counted spill
(`feeder.guard_spills`): unpacked to columns and submitted down the host
route, whose overflow the engine parks for its next step.

Exactly-once across takeover: every blob names the [start, end)
partition-offset extent it covers. The service keeps a per-partition
watermark (max applied end offset) that OUTLIVES any feeder; a blob
fully at-or-under the watermark is a replay — dropped, counted
(`feeder.replay_dropped`), its rows handed to the armed ReplayBarrier
as suppressed effects. Feeders commit offsets only after the ack, so
extents are blob-aligned: a replayed extent is either fully duplicate
or fully new. Two refinements close the partial cases:

* Chunked records (one record wider than a batch) dedupe per CHUNK: the
  highest applied (extent, chunk) of an in-progress record is kept
  alongside the watermark, so a replay after a mid-record shed/fence/
  kill suppresses the chunks that already stepped instead of
  double-applying them.
* An extent that STRADDLES the watermark (start < watermark < end — a
  regrouped replay after new records extended the greedy group
  boundary) is refused with a structured ``overlap`` verdict carrying
  the watermark; the feeder advances its commit to the watermark and
  re-polls, so the straddling blob's already-applied prefix is never
  stepped twice. Counted on `feeder.extent_overlap`.

The replay check runs lock-free as a fast path and AGAIN under the step
lock before stepping: blob handlers run on concurrent busnet threads,
so a zombie's in-flight duplicate that passed the first check while the
successor's replay held the lock is caught by the in-lock re-check
after the watermark advanced.

Zombie fencing: blob requests are stamped ``fence=feeder:p<N>`` and
epoch-checked by busnet dispatch BEFORE this service sees them; a
takeover raises the partition's floor so the dead feeder's in-flight
blobs bounce with ``stale_epoch`` instead of landing twice. Feeders
stamp the same per-partition fences on their consume-side ops (poll /
commit / seek), so a fenced zombie cannot move the shared server-side
cursor either.

Admission: the shed decision propagates to the SOURCE — a shedding
AdmissionController turns the blob ack into a structured 429 the
feeder's receiver counts and backs off on, instead of the blob landing
first and shedding after the transfer was already paid.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from sitewhere_tpu_torch.feeders import protocol
from sitewhere_tpu_torch.ops.pack import _VALID_SHIFT, blob_to_batch_np
from sitewhere_tpu_torch.runtime.eventage import (age_histogram, observe_summary,
                                            sidecar_from_wire)
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.runtime.recovery import GLOBAL_REPLAY_BARRIER, LeaseTable

# age-waterfall edge recorded when a feeder blob crosses onto the landing host
# host (cumulative age at the handoff; per-hop = difference against the
# downstream persist/alert edges)
FEEDER_EDGE = "feeder_to_mesh"


class FeederService:
    """Serve-process side of the feeder fleet: lease authority, interner
    journal authority, and the blob-ingest endpoint feeding the engine's
    staging ring directly."""

    def __init__(self, engine, server, frames_topic: str,
                 lease_ttl_s: float = 5.0, tenant: str = "default",
                 admission=None, metrics=GLOBAL_METRICS,
                 replay_barrier=GLOBAL_REPLAY_BARRIER,
                 on_outputs: Optional[Callable] = None):
        self.engine = engine
        self.server = server
        self.frames_topic = frames_topic
        self.lease_ttl_s = float(lease_ttl_s)
        self.tenant = tenant
        self.admission = admission
        self.replay_barrier = replay_barrier
        self.on_outputs = on_outputs
        self.leases = LeaseTable(metrics=metrics)
        self._metrics = metrics
        self._blob_counter = metrics.counter("feeder.blobs")
        self._events_meter = metrics.meter("feeder.events")
        self._shed_counter = metrics.counter("feeder.shed")
        self._replay_counter = metrics.counter("feeder.replay_dropped")
        self._overlap_counter = metrics.counter("feeder.extent_overlap")
        self._spill_counter = metrics.counter("feeder.guard_spills")
        self._takeover_counter = metrics.counter("takeover.count")
        self._age_hist = age_histogram(metrics)
        # per-partition exclusive end offset of applied extents — the
        # exactly-once watermark; survives any feeder's death
        self._watermarks: dict = {}
        # per-partition (extent_end, max applied chunk) of the ONE
        # in-progress chunked record, cleared when its final chunk
        # advances the watermark — the sub-extent half of exactly-once
        self._partials: dict = {}
        # blob staging order + the engine step are serialized: the step
        # is not concurrent-safe, and a single arrival order keeps the
        # staging ring's ordered grant meaningful across feeders
        self._step_lock = threading.Lock()
        self._order = 0
        # receiver-side accounting (read by bench/perf_gate): wall spent
        # handling blobs, the engine-step part of it, and actual thread
        # CPU (thread_time stops during lock waits and device blocks) —
        # handoff overhead per blob = (handle - step) / blobs
        self.blob_handle_s = 0.0
        self.blob_step_s = 0.0
        self.blob_cpu_s = 0.0
        from sitewhere_tpu_torch.parallel.engine import \
            ShardedPipelineEngine
        from sitewhere_tpu_torch.pipeline.engine import PipelineEngine
        if not isinstance(engine, PipelineEngine):
            raise TypeError(f"feeders land on the port's PipelineEngine or "
                            f"ShardedPipelineEngine, not a "
                            f"{type(engine).__name__}")
        self._sharded = isinstance(engine, ShardedPipelineEngine)
        for op, fn in ((protocol.OP_HELLO, self._op_hello),
                       (protocol.OP_LEASE, self._op_lease),
                       (protocol.OP_JOURNAL, self._op_journal),
                       (protocol.OP_INTERN, self._op_intern),
                       (protocol.OP_BLOB, self._op_blob)):
            server.register_op(op, fn)

    # -- op: hello ----------------------------------------------------------

    def _op_hello(self, req: dict) -> dict:
        """The packing contract a feeder needs for a bit-identical remote
        pack, plus fleet wiring (topic, group, lease TTL)."""
        engine = self.engine
        packer = engine.packer
        n_parts = len(self.server.bus.topic(self.frames_topic).partitions)
        resp = {
            "ok": True,
            "engine": "sharded" if self._sharded else "single",
            "batch_size": packer.batch_size,
            "epoch_base_ms": packer.epoch_base_ms,
            "dev_capacity": packer.devices.capacity,
            "dev_shard_classes": packer.devices.shard_classes,
            "mm_capacity": packer.measurements.capacity,
            "at_capacity": packer.alert_types.capacity,
            "topic": self.frames_topic,
            "group": protocol.FEEDER_GROUP,
            "partitions": n_parts,
            "lease_ttl_s": self.lease_ttl_s,
            "shedding": bool(self.admission is not None
                             and getattr(self.admission, "_shedding",
                                         False)),
        }
        if self._sharded:
            resp.update(
                n_shards=engine.n_shards,
                per_shard_batch=engine.batch_size,
                device_routing=bool(engine.device_routing),
                route_lane_capacity=int(engine.route_lane_capacity),
                fixed_wire_rows=int(getattr(engine.router,
                                            "fixed_wire_rows", 0) or 0))
        return resp

    # -- op: lease ----------------------------------------------------------

    def _op_lease(self, req: dict) -> dict:
        action = req.get("action")
        partition = int(req["partition"])
        owner = str(req["owner"])
        epoch = int(req.get("epoch", 0))
        resource = protocol.partition_resource(partition)
        if action == "acquire":
            previous = self.leases.holder(resource)
            ttl = float(req.get("ttl_s", self.lease_ttl_s))
            granted = self.leases.acquire(resource, owner, epoch, ttl)
            if granted and previous is not None and previous != owner:
                # a live lease changed hands — only possible via the
                # strictly-higher-epoch steal: this is a takeover
                self._takeover_counter.inc()
            if granted:
                # the new owner's epoch fences the old one: raise the
                # partition floor so the previous incarnation's in-flight
                # blobs are rejected (same decision as the steal)
                self.server.fence.fence(
                    protocol.feeder_fence_key(partition), epoch)
            return {"ok": True, "granted": bool(granted),
                    "ttl_s": ttl, "holder": self.leases.holder(resource),
                    "took_over": bool(granted and previous is not None
                                      and previous != owner)}
        if action == "renew":
            renewed = self.leases.renew(resource, owner, epoch)
            return {"ok": True, "renewed": bool(renewed)}
        if action == "release":
            return {"ok": True,
                    "released": bool(self.leases.release(resource, owner))}
        return {"ok": False, "error": f"unknown lease action {action!r}"}

    # -- ops: interner journal ----------------------------------------------

    def _journal_interner(self, name: str):
        packer = self.engine.packer
        table = {"devices": packer.devices,
                 "measurements": packer.measurements,
                 "alert_types": packer.alert_types}
        return table.get(name)

    def _op_journal(self, req: dict) -> dict:
        interner = self._journal_interner(str(req.get("interner")))
        if interner is None:
            return {"ok": False,
                    "error": f"unknown interner {req.get('interner')!r}"}
        since = int(req.get("since", 0))
        epoch, entries = interner.journal_since(since)
        return {"ok": True, "journal_epoch": epoch, "base": since,
                "entries": [[i, t] for i, t in entries]}

    def _op_intern(self, req: dict) -> dict:
        """Authoritative allocation for NEW meta tokens a feeder saw
        mid-stream. Devices are refused — ingest never allocates device
        tokens on either side (unknown must stay 0)."""
        name = str(req.get("interner"))
        if name == "devices":
            return {"ok": False,
                    "error": "devices are lookup-only for ingest"}
        interner = self._journal_interner(name)
        if interner is None:
            return {"ok": False, "error": f"unknown interner {name!r}"}
        since = int(req.get("since", 0))
        for token in req.get("tokens", []):
            interner.intern(str(token))
        epoch, entries = interner.journal_since(since)
        return {"ok": True, "journal_epoch": epoch, "base": since,
                "entries": [[i, t] for i, t in entries]}

    # -- op: blob -----------------------------------------------------------

    def _extent_disposition(self, partition: int, start: int, end: int,
                            chunk: int):
        """'dup' (fully applied — drop and suppress), 'overlap' (the
        extent straddles the watermark — the shipper must re-group from
        it), or None (fresh). Consulted lock-free as a fast path and
        AGAIN under ``_step_lock`` before stepping; only the in-lock
        answer is authoritative."""
        wm = self._watermarks.get(partition, -1)
        if end <= wm:
            return "dup"
        if start < wm:
            return "overlap"
        partial = self._partials.get(partition)
        if partial is not None and partial[0] == end and chunk <= partial[1]:
            return "dup"
        return None

    def _dup_reply(self, n_events: int) -> dict:
        self._replay_counter.inc()
        suppressed = self.replay_barrier.take(self.tenant, n_events) \
            if self.replay_barrier is not None else 0
        # report what the barrier actually suppressed — 0 when disarmed
        # (no durable rows to protect), never a fabricated n_events
        return {"ok": True, "dup": True, "events": 0,
                "suppressed": int(suppressed)}

    def _overlap_reply(self, partition: int) -> dict:
        self._overlap_counter.inc()
        return {"ok": True, "overlap": True, "events": 0,
                "watermark": int(self._watermarks.get(partition, -1))}

    def _op_blob(self, req: dict) -> dict:
        partition = int(req["partition"])
        start, end = (int(x) for x in req["extent"])
        n_events = int(req["n_events"])
        chunk = int(req.get("chunk", 0))
        # 1. replay watermark FIRST: a duplicate is dropped for free —
        # were shedding checked first, an overloaded landing host would
        # 429 takeover replays and the feeder would re-ship the same
        # already-applied extents forever instead of converging
        verdict = self._extent_disposition(partition, start, end, chunk)
        if verdict == "dup":
            return self._dup_reply(n_events)
        if verdict == "overlap":
            return self._overlap_reply(partition)
        # 2. front-door shedding: an overloaded landing host refuses fresh
        # work before doing anything with the payload
        admit = getattr(self.admission, "admit_remote", None) \
            or getattr(self.admission, "admit", None)
        if admit is not None and not admit():
            self._shed_counter.inc()
            # transport-level ok (the socket and request were fine), app-
            # level structured 429: the feeder's receiver branches on
            # `shed`, backs off, and does NOT commit the extent
            return {"ok": True, "shed": True, "http_status": 429,
                    "events": 0}
        t0 = time.perf_counter()
        c0 = time.thread_time()
        blob = protocol.decode_blob(req)
        age = sidecar_from_wire(req.get("age") or [])
        # cumulative age at the feeder->mesh handoff (per-hop p50/p99 =
        # this edge minus the feeder's ingest edge downstream dashboards
        # already chart)
        observe_summary(self._age_hist, age.close(),
                        engine=self.engine.name, edge=FEEDER_EDGE)
        with self._step_lock:
            # 3. authoritative re-check: blob handlers run on concurrent
            # busnet threads, so a duplicate that passed the fast path
            # while another handler (the successor's replay of the same
            # extent) held this lock must be caught here, AFTER that
            # handler advanced the watermark — or it would step twice
            verdict = self._extent_disposition(partition, start, end,
                                               chunk)
            if verdict == "dup":
                return self._dup_reply(n_events)
            if verdict == "overlap":
                return self._overlap_reply(partition)
            order = self._order
            self._order += 1
            s0 = time.perf_counter()
            if self._sharded:
                events = self._step_sharded(blob, req, age, order)
            else:
                events = self._step_single(blob, n_events, age, order)
            s1 = time.perf_counter()
            if req.get("advance", True):
                # compute from the fresh in-lock value — never from a
                # pre-lock read, which could regress the watermark and
                # re-admit replays a concurrent handler already applied
                wm = max(self._watermarks.get(partition, -1), end)
                self._watermarks[partition] = wm
                partial = self._partials.get(partition)
                if partial is not None and partial[0] <= wm:
                    del self._partials[partition]
            else:
                # non-final chunk: remember the sub-extent so a replay
                # of this in-progress record dedupes its applied chunks
                partial = self._partials.get(partition)
                prev = partial[1] if partial is not None \
                    and partial[0] == end else -1
                self._partials[partition] = (end, max(prev, chunk))
            self.blob_step_s += s1 - s0
            self.blob_handle_s += s1 - t0
            self.blob_cpu_s += time.thread_time() - c0
        self._blob_counter.inc()
        self._events_meter.mark(events)
        return {"ok": True, "events": int(events), "seq": int(req["seq"])}

    def _step_single(self, blob: np.ndarray, n_events: int, age,
                     order: int) -> int:
        engine = self.engine
        rec = engine.flight.begin_step(engine=engine.name)
        rec.age = age
        staged = engine.stage_blob(np.ascontiguousarray(blob),
                                   flight_rec=rec, order=order)
        outputs = engine.submit_blob(staged, n_events=n_events,
                                     flight_rec=rec)
        if self.on_outputs is not None:
            self.on_outputs(engine, outputs, rec)
        return n_events

    def _step_sharded(self, blob: np.ndarray, req: dict, age,
                      order: int) -> int:
        """Sharded landing: the feeder's guard verdict picks the path.
        Fits -> the blob IS the device-routing flat layout; stage it
        through the ring and dispatch (no per-event host work). Does not
        fit (skew past a lane's capacity) -> the counted spill: unpack to
        columns and take the host-arena route through submit()."""
        from sitewhere_tpu_torch.parallel.engine import _PreparedStep

        engine = self.engine
        fits = bool(req.get("fits_device_route", True)) \
            and engine.device_routing
        if not fits:
            self._spill_counter.inc()
            batch = blob_to_batch_np(np.ascontiguousarray(blob))
            n = int(np.asarray(batch.valid).sum())
            engine.submit(batch, age=age)
            return n
        rec = engine.flight.begin_step(engine=engine.name)
        rec.age = age
        prepared = _PreparedStep("device", np.ascontiguousarray(blob),
                                 flight=rec)
        staged = engine.stage_prepared(prepared, order=order)
        _, outputs = engine.dispatch_staged(staged)
        if self.on_outputs is not None:
            self.on_outputs(engine, outputs, rec)
        return int(((blob[0, :] >> _VALID_SHIFT) & 1).sum())

    # -- introspection ------------------------------------------------------

    def watermark(self, partition: int) -> int:
        return int(self._watermarks.get(int(partition), -1))
