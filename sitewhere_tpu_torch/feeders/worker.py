"""Feeder worker: lease-owned partitions -> ready-to-stage wire blobs.

Counterpart of `sitewhere_tpu/feeders/worker.py`. For one engine it
packs that engine's wire layout; for a sharded engine the device-routing
flat layout (`[rows, S*B]`, padded to the global batch), with the
host-route guard's verdict on whether every shard's lanes hold it. The
worker does no device work: it decodes, interns and packs on the host and
never touches CUDA.

One worker (thread in-proc, process under ``serve --feeder``) owns a set
of TTL-leased source partitions and runs the whole per-event pipeline
locally — decode, interner-replica token resolution, pack, host-route
guard — then ships
each blob to the landing host's ``feeder_blob`` endpoint
and commits the covered offsets ONLY after the ack. The commit-after-ack
order is the exactly-once half the landing-side watermark needs: a worker
that dies mid-blob leaves its offsets uncommitted, the successor (fenced
at a strictly higher epoch) replays the extent, and the watermark drops
what already stepped.

Blob grouping is record-ALIGNED (protocol.count_hot_events header walk):
an offset commit can never split a bus record, so replayed extents are
whole blobs. The `feeder_process_death` fault point fires mid-blob —
between ship and commit — and kills the worker the hard way (os._exit
under ``serve --feeder``; an abandoned thread in the in-proc drill), the
exact window where exactly-once is hardest.

A structured 429 from the landing host (AdmissionController shed propagated
over busnet) is counted at THIS receiver (`feeder.shed_received`) and
backs the partition off without committing — the events redeliver when
admission reopens, instead of being dropped after the transfer was paid.

Every consume-side op (poll / commit_at / seek_committed) is stamped
with the per-partition lease fences, so a fenced-out zombie cannot move
the shared server-side cursor — records it would silently skip past
could otherwise never redeliver to the successor. And ANY failure mid-
cycle — shed, fence, or a raw transport error — takes the same exit:
commit what was acked, rewind the partition to committed so the polled-
but-unshipped records redeliver.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.feeders import protocol
from sitewhere_tpu_torch.feeders.replica import ReplicaPacker
from sitewhere_tpu_torch.ops.pack import batch_to_blob, wire_variant_for
from sitewhere_tpu_torch.ops.route import host_fits_device_route
from sitewhere_tpu_torch.parallel.router import routable_variant
from sitewhere_tpu_torch.runtime.busnet import BusClient, StaleEpochBusError
from sitewhere_tpu_torch.runtime.eventage import AgeSidecar
from sitewhere_tpu_torch.runtime.faults import FaultError, fault_point
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS


class FeederWorker:
    """One feeder: hello -> lease -> (sync, poll, pack, ship, commit)*.

    ``epoch`` is the worker's fencing epoch (runtime/recovery.py
    mint_epoch in ``serve --feeder``; explicit in drills). A successor
    taking over a dead worker's partitions MUST run at a strictly higher
    epoch — the lease steal and the fence raise are one decision
    (feeders/service.py)."""

    def __init__(self, host: str, port: int, name: str, epoch: int,
                 partitions: Optional[Sequence[int]] = None,
                 poll_max_records: int = 4096,
                 poll_timeout_s: float = 0.25,
                 shed_backoff_s: float = 0.25,
                 hard_exit: bool = False,
                 metrics=GLOBAL_METRICS):
        self.name = str(name)
        self.epoch = int(epoch)
        self.client = BusClient(host, port)
        self.configured_partitions = (list(partitions)
                                      if partitions is not None else None)
        self.poll_max_records = int(poll_max_records)
        self.poll_timeout_s = float(poll_timeout_s)
        self.shed_backoff_s = float(shed_backoff_s)
        # serve --feeder: an injected process death must not unwind
        # through handlers that could commit — leave no trace, like
        # SIGKILL would
        self.hard_exit = bool(hard_exit)
        self._metrics = metrics
        self._blob_counter = metrics.counter("feeder.blobs_shipped")
        self._shed_counter = metrics.counter("feeder.shed_received")
        self._error_counter = metrics.counter("feeder.cycle_errors")
        self._fenced_counter = metrics.counter("feeder.fenced")
        self._takeover_counter = metrics.counter("feeder.takeovers")
        self.hello: Optional[dict] = None
        self.replica: Optional[ReplicaPacker] = None
        self.owned: Dict[int, float] = {}   # partition -> last renew ts
        self.seq = 0
        self.events_shipped = 0
        self.blobs_shipped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False

    # -- lifecycle ----------------------------------------------------------

    def connect(self) -> dict:
        """Hello handshake + replica bootstrap (idempotent)."""
        if self.hello is None:
            self.hello = self.client.call(protocol.OP_HELLO)
            self.replica = ReplicaPacker(self.hello, self.client,
                                         metrics=self._metrics)
            self.replica.sync()
        return self.hello

    def acquire_leases(self) -> List[int]:
        """Try to lease every configured partition (all partitions when
        none were configured). Grants out of another owner's lapsed or
        fenced lease count as takeovers."""
        hello = self.connect()
        wanted = (self.configured_partitions
                  if self.configured_partitions is not None
                  else list(range(int(hello["partitions"]))))
        now = time.monotonic()
        fresh: List[int] = []
        for p in wanted:
            if p in self.owned:
                continue
            resp = self.client.call(
                protocol.OP_LEASE,
                **protocol.lease_request("acquire", p, self.name,
                                         self.epoch,
                                         hello["lease_ttl_s"]))
            if resp.get("granted"):
                self.owned[p] = now
                fresh.append(p)
                if resp.get("took_over"):
                    self._takeover_counter.inc()
        if fresh:
            # a takeover inherits its predecessor's polled-but-uncommitted
            # tail: rewind exactly the granted partitions to their last
            # COMMITTED offsets so those records redeliver (the landing host
            # watermark drops whatever was already applied)
            self.client.seek_committed(
                hello["topic"], hello["group"], partitions=fresh,
                fences=protocol.consume_fences(fresh, self.epoch))
        return sorted(self.owned)

    def release_leases(self) -> None:
        for p in list(self.owned):
            try:
                self.client.call(
                    protocol.OP_LEASE,
                    **protocol.lease_request("release", p, self.name,
                                             self.epoch))
            except Exception:
                pass
            self.owned.pop(p, None)

    def _renew_leases(self) -> None:
        hello = self.hello or {}
        ttl = float(hello.get("lease_ttl_s", 5.0))
        now = time.monotonic()
        for p, last in list(self.owned.items()):
            if now - last < ttl / 3.0:
                continue
            resp = self.client.call(
                protocol.OP_LEASE,
                **protocol.lease_request("renew", p, self.name, self.epoch))
            if resp.get("renewed"):
                self.owned[p] = now
            else:
                # lost the lease (lapsed + stolen): the partition is no
                # longer ours — its uncommitted tail replays on the owner
                self.owned.pop(p, None)

    # -- one ship cycle -----------------------------------------------------

    def run_once(self, timeout_s: Optional[float] = None) -> int:
        """One sync -> poll -> pack -> ship -> commit cycle over the
        owned partitions. Returns events shipped (0 on an idle poll)."""
        if self._dead:
            return 0
        self.connect()
        if not self.owned:
            self.acquire_leases()
            if not self.owned:
                return 0
        self._renew_leases()
        if not self.owned:
            return 0
        self.replica.sync()
        parts = sorted(self.owned)
        try:
            records = self.client.poll(
                self.hello["topic"], self.hello["group"],
                max_records=self.poll_max_records,
                timeout_s=self.poll_timeout_s if timeout_s is None
                else timeout_s,
                partitions=parts,
                fences=protocol.consume_fences(parts, self.epoch))
        except StaleEpochBusError as exc:
            # consume-side fencing: a successor's takeover raised a
            # partition's floor past our epoch — the rejected poll moved
            # NO cursor, so nothing was skipped. Drop the named
            # partition; the next cycle polls the survivors.
            self._fenced_counter.inc()
            stale = protocol.fence_key_partition(exc.resource)
            if stale is not None:
                self.owned.pop(stale, None)
            else:
                self.owned.clear()
            return 0
        if not records:
            return 0
        shipped = 0
        by_part: Dict[int, List] = {}
        for rec in records:
            by_part.setdefault(rec.partition, []).append(rec)
        for p, recs in sorted(by_part.items()):
            if self._dead:
                break
            if p not in self.owned:
                continue
            shipped += self._ship_partition(p, recs)
        return shipped

    def _ship_partition(self, partition: int, records: List) -> int:
        """Pack one partition's polled records into record-aligned blobs
        and ship them; commit after the last ack. ANY exit before the
        commit — shed, fence, or a raw transport error unwinding out of
        a ship — leaves the unacked tail uncommitted AND rewinds the
        partition to committed, so the polled-but-unshipped records
        redeliver instead of sitting forever past the server-side
        cursor. At-least-once upstream, deduplicated downstream by the
        landing watermark."""
        B = int(self.hello["batch_size"])
        # record-aligned groups: greedily accumulate whole records up to
        # the batch width so an offset commit never splits a record
        groups: List[List] = []
        group: List = []
        group_events = 0
        for rec in records:
            n = protocol.count_hot_events(rec.value)
            if group and group_events + n > B:
                groups.append(group)
                group, group_events = [], 0
            group.append(rec)
            group_events += n
        if group:
            groups.append(group)
        shipped = 0
        committed_through: Optional[int] = None
        rewind = False
        try:
            for group in groups:
                age = AgeSidecar()
                data = b"".join(rec.value for rec in group)
                batches, n_events, _rest = self.replica.pack_bytes(data)
                age.add(None, n_events)
                extent = (group[0].offset, group[-1].offset + 1)
                ok, skip_to = self._ship_blobs(partition, batches,
                                               n_events, extent, age)
                if self._dead:
                    # injected death: commit NOTHING — acked-but-
                    # uncommitted extents must replay through the
                    # successor, exactly like a SIGKILL before the
                    # commit_at went out (the finally below skips too)
                    return shipped
                if skip_to is not None:
                    # mesh overlap verdict: everything below the
                    # watermark IS applied — advance the commit to it so
                    # the rewound re-poll regroups from exactly the
                    # first unapplied record
                    committed_through = max(committed_through
                                            if committed_through is not None
                                            else -1, skip_to)
                if not ok:
                    rewind = True
                    break  # shed/fenced/overlap: nothing past this point
                shipped += n_events
                committed_through = extent[1]
        except Exception:
            # a transport (or any other) failure mid-ship takes the SAME
            # exit as shed/fenced — without the rewind, the polled-but-
            # unshipped records sit past the server-side cursor, later
            # extents advance the landing watermark over them, and their
            # eventual redelivery is dropped as a false replay (loss)
            rewind = True
            raise
        finally:
            if not self._dead and partition in self.owned:
                self._commit_and_rewind(partition, committed_through,
                                        rewind)
        return shipped

    def _commit_and_rewind(self, partition: int,
                           committed_through: Optional[int],
                           rewind: bool) -> None:
        """Best-effort cycle exit: commit the acked extents, then rewind
        to committed when the cycle stopped early. Both ops are fenced —
        a takeover between ship and commit bounces them (the successor
        replays; the watermark dedupes) — and both may fail on a dead
        transport, which only costs redelivery (at-least-once)."""
        fences = protocol.consume_fences([partition], self.epoch)
        try:
            if committed_through is not None:
                self.client.commit_at(
                    self.hello["topic"], self.hello["group"],
                    {partition: committed_through},
                    partitions=[partition], fences=fences)
            if rewind:
                self.client.seek_committed(self.hello["topic"],
                                           self.hello["group"],
                                           partitions=[partition],
                                           fences=fences)
        except StaleEpochBusError:
            self._fenced_counter.inc()
            self.owned.pop(partition, None)
        except Exception:
            pass

    def _ship_blobs(self, partition: int, batches, n_events: int,
                    extent, age: AgeSidecar):
        """Pack each batch into its wire blob and ship. A single record
        group normally yields one batch; an oversized record chunks into
        several — each stamped with its chunk index, only the last
        advancing the landing watermark (see protocol.blob_message).
        Returns ``(ok, skip_to)``: ok False stops the cycle before any
        commit past this group; skip_to (the watermark from an overlap
        verdict) tells the caller to advance the partition's commit to
        it before rewinding."""
        sharded = self.hello.get("engine") == "sharded"
        for i, batch in enumerate(batches):
            final = i == len(batches) - 1
            blob, fits = self._pack_blob(batch, sharded)
            n = int(np.asarray(batch.valid).sum())
            self.seq += 1
            try:
                resp = self.client.call(protocol.OP_BLOB, **protocol.blob_message(
                    blob, n_events=n, partition=partition, seq=self.seq,
                    extent=extent, epoch=self.epoch,
                    fits_device_route=fits, age=age, advance=final,
                    chunk=i))
            except StaleEpochBusError:
                # fenced: a successor took this partition over — drop the
                # lease and never commit (our rows land via its replay)
                self._fenced_counter.inc()
                self.owned.pop(partition, None)
                return False, None
            if resp.get("shed"):
                # the propagated AdmissionController 429: counted here at
                # the receiver, partition backs off uncommitted
                self._shed_counter.inc()
                time.sleep(self.shed_backoff_s)
                return False, None
            if resp.get("overlap"):
                # the extent straddles the landing watermark (a regrouped
                # replay after new records widened the greedy group):
                # its applied prefix must NOT step again — skip the
                # commit to the watermark and re-poll from there
                return False, int(resp["watermark"])
            # the kill drill's window: the blob is ACKED (applied on the
            # landing host) but the offsets behind it are not yet committed —
            # the successor replays this extent and exactly-once must
            # come from the watermark, not from us
            try:
                fault_point("feeder_process_death")
            except FaultError:
                self._die()
                return False, None
            self._blob_counter.inc()
            self.blobs_shipped += 1
            self.events_shipped += n
        return True, None

    def _pack_blob(self, batch, sharded: bool):
        """Batch -> the wire layout the engine would have packed inline,
        plus the host-route guard's verdict (sharded only)."""
        if not sharded:
            return batch_to_blob(batch), True
        S = int(self.hello["n_shards"])
        per_shard = int(self.hello["per_shard_batch"])
        G = S * per_shard
        fits = True
        if self.hello.get("device_routing"):
            fits = bool(host_fits_device_route(
                np.asarray(batch.device_idx), np.asarray(batch.valid), S,
                per_shard, int(self.hello["route_lane_capacity"])))
        rows, _ = routable_variant(*wire_variant_for(batch), per_shard)
        fixed = int(self.hello.get("fixed_wire_rows") or 0)
        if fixed:
            rows = fixed
        small = batch_to_blob(batch, wire_rows=rows)
        n = batch.device_idx.shape[0]
        if n == G:
            return small, fits
        buf = np.zeros((small.shape[0], G), np.int32)
        buf[:, :n] = small
        return buf, fits

    def _die(self) -> None:
        """The injected process death: no commits, no lease release, no
        cleanup — indistinguishable from SIGKILL to everyone else."""
        self._dead = True
        self._stop.set()
        if self.hard_exit:
            os._exit(9)

    @property
    def dead(self) -> bool:
        return self._dead

    # -- background thread --------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name=f"feeder-{self.name}",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self.run_once() == 0:
                    # idle poll already long-polled server-side
                    continue
            except FaultError:
                self._die()
                return
            except Exception:
                if self._stop.is_set() or self._dead:
                    return
                # safe to swallow-and-retry ONLY because _ship_partition
                # already rewound the partition to committed on its way
                # out — the failed cycle's records redeliver; counted so
                # a flapping transport is visible, not silent
                self._error_counter.inc()
                time.sleep(0.2)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if not self._dead:
            self.release_leases()
        self.client.close()
