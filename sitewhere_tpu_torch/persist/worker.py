"""Asynchronous bulk persistence: columnar appends off the ingest thread.

Reference: service-event-management's DeviceEventBuffer
(mongodb/DeviceEventBuffer.java:99-123) — a bounded in-memory queue plus
writer threads so API calls never block on the datastore, with the queue
bound providing backpressure. The equivalent here moves the
columnar `append_batch` (persist/eventlog.py) onto a writer thread so the
ingest path (pipelined fused-step feeding) overlaps durable persistence
instead of serializing ahead of it — the last serialized host cost on the
bulk lane.

After each append the worker publishes a compact batch marker on the
`inbound-enriched-batches` topic (runtime/bus.py TopicNaming): the bulk
analog of the reference's enriched-events production
(OutboundPayloadEnrichmentLogic), carrying (tenant, rows, event-date span)
so consumers — analytics receivers, outbound fan-out — read the rows back
columnar from the log rather than receiving per-event envelopes.

Failure contract: an append that raises parks the batch's marker on the
`.dead-letter` surface of the marker topic with the error, and the worker
keeps running — persistence failures must never poison the ingest loop
(same isolation pipeline/inbound.py gives the fused step).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import msgpack
import numpy as np

from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

import logging

LOGGER = logging.getLogger("sitewhere.persist.worker")


class AsyncEventPersister(LifecycleComponent):
    """Bounded-queue writer thread for bulk EventBatch persistence.

    `submit(batch)` enqueues and returns immediately; when `depth` batches
    are already queued it blocks — natural backpressure, the ingest loop
    is paced by the datastore exactly when the datastore is the
    bottleneck (the reference blocks API threads on its full queue the
    same way). `flush()` waits until everything queued so far is durable
    in the columnar log and its marker published.
    """

    def __init__(self, eventlog, packer, tenant: str = "default",
                 bus: Optional[EventBus] = None,
                 naming: Optional[TopicNaming] = None,
                 registry=None, depth: int = 8,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"async-persister:{tenant}")
        self.eventlog = eventlog
        self.packer = packer
        self.tenant = tenant
        self.bus = bus
        self.naming = naming or TopicNaming()
        self.registry = registry
        m = (metrics or MetricsRegistry()).scoped("persist_worker")
        self.persisted_meter = m.meter("events")
        self.failed_counter = m.counter("failed")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = threading.Condition()
        self._submitted = 0
        self._completed = 0
        self._stop = threading.Event()
        # atomic submit-vs-stop gate (the PipelinedSubmitter pattern):
        # liveness check + enqueue happen under one lock, and stop flips
        # _stop under the same lock — no window where a submit can land
        # in a queue nothing will ever drain
        self._close_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name=f"persist-{self.tenant}",
                                        daemon=True)
        self._thread.start()

    def on_stop(self, monitor) -> None:
        self.flush()
        with self._close_lock:
            self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        # a submit that landed between flush() and the stop flag is still
        # queued with the writer gone: persist stragglers synchronously so
        # nothing is silently lost and no flush() waiter hangs
        while True:
            try:
                batch, tenant = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                self._persist_one(batch, tenant)
            finally:
                with self._done:
                    self._completed += 1
                    self._done.notify_all()

    # -- producer ----------------------------------------------------------
    def submit(self, batch, tenant: Optional[str] = None) -> None:
        """Queue one packed EventBatch for durable append (blocks when
        `depth` batches are pending — backpressure)."""
        item = (batch, tenant or self.tenant)
        while True:
            with self._close_lock:
                if self._stop.is_set() or self._thread is None:
                    raise RuntimeError("persister not running")
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    pass  # backpressure: retry outside the lock
                else:
                    with self._done:
                        self._submitted += 1
                    return
            time.sleep(0.005)

    def flush(self, timeout: Optional[float] = 60.0) -> None:
        """Block until every batch submitted so far is appended (or failed
        onto the dead-letter surface)."""
        with self._done:
            target = self._submitted
            if not self._done.wait_for(
                    lambda: self._completed >= target, timeout=timeout):
                raise TimeoutError("async persister did not drain in time")

    @property
    def pending(self) -> int:
        with self._done:
            return self._submitted - self._completed

    # -- writer ------------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                batch, tenant = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._persist_one(batch, tenant)
            finally:
                with self._done:
                    self._completed += 1
                    self._done.notify_all()

    def _persist_one(self, batch, tenant: str) -> None:
        marker_topic = self.naming.inbound_enriched_batches(tenant)
        try:
            valid = np.asarray(batch.valid)
            n = self.eventlog.append_batch(tenant, batch, self.packer,
                                           registry=self.registry)
            self.persisted_meter.mark(n)
            if self.bus is None or n == 0:
                return
            ts = np.asarray(batch.ts)[valid.astype(bool)]
            base = self.packer.epoch_base_ms
            marker = {"tenant": tenant, "n": int(n),
                      "ts_min": int(ts.min()) + base,
                      "ts_max": int(ts.max()) + base}
            self.bus.publish(marker_topic, tenant.encode(),
                             msgpack.packb(marker, use_bin_type=True))
        except Exception as exc:
            self.failed_counter.inc()
            LOGGER.exception("bulk persist failed for tenant '%s'", tenant)
            if self.bus is not None:
                self.bus.publish(
                    marker_topic + ".dead-letter", tenant.encode(),
                    msgpack.packb({"tenant": tenant, "error": str(exc)},
                                  use_bin_type=True))
