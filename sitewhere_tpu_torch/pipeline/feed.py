"""Pipelined host->device feeding: overlap staging with device compute.

Counterpart of `sitewhere_tpu/pipeline/feed.py` (`StepFuture`,
`_PrePackedBlob`, `PipelinedSubmitter`, `AdaptiveBatcher`; single device —
the sharded submitter waits for the sharded slice):

  stager thread(s):  pack batch N+1 into a pinned staging buffer and start
                     its H2D copy on the engine's side stream (through the
                     staging ring, pipeline/staging.py)
  step thread:       dispatch the step for batch N in submission order

Throughput becomes max(host staging, device step) instead of their sum.
Steps are dispatched strictly in submission order (sequence numbers; the
step thread waits for the next sequence), so per-device event order is
preserved even though stagers pack concurrently.
"""

from __future__ import annotations

import heapq
import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np

from sitewhere_tpu_torch.ops.pack import EventBatch, batch_to_blob
from sitewhere_tpu_torch.pipeline.engine import record_event
from sitewhere_tpu_torch.runtime.eventage import AgeSidecar
from sitewhere_tpu_torch.runtime.faults import FaultError, fault_point


def _stage_window(depth: int, engine) -> int:
    """How far ahead of the dispatch cursor a stager may run (allowed:
    seq - next_step <= window). Bounded by the engine's staging-ring depth:
    with window <= ring_depth - 1, the slots held by sequences LATER than
    the earliest unstaged one can never fill the ring, so the ordered ring
    grant always reaches it. Ring depth 1 degenerates to window 0: stage
    strictly in dispatch order."""
    ring_depth = int(getattr(engine, "h2d_buffer_depth", depth))
    return min(max(1, depth), max(0, ring_depth - 1))


class StepFuture:
    """Result handle for one pipelined submit."""

    __slots__ = ("_event", "_outputs", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._outputs = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The step's ProcessOutputs (dispatched, not necessarily done on
        the card)."""
        if not self._event.wait(timeout):
            raise TimeoutError("step not dispatched within timeout")
        if self._error is not None:
            raise self._error
        return self._outputs

    def _resolve(self, outputs=None, error: Optional[BaseException] = None):
        self._outputs = outputs
        self._error = error
        self._event.set()


class _PrePackedBlob:
    """A host wire blob that arrived already packed: the stager skips the
    pack stage and goes straight to the staging-ring grant + H2D."""

    __slots__ = ("blob", "n_events")

    def __init__(self, blob: np.ndarray, n_events: int):
        self.blob = blob
        self.n_events = int(n_events)


class PipelinedSubmitter:
    """Stage-ahead feeder for a PipelineEngine.

    `submit(batch)` enqueues and returns a StepFuture immediately (blocking
    only when `depth` batches are already queued — natural backpressure).
    `stagers` host threads pack + copy ahead; one step thread dispatches in
    order. Call `flush()` to drain, `close()` to stop the threads.
    """

    def __init__(self, engine, depth: int = 3, stagers: int = 2):
        self.engine = engine
        self.depth = max(1, depth)
        self._in: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._ready_lock = threading.Condition()
        self._ready: List = []          # heap of (seq, blob, n, fut, rec, exc)
        self._next_seq = 0              # next sequence to assign
        self._next_step = 0             # next sequence to dispatch
        self._dispatched = 0            # steps whose dispatch has RETURNED
        self._stage_window = _stage_window(self.depth, engine)
        self._stop = threading.Event()
        self._close_lock = threading.Lock()  # atomic submit-vs-close gate
        self._stagers = [
            threading.Thread(target=self._stage_loop, name=f"feed-stage-{i}",
                             daemon=True)
            for i in range(max(1, stagers))]
        self._step_thread = threading.Thread(target=self._step_loop,
                                             name="feed-step", daemon=True)
        for t in self._stagers:
            t.start()
        self._step_thread.start()

    # -- producer ----------------------------------------------------------
    def submit(self, batch: EventBatch, age=None) -> StepFuture:
        fut = StepFuture()
        item = (self._alloc_seq(), batch, fut, age)
        # the closure check and the enqueue are atomic under _close_lock:
        # once close() proceeds to drain, no producer can slip an item into
        # the unattended queue; full queues back off outside the lock
        while True:
            with self._close_lock:
                if self._stop.is_set():
                    raise RuntimeError("submitter closed")
                try:
                    self._in.put_nowait(item)
                    return fut
                except queue.Full:
                    pass
            time.sleep(0.005)

    def _alloc_seq(self) -> int:
        with self._ready_lock:
            seq = self._next_seq
            self._next_seq += 1
            return seq

    def submit_blob(self, blob: np.ndarray, n_events: int,
                    age=None) -> StepFuture:
        """Enqueue a PRE-PACKED host wire blob: the same ordered
        stage->dispatch path as submit(), minus the pack stage."""
        return self.submit(_PrePackedBlob(blob, n_events), age=age)

    # -- stager ------------------------------------------------------------
    def _stage_loop(self) -> None:
        while not self._stop.is_set():
            try:
                seq, batch, fut, age = self._in.get(timeout=0.1)
            except queue.Empty:
                continue
            # bound the staged-ahead window (at most h2d_buffer_depth - 1
            # ahead, so the ordered ring grant always reaches the earliest
            # unstaged sequence, and a pinned staging buffer is never
            # repacked while its copy is in flight)
            with self._ready_lock:
                while (not self._stop.is_set()
                       and seq - self._next_step > self._stage_window):
                    self._ready_lock.wait(timeout=0.1)
            if self._stop.is_set():
                fut._resolve(error=RuntimeError("submitter closed"))
                continue
            try:
                fault_point("feeder_thread_death")
                # the flight record is opened HERE and handed to the step
                # thread inside the heap item: pack/guard/h2d land on this
                # thread, dispatch on the step thread, one clock for both
                rec = self.engine.flight.begin_step(engine=self.engine.name)
                if age is not None:
                    rec.age = age
                if isinstance(batch, _PrePackedBlob):
                    blob = np.ascontiguousarray(batch.blob)
                    n = batch.n_events
                else:
                    buf = self.engine._staging_blob_buffer(batch,
                                                           flight_rec=rec)
                    rec.begin_stage("pack")
                    blob = batch_to_blob(batch, out=buf)
                    rec.end_stage("pack")
                    n = int(np.asarray(batch.valid).sum())
                # a ring slot granted in seq order, then the async copy;
                # submit_blob releases the slot after dispatch
                dev_blob = self.engine.stage_blob(blob, flight_rec=rec,
                                                  order=seq)
                item = (seq, dev_blob, n, fut, rec, None)
            except BaseException as exc:  # surface through the future
                item = (seq, None, 0, fut, None, exc)
            with self._ready_lock:
                heapq.heappush(self._ready, item)
                self._ready_lock.notify_all()
            exc = item[5]
            if (isinstance(exc, FaultError)
                    and exc.point == "feeder_thread_death"):
                # drill: the batch's error is in the heap, THEN this
                # stager dies for real; the other stagers carry on
                raise exc

    # -- step dispatcher ---------------------------------------------------
    def _step_loop(self) -> None:
        executing: deque = deque()
        while not self._stop.is_set():
            with self._ready_lock:
                while not (self._ready
                           and self._ready[0][0] == self._next_step):
                    if self._stop.is_set():
                        return
                    self._ready_lock.wait(timeout=0.1)
                seq, dev_blob, n, fut, rec, exc = heapq.heappop(self._ready)
                self._next_step += 1
            outputs = None
            try:
                if exc is None:
                    outputs = self.engine.submit_blob(
                        dev_blob, n_events=n, flight_rec=rec)
            except BaseException as step_exc:
                exc = step_exc
            finally:
                with self._ready_lock:
                    self._dispatched += 1
                    self._ready_lock.notify_all()
            if outputs is None:
                fut._resolve(error=exc)
                continue
            fut._resolve(outputs)
            # bound the card's queue to `depth` steps in flight
            done = record_event(self.engine.device)
            if done is not None:
                executing.append(done)
                if len(executing) > self.depth:
                    executing.popleft().synchronize()

    # -- draining ----------------------------------------------------------
    def flush(self, timeout: Optional[float] = 60.0) -> None:
        """Wait until every submitted batch's dispatch has RETURNED (so a
        direct engine.submit() afterwards cannot overtake a pipelined
        batch). Keep the StepFuture of your last submit for its outputs."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._ready_lock:
            target = self._next_seq
            while self._dispatched < target:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("pipelined flush timed out")
                self._ready_lock.wait(timeout=0.05 if remaining is None
                                      else min(0.05, remaining))

    def close(self) -> None:
        with self._close_lock:
            self._stop.set()
        # past this point submit() can only raise: nothing new enqueues
        with self._ready_lock:
            self._ready_lock.notify_all()
        for t in self._stagers:
            t.join(timeout=5.0)
        self._step_thread.join(timeout=5.0)
        # resolve anything still queued or staged so no caller blocks
        # forever on a future the stopped threads will never touch
        leftovers = []
        while True:
            try:
                leftovers.append(self._in.get_nowait())
            except queue.Empty:
                break
        with self._ready_lock:
            while self._ready:
                leftovers.append(heapq.heappop(self._ready))
        for item in leftovers:
            fut = item[2] if len(item) == 4 else item[3]
            if not fut.done():
                fut._resolve(error=RuntimeError("submitter closed"))
            # staged-but-never-dispatched blobs still hold ring slots
            staged = item[1] if len(item) == 6 else None
            slot = getattr(staged, "slot", None)
            if slot is not None:
                self.engine.staging_ring.release(slot)


class AdaptiveBatcher:
    """Latency-tier submitter: flush on fill OR linger deadline.

    `offer(events, tokens)` buffers; a flusher thread submits the pending
    rows as soon as either (a) a full engine batch is pending or (b) the
    OLDEST pending offer has waited `linger_ms`. ``adaptive=True``
    dispatches as soon as anything is pending (an offer is a complete
    burst); the linger window then only coalesces offers that arrive while
    a flush is in flight.
    """

    def __init__(self, engine, linger_ms: float = 2.0,
                 max_rows: Optional[int] = None, adaptive: bool = False):
        self.engine = engine
        self.linger_s = max(0.0, linger_ms) / 1000.0
        self.adaptive = adaptive
        self.max_rows = max_rows or engine.batch_size
        self._lock = threading.Condition()
        self._events: List = []
        self._tokens: List[str] = []
        self._futures: List[StepFuture] = []
        # (ingest stamp, event count) per offer, folded into one
        # AgeSidecar at flush so the age waterfall sees linger time
        self._ages: List = []
        self._oldest: Optional[float] = None
        self._stop = threading.Event()
        # every flush this batcher ran, and how many of them were warm-up
        self.flushes = 0
        self.warm_flushes = 0
        self._thread = threading.Thread(target=self._flush_loop,
                                        name="feed-latency", daemon=True)
        self._thread.start()

    @property
    def steady_flushes(self) -> int:
        """Flushes run after the last warm() — the steady-state window."""
        return max(0, self.flushes - self.warm_flushes)

    def warm(self, events, tokens, repeats: int = 2,
             timeout: float = 600.0) -> int:
        """Run `repeats` full offer -> linger -> pack -> step ->
        materialized-alerts cycles and mark them as warm-up: the first pays
        the capture of the engine's step for this shape and the interner
        fills, so percentiles measured after warm() describe the steady
        state."""
        for _ in range(max(1, repeats)):
            fut = self.offer(events, tokens)
            for batch, outputs in fut.result(timeout=timeout):
                int(outputs.processed)    # waits for the step
                self.engine.materialize_alerts(batch, outputs)
        with self._lock:
            self.warm_flushes = self.flushes
        return self.warm_flushes

    def offer(self, events, tokens, received_at=None) -> StepFuture:
        """Buffer events (parallel `tokens` list, one per event); the
        returned future resolves with the flush's list of
        (batch, outputs) pairs — one per engine batch the flush needed —
        once every step covering these rows has been dispatched.
        `received_at` is the offer's ingest stamp (time.perf_counter at
        the receive edge); None stamps now."""
        fut = StepFuture()
        if not events:
            fut._resolve([])  # nothing to wait for; don't arm the linger
            return fut
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("batcher closed")
            self._events.extend(events)
            self._tokens.extend(tokens)
            self._ages.append((received_at if received_at is not None
                               else time.perf_counter(), len(events)))
            self._futures.append(fut)
            if self._oldest is None:
                self._oldest = time.monotonic()
            self._lock.notify_all()
        return fut

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while not self._stop.is_set():
                    if self._oldest is not None:
                        if self.adaptive:
                            break
                        wait = self._oldest + self.linger_s - time.monotonic()
                        if wait <= 0 or len(self._events) >= self.max_rows:
                            break
                        self._lock.wait(timeout=wait)
                    else:
                        # both state transitions (offer, close) notify
                        self._lock.wait()
                if self._stop.is_set() and not self._events:
                    return
                events, self._events = self._events, []
                tokens, self._tokens = self._tokens, []
                futures, self._futures = self._futures, []
                ages, self._ages = self._ages, []
                self._oldest = None
            self._flush(events, tokens, futures, ages)

    def _flush(self, events, tokens, futures, ages=()) -> None:
        age = AgeSidecar()
        for stamp, n in ages:
            age.add(stamp, n)
        try:
            # the whole flush's sidecar rides the FIRST batch
            results = [self.engine.submit_routed(
                           batch, age=(age if i == 0 else None))
                       for i, batch in enumerate(
                           self.engine.packer.pack_events(events, tokens))]
            with self._lock:
                self.flushes += 1
            for fut in futures:
                fut._resolve(results)
        except BaseException as exc:
            for fut in futures:
                fut._resolve(error=exc)

    def close(self) -> None:
        with self._lock:
            self._stop.set()
            self._lock.notify_all()
        self._thread.join(timeout=10.0)
