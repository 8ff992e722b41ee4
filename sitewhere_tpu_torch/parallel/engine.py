"""ShardedPipelineEngine: the step over S shards of the device population.

Counterpart of `sitewhere_tpu/parallel/engine.py`. Each shard owns the
devices `d % S == s` (their state rows and their slice of the registry
mirror); rule tables and zone geometry are shared. Events reach their owner
shard either through the on-device routing prologue (ops/route.py:
bucketing + the all_to_all as a permute, inside the step; the default with
S >= 2) or the host arena router (parallel/router.py; S == 1, and the
bounded spill of a batch too skewed for the device lanes).

The S shards live on ONE torch device (parallel/mesh.py): every state
group, per-device param row and routed blob carries a leading shard axis,
`[S, D/S, ...]` / `[S, rows, B]`. The step (`_step_into_state`) is the
single engine's `process_batch` on shard s's views, in a loop over s; the
state updates in place through the views, and the reference's psums
(`tenant_counts`, `processed`, `alerts`, int32) are sums over the shard
axis in shard order. On the card the whole loop, routing prologue
included, is one captured CUDA graph per static configuration
(pipeline/graph.py); the blob's shape tells the two programs apart (`[S,
rows, B]` host-routed, `[rows, S*B]` device-routed), so the key carries
the routing mode. The hand kernels launch once per shard per step.

The host half follows the reference: `submit` (overflow merge, the route
decision in `_prepare_step`, `stage_prepared` / `stage_routed_blob`
through the engine's staging ring, `dispatch_staged`), the overflow backlog
with its drain steps, `materialize_alerts` from the per-shard lanes
(shard-major, rows ascending within a shard), the presence sweep, and the
canonical (flat, topology-independent) layout of all four state groups
that checkpoints carry across topologies.

Single-controller only: `is_multiprocess` is False, `take_foreign` returns
None, and the multi-host data plane (ROADMAP A6d) is not here.
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.model.event import DeviceAlert
from sitewhere_tpu_torch.ops.actuate import (
    DecodedCommandLanes, decode_command_lanes, init_actuation_state)
from sitewhere_tpu_torch.ops.anomaly import init_model_state
from sitewhere_tpu_torch.ops.compact import (
    DecodedAlertLanes, decode_alert_lanes)
from sitewhere_tpu_torch.ops.pack import (
    _VALID_SHIFT, WIRE_ROWS, EventBatch, EventPacker, batch_to_blob,
    blob_to_batch, blob_to_batch_np, empty_batch, wire_variant_for)
from sitewhere_tpu_torch.ops.route import (
    ROUTE_DROPPED_SLOT, device_route_chunk, host_fits_device_route,
    route_lane_capacity)
from sitewhere_tpu_torch.ops.stateful import init_rule_state
from sitewhere_tpu_torch.parallel.mesh import (
    ShardMesh, make_mesh, shard_axis_size)
from sitewhere_tpu_torch.parallel.router import FlatBatchArena, ShardRouter
from sitewhere_tpu_torch.pipeline.engine import (
    _SECOND_COUNTER, PipelineEngine, record_event)
from sitewhere_tpu_torch.pipeline.graph import commit
from sitewhere_tpu_torch.pipeline.state_tensors import (
    DeviceStateTensors, init_device_state)
from sitewhere_tpu_torch.pipeline.step import ProcessOutputs, process_batch
from sitewhere_tpu_torch.registry.tensors import RegistryTensors
from sitewhere_tpu_torch.runtime.faults import fault_point
from sitewhere_tpu_torch.tree import tree_map

_log = logging.getLogger("sitewhere.parallel")

_TENANT_STATE_FIELDS = ("tenant_event_count", "tenant_alert_count")
# per-row outputs stack along the shard axis; the rest are shard sums
_SUMMED_OUTPUTS = ("tenant_counts", "processed", "alerts")


def _stacked(local, n_shards: int):
    """S copies of a freshly initialized per-shard group, stacked on a
    leading shard axis (one contiguous tensor a field)."""
    return tree_map(lambda t: t.unsqueeze(0).repeat(
        (n_shards,) + (1,) * t.dim()).contiguous(), local)


class RoutedBlobView:
    """Lazy routed-batch handle returned by ShardedPipelineEngine.submit:
    the staged `[S, rows, B]` wire blob IS the data; EventBatch columns
    unpack on first access (only alert materialization needs them, and
    only for steps that fired). Column attributes proxy to the unpacked
    batch. A pooled blob on loan from the router goes back through
    `release` when the view is garbage-collected."""

    __slots__ = ("blob", "_batch", "_release", "__weakref__")

    def __init__(self, blob: np.ndarray,
                 release: Optional[Callable[[], None]] = None):
        self.blob = blob
        self._batch = None
        self._release = release

    @property
    def batch(self) -> EventBatch:
        if self._batch is None:
            self._batch = blob_to_batch_np(self.blob)
        return self._batch

    def __getattr__(self, name):
        return getattr(self.batch, name)

    def __del__(self):
        release, self._release = self._release, None
        if release is not None:
            try:
                release()
            except Exception:
                pass


class DeviceRoutedView:
    """Lazy materialization handle for a DEVICE-routed step: the host never
    built the routed `[S, B]` layout, so this view rebuilds only what alert
    materialization needs (the routed device_idx / ts columns), only when
    something fired, from the flat wire blob it keeps, with the host
    router's stable bucketing over two columns."""

    __slots__ = ("blob", "_router", "_cols", "_flat", "_full", "_release",
                 "__weakref__")

    def __init__(self, blob: np.ndarray, router: ShardRouter,
                 release: Optional[Callable[[], None]] = None):
        self.blob = blob                 # flat [wire_rows, S*B]
        self._router = router
        self._cols = None
        self._flat = None
        self._full = None
        self._release = release

    def _flat_batch(self) -> EventBatch:
        if self._flat is None:
            self._flat = blob_to_batch_np(self.blob)
        return self._flat

    def _sort(self):
        flat = self._flat_batch()
        rt = self._router
        valid = np.asarray(flat.valid)
        rows = None if valid.all() else np.nonzero(valid)[0]
        devcol = np.asarray(flat.device_idx)
        dev = devcol if rows is None else devcol[rows]
        ksorted, kept, _ = rt._shard_sort(dev, rows)
        kstarts = np.zeros(rt.n_shards + 1, np.int64)
        np.cumsum(kept, out=kstarts[1:])
        return ksorted, kept, kstarts

    def _routed_cols(self):
        if self._cols is None:
            flat = self._flat_batch()
            rt = self._router
            S, B = rt.n_shards, rt.per_shard_batch
            ksorted, kept, kstarts = self._sort()
            out_dev = np.zeros((S, B), np.int32)
            out_ts = np.zeros((S, B), np.int32)
            rt._place_sorted(out_dev,
                             np.asarray(flat.device_idx)[ksorted] // S,
                             kept, kstarts)
            rt._place_sorted(out_ts, np.asarray(flat.ts)[ksorted],
                             kept, kstarts)
            self._cols = (out_dev, out_ts)
        return self._cols

    @property
    def device_idx(self) -> np.ndarray:  # LOCAL indices, [S, B]
        return self._routed_cols()[0]

    @property
    def ts(self) -> np.ndarray:          # [S, B]
        return self._routed_cols()[1]

    @property
    def batch(self) -> EventBatch:
        """The full routed `[S, B]` EventBatch rebuilt from the flat blob
        (local device indices). Cold path only."""
        if self._full is None:
            flat = self._flat_batch()
            rt = self._router
            S, B = rt.n_shards, rt.per_shard_batch
            ksorted, kept, kstarts = self._sort()
            cols = {}
            for f in dataclasses.fields(flat):
                col = np.asarray(getattr(flat, f.name))
                gathered = col[ksorted]
                if f.name == "device_idx":
                    gathered = gathered // S   # global -> local rows
                out = np.zeros((S, B), col.dtype)
                rt._place_sorted(out, gathered, kept, kstarts)
                cols[f.name] = out
            self._full = EventBatch(**cols)
        return self._full

    def __getattr__(self, name):
        return getattr(self.batch, name)

    def __del__(self):
        release, self._release = self._release, None
        if release is not None:
            try:
                release()
            except Exception:
                pass


class _PreparedStep:
    """One step's host-side routing decision: `kind` "host" (arena-routed
    `[S, rows, B]` blob, maybe a pooled loan) or "device" (unrouted flat
    `[rows, S*B]` blob; the step routes it in its prologue)."""

    __slots__ = ("kind", "blob", "flight")

    def __init__(self, kind: str, blob: np.ndarray, flight=None):
        self.kind = kind
        self.blob = blob
        # the flight record _prepare_step opened: it rides the prepared ->
        # staged -> dispatched handoff across feeder threads
        self.flight = flight


class _StagedStep:
    """A staged blob between stage_prepared and dispatch_staged: the device
    tensor (its copy maybe still running; `ready` is its event), the lazy
    materialization view, the host blob the events meter counts from, the
    loaned host blob to release, and the staging-ring slot it holds (None
    for drain blobs, which bypass the ring)."""

    __slots__ = ("blob", "view", "counted", "routed_blob", "kind",
                 "flight", "slot", "ready")

    def __init__(self, blob, view, counted, routed_blob,
                 kind: str = "host", flight=None, slot=None, ready=None):
        self.blob = blob
        self.view = view
        self.counted = counted
        self.routed_blob = routed_blob
        self.kind = kind
        self.flight = flight
        self.slot = slot
        self.ready = ready


class ShardedPipelineEngine(PipelineEngine):
    """Drop-in engine whose state, params and batches carry a leading shard
    axis. `per_shard_batch` is the per-shard batch; a flat submit carries
    up to S times as many events. Device capacity must divide by S. The
    engine runs on the mesh's device (`make_mesh(S, device=...)`)."""

    def __init__(self, registry_tensors: RegistryTensors,
                 mesh: Optional[ShardMesh] = None,
                 per_shard_batch: int = 4096,
                 device_routing: Optional[bool] = None, **kwargs):
        device = kwargs.pop("device", None)
        if mesh is None:
            mesh = make_mesh(1, device=device if device is not None
                             else "cuda")
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device!r} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.n_shards = shard_axis_size(mesh)
        if registry_tensors.devices.capacity % self.n_shards:
            raise ValueError(
                f"max_devices {registry_tensors.devices.capacity} must be "
                f"divisible by {self.n_shards} shards")
        super().__init__(registry_tensors, batch_size=per_shard_batch,
                         device=mesh.device, **kwargs)
        # pooled host staging buffers only on the card (pinned, so their
        # H2D copies run async); on the CPU the staged "transfer" may
        # alias the host buffer, as the reference's cpu backend does
        ring = 4 if self.device.type == "cuda" else 0
        self.router = ShardRouter(self.n_shards, per_shard_batch,
                                  staging_ring=ring)
        if ring:
            self.router.alloc = lambda shape, dtype: torch.empty(
                shape, dtype=torch.int32, pin_memory=True).numpy()
        # the host packer takes a whole mesh's worth of events a batch
        self.packer = EventPacker(per_shard_batch * self.n_shards,
                                  registry_tensors.devices)
        # on-device routing: auto on with two or more shards (a one-shard
        # "mesh" has nothing to exchange and keeps the host baseline)
        if device_routing is None:
            device_routing = self.n_shards >= 2
        self.device_routing = bool(device_routing)
        self.route_lane_capacity = route_lane_capacity(
            per_shard_batch, self.n_shards)
        # the bounded host-spill fallback and the (normally zero) on-device
        # drop counter, loudly accounted
        self.device_route_steps = 0
        self.device_route_fallbacks = 0
        self.device_route_dropped = 0
        # shard-overflow rows requeued ahead of the next submit; past the
        # bound, submit() drains the backlog with extra steps
        self._overflow: Optional[EventBatch] = None
        self.max_overflow_events = per_shard_batch * self.n_shards * 4
        self._merge_arena = FlatBatchArena()
        self.total_dropped = 0  # the stats contract; stays 0
        self.drain_steps = 0
        # alerts of drain steps, delivered by the next materialize_alerts
        # (bounded: overflow counts on alerts_dropped)
        self.max_pending_alerts = 65536

    # -- the single-controller topology ----------------------------------------

    @property
    def is_multiprocess(self) -> bool:
        return False

    def take_foreign(self) -> Optional[EventBatch]:
        """Rows owned by another host's shards: none on one controller
        (the multi-host data plane is ROADMAP A6d)."""
        return None

    # -- state layout ----------------------------------------------------------

    def on_initialize(self, monitor) -> None:
        S = self.n_shards
        with self._state_lock:
            if self._state is None:
                self._state = _stacked(init_device_state(
                    self.registry.devices.capacity // S,
                    self.measurement_slots, self.max_tenants,
                    device=self.device), S)
        self._ensure_params()

    def _init_group(self, group: str):
        dims = self._group_dims(group)
        self._built_dims[group] = dims
        init = {"rule": init_rule_state, "model": init_model_state,
                "actuation": init_actuation_state}[group]
        S = self.n_shards
        return _stacked(init(self.registry.devices.capacity // S, *dims,
                             device=self.device), S)

    def _device_rows(self, column: np.ndarray) -> np.ndarray:
        return self.router.shard_param(column)

    def _slot_counts(self, counter: torch.Tensor) -> np.ndarray:
        # per-shard additive partials: the global count is their sum
        return counter.cpu().numpy().sum(0, dtype=np.int32)

    def _device_row(self, field: torch.Tensor, idx: int) -> torch.Tensor:
        return field[idx % self.n_shards, idx // self.n_shards]

    def _global_indices(self, mask: np.ndarray) -> np.ndarray:
        # shard-major, as the reference's sweep: local l on s is l*S + s
        shards, local = np.nonzero(mask)
        return local * self.n_shards + shards

    # -- the step ----------------------------------------------------------------

    def _shard_params(self, s: int):
        p = self._params
        return dataclasses.replace(
            p, assignment_status=p.assignment_status[s],
            tenant_idx=p.tenant_idx[s], area_idx=p.area_idx[s],
            device_type_idx=p.device_type_idx[s])

    def _step_into_state(self, blob: torch.Tensor) -> ProcessOutputs:
        """The sharded step as a graph captures it: the routing prologue
        for a flat blob, then process_batch on each shard's views with the
        new state copied back through them, then the per-shard outputs
        stacked and the stats summed over the shard axis."""
        S = self.n_shards
        dropped = None
        if blob.dim() == 2:
            blob, dropped = device_route_chunk(
                blob, S, self.batch_size, self.route_lane_capacity)
        outs = []
        for s in range(S):
            views = [tree_map(lambda t: t[s], group) for group in (
                self._state, self._rule_state, self._model_state,
                self._actuation_state)]
            *new, out = process_batch(
                self._shard_params(s), *views, blob_to_batch(blob[s]),
                geofence_impl=self.geofence_impl,
                alert_lane_capacity=self.alert_lane_capacity,
                command_lane_capacity=self.command_lane_capacity,
                **self._step_flags)
            for view, group in zip(views, new):
                commit(view, group)
            outs.append(out)
        fields = {}
        for f in dataclasses.fields(ProcessOutputs):
            parts = torch.stack([getattr(o, f.name) for o in outs])
            fields[f.name] = (parts.sum(0, dtype=torch.int32)
                              if f.name in _SUMMED_OUTPUTS else parts)
        if dropped is not None:
            fields["alert_lanes"][:, 3, ROUTE_DROPPED_SLOT] = dropped
        return ProcessOutputs(**fields)

    # -- processing --------------------------------------------------------------

    def submit(self, batch: EventBatch, age=None
               ) -> Tuple[object, ProcessOutputs]:
        """Route a flat host batch (global indices, any length) to its
        shards and run one step. Returns (the routed view of the LAST step,
        its outputs). Rows past a shard's capacity are requeued ahead of
        the next submit (their device's order holds: they predate the next
        batch's rows). Past `max_overflow_events` of backlog, submit runs
        extra drain steps (backlog only) until it fits: slower, never
        lossy; `drain_steps` counts them."""
        self._ensure_started()
        batch = self.merge_pending_overflow(batch)
        prepared, over_rows = self._prepare_step(batch, age=age)
        view, outputs = self._one_step(prepared)
        self.park_overflow(batch, over_rows)
        while (self._overflow is not None
               and self.pending_overflow > self.max_overflow_events):
            # the caller sees only the LAST step: materialize the one about
            # to be superseded so its alerts are not lost
            self._stash_pending_alerts(self._materialize_routed(view,
                                                                outputs))
            backlog, self._overflow = self._overflow, None
            self.drain_steps += 1
            self._metrics.counter("overflow.drain_steps").inc()
            prepared, over_rows = self._prepare_step(backlog)
            view, outputs = self._one_step(prepared)
            self.park_overflow(backlog, over_rows)
        return view, outputs

    def submit_routed(self, batch: EventBatch, age=None):
        """(routed view, outputs): sharded submit already returns both."""
        return self.submit(batch, age=age)

    def _prepare_step(self, batch: EventBatch, age=None
                      ) -> Tuple[_PreparedStep, np.ndarray]:
        """Host half of one step's routing decision. With device routing,
        a flat batch that fits the lanes (the cheap bincount guard) is
        packed UNROUTED and no overflow is possible; otherwise (skew past a
        lane, a merged backlog longer than the global batch, host-routing
        mode) the host arena route runs and its overflow requeues."""
        rec = self.flight.begin_step(engine=self.name)
        if age is not None:
            rec.age = age
        self._sample_tenant_mix(rec, batch)
        if self.device_routing and self._device_route_fits(batch):
            self.device_route_steps += 1
            self._metrics.counter("route.device_steps").inc()
            rec.begin_stage("route_device")
            fault_point("pack_fail")
            blob = self._pack_flat_blob(batch)
            rec.end_stage("route_device")
            self._stage_hist.observe(rec.stage_s("route_device"),
                                     engine=self.name, stage="route_device")
            return (_PreparedStep("device", blob, flight=rec),
                    np.empty(0, np.int64))
        if self.device_routing:
            self.device_route_fallbacks += 1
            self._metrics.counter("route.host_fallbacks").inc()
        rec.begin_stage("route_host")
        fault_point("pack_fail")
        routed_blob, over_rows = self.router.route_batch(batch)
        rec.end_stage("route_host")
        self._stage_hist.observe(rec.stage_s("route_host"),
                                 engine=self.name, stage="route_host")
        return _PreparedStep("host", routed_blob, flight=rec), over_rows

    def _device_route_fits(self, batch: EventBatch) -> bool:
        n = batch.device_idx.shape[0]
        if n > self.batch_size * self.n_shards:
            return False  # longer than the global batch: host path requeues
        return host_fits_device_route(
            batch.device_idx, batch.valid, self.n_shards, self.batch_size,
            self.route_lane_capacity)

    def _pack_flat_blob(self, batch: EventBatch) -> np.ndarray:
        """Pack a flat batch into the UNROUTED `[rows, S*B]` staging blob
        (pooled on the card), zero-padding a short batch to the global
        width: with device routing, this and one H2D copy are all the host
        does a step."""
        G = self.batch_size * self.n_shards
        rows, _ = self.router._routable_variant(*wire_variant_for(batch))
        buf = self.router.flat_staging_buffer(rows)
        n = batch.device_idx.shape[0]
        if n == G:
            return batch_to_blob(batch, out=buf, wire_rows=rows)
        small = batch_to_blob(batch, wire_rows=rows)
        if buf is None:
            buf = np.empty((small.shape[0], G), np.int32)
        buf[:, :n] = small
        buf[:, n:] = 0
        return buf

    @staticmethod
    def _slice_flat(batch: EventBatch,
                    rows: np.ndarray) -> Optional[EventBatch]:
        if len(rows) == 0:
            return None
        return EventBatch(**{f.name: np.asarray(getattr(batch, f.name))[rows]
                             for f in dataclasses.fields(batch)})

    # -- the overflow backlog (submit and the pipelined feeder) ---------------

    def merge_pending_overflow(self, batch: EventBatch) -> EventBatch:
        """Fold the parked backlog AHEAD of `batch` and clear it. The
        result holds views into a reused arena: route it immediately."""
        if self._overflow is None:
            return batch
        merged = self._merge_arena.concat([self._overflow, batch])
        self._overflow = None
        return merged

    def park_overflow(self, batch: EventBatch, over_rows: np.ndarray) -> None:
        """Park `batch`'s capacity-overflow rows (flat indices) for the
        next merge, as copies (safe when `batch` is an arena view)."""
        self._overflow = self._slice_flat(batch, over_rows)

    def pending_overflow_batch(self) -> Optional[EventBatch]:
        return self._overflow

    def set_pending_overflow_batch(self, batch: Optional[EventBatch]) -> None:
        self._overflow = batch

    @property
    def pending_overflow(self) -> int:
        return 0 if self._overflow is None else int(
            np.asarray(self._overflow.valid).sum())

    def drain_pending(self) -> int:
        """Fold the parked backlog into state with empty-batch drain steps
        (a checkpoint save calls this first: the backlog's bus offsets may
        be committed). Fired alerts stash for the next materialize_alerts.
        Returns the number of drain steps."""
        steps = 0
        while self.pending_overflow > 0:
            view, outputs = self.submit(empty_batch(1))
            self._stash_pending_alerts(self._materialize_routed(view,
                                                                outputs))
            steps += 1
        return steps

    def _stash_pending_alerts(self, alerts: List[DeviceAlert]) -> None:
        """Bounded stash: past max_pending_alerts, alerts count on
        alerts_dropped, never silently truncated."""
        room = self.max_pending_alerts - len(self._pending_alerts)
        if len(alerts) > room:
            dropped = len(alerts) - max(0, room)
            self.alerts_dropped += dropped
            self._metrics.counter("alerts.dropped").inc(dropped)
        self._pending_alerts.extend(alerts[:max(0, room)])

    # -- staging and dispatch ------------------------------------------------------

    def _one_step(self, prepared: _PreparedStep):
        return self.dispatch_staged(self.stage_prepared(prepared))

    def _stage_copy(self, slot, blob: np.ndarray):
        """The transfer of a flat or routed blob: on the card an async copy
        on the H2D side stream into a view of the slot's fixed device
        buffer (sized for the largest layout), returning (view, event); a
        ring-bypassing blob (slot None) copies on the current stream. On
        the CPU a plain copy and no event."""
        host = torch.from_numpy(np.ascontiguousarray(blob))
        if self.device.type != "cuda":
            return host.clone(), None
        if slot is None:
            return host.to(self.device), None
        size = self.n_shards * WIRE_ROWS * self.batch_size
        with torch.cuda.stream(self._h2d_stream):
            if slot.buffer is None or slot.buffer.numel() != size:
                slot.buffer = torch.empty(size, dtype=torch.int32,
                                          device=self.device)
            dst = slot.buffer[:host.numel()].view(host.shape)
            dst.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return dst, ready

    def _stage(self, blob: np.ndarray, rec, order, use_ring):
        """Start `blob`'s transfer (through a ring slot unless `use_ring`
        is off), arming `h2d_error` with the bounded retry. Returns (device
        blob, ready event, slot)."""
        slot = (self._acquire_staging_slot(rec, order) if use_ring
                else None)
        if rec is not None:
            rec.begin_stage("h2d")
        try:
            dev, ready = self._retried(lambda: self._stage_copy(slot, blob),
                                       ("h2d_error",), note_success=False)
        except BaseException:
            if slot is not None:
                self.staging_ring.release(slot)
            raise
        finally:
            if rec is not None:
                rec.end_stage("h2d")
        if slot is not None:
            slot.device_blob = dev
        return dev, ready, slot

    def stage_prepared(self, prepared: _PreparedStep,
                       order: Optional[int] = None,
                       use_ring: bool = True) -> _StagedStep:
        """Start the host->device transfer of a prepared step WITHOUT
        dispatching it, so a pipelined feeder overlaps it with the previous
        step. `order` is the feeder's sequence (ring slots are granted in
        dispatch order); overflow-drain blobs bypass the ring (`use_ring`
        False): a drain blob dispatches before its step reaches the ready
        heap, so waiting for a slot its siblings hold would deadlock."""
        rec = prepared.flight
        if prepared.kind == "device":
            dev, ready, slot = self._stage(prepared.blob, rec, order,
                                           use_ring)
            view = DeviceRoutedView(prepared.blob, self.router)
            return _StagedStep(dev, view, prepared.blob, prepared.blob,
                               kind="device", flight=rec, slot=slot,
                               ready=ready)
        return self.stage_routed_blob(prepared.blob, flight_rec=rec,
                                      order=order, use_ring=use_ring)

    def stage_routed_blob(self, routed_blob: np.ndarray, flight_rec=None,
                          order: Optional[int] = None,
                          use_ring: bool = True) -> _StagedStep:
        """Start the transfer of a HOST-routed `[S, rows, B]` blob (the
        host-arena half of stage_prepared)."""
        dev, ready, slot = self._stage(routed_blob, flight_rec, order,
                                       use_ring)
        return _StagedStep(dev, RoutedBlobView(routed_blob), routed_blob,
                           routed_blob, flight=flight_rec, slot=slot,
                           ready=ready)

    def dispatch_staged(self, staged: _StagedStep):
        """Dispatch the step on a staged blob (the resident params and
        state). Returns (view, outputs) without waiting for the card."""
        self._ensure_started()
        view = staged.view
        rec = staged.flight
        if rec is None:
            rec = self.flight.begin_step(engine=self.name)
        rec.begin_stage("dispatch")
        # h2d_error armed at staging; only the dispatch point here
        try:
            outputs = self._dispatch_with_retry(
                staged.blob, staged.ready, points=("dispatch_error",))
        except BaseException:
            if staged.slot is not None:
                self.staging_ring.release(staged.slot)
            raise
        rec.end_stage("dispatch")
        guard = record_event(self.device)
        if staged.slot is not None:
            self.staging_ring.release(staged.slot, guard)
        self._flight_last = rec
        self._stage_hist.observe(rec.stage_s("dispatch"),
                                 engine=self.name, stage="dispatch")
        if staged.routed_blob is not None and self.router.staging_ring:
            # the pooled host blob returns when the view is collected; its
            # copy's event proves the H2D read it
            view._release = partial(self.router.release_staging_buffer,
                                    staged.routed_blob,
                                    staged.ready or guard)
        self.batches_processed += 1
        # rows this call stepped, from the blob's head bits (an overflow
        # row counts once, on the step that carries it)
        n_events = int(
            ((staged.counted[..., 0, :] >> _VALID_SHIFT) & 1).sum())
        rec.events = n_events
        self._metrics.meter("events").mark(n_events)
        return view, outputs

    # -- materialization -------------------------------------------------------------

    def materialize_alerts(self, routed_batch, outputs: ProcessOutputs,
                           max_alerts: Optional[int] = None
                           ) -> List[DeviceAlert]:
        """Alerts of the last submit, after any stashed by drain steps."""
        pending, self._pending_alerts = self._pending_alerts, []
        try:
            return pending + self._materialize_routed(routed_batch, outputs,
                                                      max_alerts)
        except BaseException:
            self._pending_alerts[:0] = pending
            raise

    def _materialize_routed(self, routed_batch, outputs: ProcessOutputs,
                            max_alerts: Optional[int] = None
                            ) -> List[DeviceAlert]:
        """Decode the per-shard lanes, fetched in ONE host copy ([S, 4, K]
        alert + [S, 4, Kc] command lanes), shard-major with rows ascending
        within a shard, which is the flattened mask scan's order. The
        routed blob unpacks only when something fired."""
        rec = self._flight_last
        if rec is not None:
            rec.begin_stage("lane_fetch")
        lanes, cmd_lanes = self._fetch_lanes_with_retry(outputs)
        if rec is not None:
            rec.end_stage("lane_fetch")
            self._stage_hist.observe(rec.stage_s("lane_fetch"),
                                     engine=self.name, stage="lane_fetch")
        self.d2h_fetches += 2
        self.d2h_bytes += lanes.nbytes + cmd_lanes.nbytes
        if rec is not None:
            rec.begin_stage("materialize")
        try:
            decs = [decode_alert_lanes(lanes[s])
                    for s in range(lanes.shape[0])]
            self._account_lane_overflow(sum(d.dropped_alerts for d in decs))
            self._account_route_dropped(sum(d.route_dropped for d in decs))
            if not any(d.n for d in decs):
                return []
            if isinstance(routed_batch, RoutedBlobView):
                routed_batch = routed_batch.batch
            dev = np.asarray(routed_batch.device_idx)        # [S, B]
            ts = np.asarray(routed_batch.ts)
            S_rows, B = dev.shape
            rows_flat = np.concatenate(
                [s * B + d.rows for s, d in enumerate(decs)])
            shard_of = np.concatenate(
                [np.full(d.n, s, np.int32) for s, d in enumerate(decs)])

            def cat(name):
                return np.concatenate([getattr(d, name) for d in decs])

            combined = DecodedAlertLanes(
                rows=rows_flat,
                thr_fired=cat("thr_fired"), geo_fired=cat("geo_fired"),
                thr_rule=cat("thr_rule"), geo_rule=cat("geo_rule"),
                thr_level=cat("thr_level"), geo_level=cat("geo_level"),
                fired_rows=sum(d.fired_rows for d in decs),
                dropped_alerts=sum(d.dropped_alerts for d in decs),
                total_alerts=sum(d.total_alerts for d in decs),
                prog_fired=cat("prog_fired"), prog_rule=cat("prog_rule"),
                prog_level=cat("prog_level"),
                route_dropped=sum(d.route_dropped for d in decs),
                model_fired=cat("model_fired"),
                model_slot=cat("model_slot"))
            # local index l on shard s is global l * S + s
            dev_rows = dev.reshape(-1)[rows_flat] * self.n_shards + shard_of
            ts_rows = ts.reshape(-1)[rows_flat]
            bounded = self._bound_alert_rows(combined, max_alerts)
            n = bounded.n
            return self._emit_alerts(bounded, dev_rows[:n], ts_rows[:n])
        finally:
            if rec is not None:
                rec.end_stage("materialize")
                self._stage_hist.observe(
                    rec.stage_s("materialize"),
                    engine=self.name, stage="materialize")
            self._materialize_commands_sharded(cmd_lanes, rec)
            if rec is not None:
                self._close_age(rec)

    def _materialize_commands_sharded(self, cmd_lanes: np.ndarray,
                                      rec) -> None:
        """Decode the per-shard command lanes ([S, 4, Kc], same fetch) and
        resolve fires with GLOBAL device indices, shard-major like the
        alert lanes; accounting and fan-out are the single engine's."""
        if rec is not None:
            rec.begin_stage("actuate")
        try:
            S = cmd_lanes.shape[0]
            decs = [decode_command_lanes(cmd_lanes[s]) for s in range(S)]
            B = self.batch_size
            combined = DecodedCommandLanes(
                rows=np.concatenate(
                    [s * B + d.rows for s, d in enumerate(decs)]),
                policy_slot=np.concatenate([d.policy_slot for d in decs]),
                level=np.concatenate([d.level for d in decs]),
                source=np.concatenate([d.source for d in decs]),
                dev=np.concatenate([d.dev * self.n_shards + s
                                    for s, d in enumerate(decs)]),
                fired=sum(d.fired for d in decs),
                dropped=sum(d.dropped for d in decs),
                debounced=sum(d.debounced for d in decs))
            self._account_command_activity(combined)
            fires = (self._emit_command_fires(combined)
                     if combined.n else [])
            if rec is not None:
                rec.commands = len(fires)
        finally:
            if rec is not None:
                rec.end_stage("actuate")
                self._stage_hist.observe(rec.stage_s("actuate"),
                                         engine=self.name, stage="actuate")
        self._fanout_commands(fires, rec)

    def _account_route_dropped(self, dropped: int) -> None:
        """The on-device route's drop count (lane counts slot 3): zero on
        every step the host guard admitted, so a nonzero count is loud."""
        if not dropped:
            return
        self.device_route_dropped += dropped
        self._metrics.counter("route.device_dropped").inc(dropped)
        _log.error(
            "device route dropped %d rows past the %d-slot lanes despite "
            "the host fit guard (device_route_dropped=%d total) — "
            "investigate: the guard and the route disagree",
            dropped, self.route_lane_capacity, self.device_route_dropped)

    # -- reads -----------------------------------------------------------------------

    def canonical_state(self) -> DeviceStateTensors:
        """Flat device-major snapshot: device fields un-shard through the
        router layout (global d lives at (d % S, d // S)); the per-shard
        tenant counters are additive and sum. Bit-identical to a single
        engine that processed the same events."""
        with self._state_lock:
            snap = tree_map(lambda t: t.to("cpu", copy=True), self.state)
        out = {}
        for f in dataclasses.fields(snap):
            a = getattr(snap, f.name).numpy()
            out[f.name] = torch.from_numpy(
                a.sum(0, dtype=a.dtype) if f.name in _TENANT_STATE_FIELDS
                else self.router.unshard_param(a))
        return DeviceStateTensors(**out)

    def load_canonical_state(self, state: DeviceStateTensors) -> None:
        """Re-shard a flat snapshot onto the resident state (copied in
        place): device fields to their (d % S, d // S) owner, the additive
        tenant counters onto shard 0."""
        self._ensure_started()
        S = self.n_shards
        out = {}
        for f in dataclasses.fields(state):
            a = np.asarray(getattr(state, f.name))
            c = tuple(getattr(self._state, f.name).shape)
            want = (c[1:] if f.name in _TENANT_STATE_FIELDS
                    else (c[0] * c[1],) + c[2:])
            if tuple(a.shape) != want:
                raise ValueError(
                    f"checkpoint shape mismatch for {f.name}: got "
                    f"{tuple(a.shape)}, engine expects {want} (device "
                    f"capacity/measurement slots/tenant width must match)")
            if f.name in _TENANT_STATE_FIELDS:
                stacked = np.zeros((S,) + a.shape, a.dtype)
                stacked[0] = a
            else:
                stacked = self.router.shard_param(a)
            out[f.name] = torch.from_numpy(stacked)
        with self._state_lock:
            commit(self._state, DeviceStateTensors(**out))

    def set_state(self, state: DeviceStateTensors) -> None:
        """The resident layout is stacked [S, D/S, ...]; checkpoints use the
        flat canonical layout through load_canonical_state."""
        raise TypeError(
            "ShardedPipelineEngine state is shard-stacked; restore flat "
            "canonical snapshots via load_canonical_state()")

    def _canonical_group(self, group: str):
        """Flat device-major snapshot of a state group: the slab un-shards,
        the per-shard counters sum, `gen` takes the per-slot max (every
        shard steps in lockstep, so they agree once a step has run)."""
        with self._state_lock:
            state = getattr(self, f"_{group}_state")
            if state is None:
                return None
            snap = tree_map(lambda t: t.to("cpu", copy=True), state)
        out = {}
        for f in dataclasses.fields(snap):
            a = getattr(snap, f.name).numpy()
            if f.name in ("fire_count", _SECOND_COUNTER[group]):
                a = a.sum(0, dtype=a.dtype)
            elif f.name == "gen":
                a = a.max(0)
            else:
                a = self.router.unshard_param(a)
            out[f.name] = torch.from_numpy(np.ascontiguousarray(a))
        return type(snap)(**out)

    def _load_canonical_group(self, group: str, state) -> None:
        """Inverse of _canonical_group, copied into the resident group
        (sized to this engine's dims first): the slab re-shards, `gen`
        goes to every shard (the next step's stale check must see it),
        the additive counters land on shard 0."""
        mismatch = self.canonical_group_mismatch(group, state)
        if mismatch is not None:
            raise ValueError(mismatch)
        S = self.n_shards
        out = {}
        for f in dataclasses.fields(state):
            a = np.asarray(getattr(state, f.name))
            if f.name == "gen":
                stacked = np.ascontiguousarray(
                    np.broadcast_to(a, (S,) + a.shape))
            elif f.name in ("fire_count", _SECOND_COUNTER[group]):
                stacked = np.zeros((S,) + a.shape, a.dtype)
                stacked[0] = a
            else:
                stacked = self.router.shard_param(a)
            out[f.name] = torch.from_numpy(stacked)
        with self._lock, self._state_lock:
            self._ensure_groups_sized()
            commit(getattr(self, f"_{group}_state"), type(state)(**out))

    def stats(self):
        with self._state_lock:
            s = self.state
            tenant_events = s.tenant_event_count.sum(
                0, dtype=torch.int32).cpu().tolist()
            tenant_alerts = s.tenant_alert_count.sum(
                0, dtype=torch.int32).cpu().tolist()
        return {
            "batches": self.batches_processed,
            "dropped": self.total_dropped,
            "drain_steps": self.drain_steps,
            "pending_overflow": self.pending_overflow,
            # fallbacks: steps the skew guard spilled to the host route;
            # route_dropped stays 0 unless the guard and the route disagree
            "device_routing": self.device_routing,
            "device_route_steps": self.device_route_steps,
            "device_route_fallbacks": self.device_route_fallbacks,
            "device_route_dropped": self.device_route_dropped,
            "tenant_event_count": tenant_events,
            "tenant_alert_count": tenant_alerts,
            "scope": "global",
        }
