"""ShardedPipelineEngine: the step over S shards of the device population.

Counterpart of `sitewhere_tpu/parallel/engine.py`. Each shard owns the
devices `d % S == s` (their state rows and their slice of the registry
mirror); rule tables and zone geometry are shared. Events reach their owner
shard either through the on-device routing prologue (ops/route.py:
bucketing + the all_to_all as a permute, inside the step; the default with
S >= 2) or the host arena router (parallel/router.py; S == 1, and the
bounded spill of a batch too skewed for the device lanes).

The S shards live in card blocks (parallel/mesh.py): card k holds shards
`[k*S/K, (k+1)*S/K)`, and every state group, per-device param row and
routed blob of the block carries a leading shard axis on that card, `[S/K,
D/S, ...]` / `[S/K, rows, B]`. The resident groups and params are `Blocks`
(tree.py), one tree a card; the replicated tables (threshold, zones,
geofence, programs, models, policies) are copied to every card at each
refresh. A card's step (`_card_outputs`) is the single engine's
`process_batch` on each of its shards' views, in a loop; the state updates
in place through the views, and the reference's psums (`tenant_counts`,
`processed`, `alerts`, int32) are sums over the card's shards in shard
order, whose K partials meet on the first card in card order (integer
sums: any order gives the same bits). The per-row outputs and the lanes
come to the first card in shard order.

On the card each static configuration's step is captured: with one card
the whole loop, routing prologue included, is one CUDA graph
(pipeline/graph.py); over K cards each card has its own graph, recorded on
that card's capture stream and replayed from one thread, so that the cards
run at once. The device route's exchange crosses cards, so over K cards a
device-routed step is, on every card, a captured route prologue
(`route_bucket`), then the copies between cards (`route_exchange`, eager:
PyTorch orders a copy between two cards with events on both cards' current
streams, which a capture on one card cannot hold), then the captured body
(`route_compact` and the shards' loop). The blob's shape tells the two
programs apart (`[S, rows, B]` host-routed, `[rows, S*B]` device-routed),
so the key carries the routing mode. The hand kernels launch once per
shard per step, each on its shard's card.

The host half follows the reference: `submit` (overflow merge, the route
decision in `_prepare_step`, `stage_prepared` / `stage_routed_blob`
through the engine's staging ring, `dispatch_staged`), the overflow backlog
with its drain steps, `materialize_alerts` from the per-shard lanes
(shard-major, rows ascending within a shard), the presence sweep, and the
canonical (flat, topology-independent) layout of all four state groups
that checkpoints carry across topologies.

On a multi-process mesh (parallel/distributed.py `make_global_mesh`) the
engine is one host of the reference's multi-host data plane. It holds its
own contiguous block of shards, stacked `[S_local, D/S, ...]` on its own
device, and every process runs the same step in lockstep
(parallel/cluster.py `ClusterStepLoop`):

  - Per-host feeding. The host route places a batch's rows on all S
    shards; only the local shards' rows are staged, and the rows of
    another process's shards come back through `take_foreign` as a flat
    batch with global device indices, for the caller to forward to their
    owner. Device routing is refused, and the wire layout is pinned to the
    full one, so every process captures the same program.
  - The step loops over the local shards inside the captured graph, and
    sums the three int32 shard sums locally; after each replay they go
    through one gloo `all_reduce(SUM)` on the mesh's step group (an
    integer sum, so the order cannot change a bit). No collective is
    inside the graph, and `submit` runs no drain steps: a host-local
    number of steps would pair one host's sums with a peer's next step.
  - Reads are local: alerts, command fires and the presence sweep cover
    this host's devices, `get_device_state` answers None for another
    host's device, and `stats` are this host's (`scope: local`). The
    canonical snapshots raise (they would need a gather inside the
    lockstep protocol); `local_state_shards` and the
    `local_{rule,model,actuation}_state_blocks` pairs save and restore
    this host's blocks (the checkpoint's `host-shards` layout).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.event import DeviceAlert
from sitewhere_tpu_torch.ops.actuate import (
    DecodedCommandLanes, decode_command_lanes, init_actuation_state)
from sitewhere_tpu_torch.ops.anomaly import init_model_state
from sitewhere_tpu_torch.ops.compact import (
    DecodedAlertLanes, decode_alert_lanes)
from sitewhere_tpu_torch.ops.pack import (
    _VALID_SHIFT, WIRE_ROWS, EventBatch, EventPacker, batch_to_blob,
    blob_to_batch, blob_to_batch_np, empty_batch, wire_variant_for)
from sitewhere_tpu_torch.device import on_card, same_device
from sitewhere_tpu_torch.ops.route import (
    ROUTE_DROPPED_SLOT, device_route_cards, device_route_chunk,
    host_fits_device_route, route_bucket, route_compact, route_exchange,
    route_lane_capacity)
from sitewhere_tpu_torch.ops.stateful import init_rule_state
from sitewhere_tpu_torch.parallel.mesh import (
    ShardMesh, make_mesh, shard_axis_size)
from sitewhere_tpu_torch.parallel.router import (
    FlatBatchArena, ShardRouter, concat_flat_batches)
from sitewhere_tpu_torch.pipeline.engine import (
    _SECOND_COUNTER, PipelineEngine, record_event)
from sitewhere_tpu_torch.pipeline.graph import (
    capture_graph, capture_step, commit, pool_bytes, step_key)
from sitewhere_tpu_torch.pipeline.state_tensors import (
    DeviceStateTensors, init_device_state)
from sitewhere_tpu_torch.pipeline.step import (
    ProcessOutputs, check_presence, process_batch)
from sitewhere_tpu_torch.registry.tensors import RegistryTensors
from sitewhere_tpu_torch.runtime.faults import fault_point
from sitewhere_tpu_torch.tree import (
    Blocks, split_blocks, to_device, tree_map)

_log = logging.getLogger("sitewhere.parallel")

_TENANT_STATE_FIELDS = ("tenant_event_count", "tenant_alert_count")
# per-row outputs stack along the shard axis; the rest are shard sums
_SUMMED_OUTPUTS = ("tenant_counts", "processed", "alerts")


def _stacked(local, n_shards: int):
    """S copies of a freshly initialized per-shard group, stacked on a
    leading shard axis (one contiguous tensor a field)."""
    return tree_map(lambda t: t.unsqueeze(0).repeat(
        (n_shards,) + (1,) * t.dim()).contiguous(), local)


class _CardSteps:
    """One static configuration's step captured over K cards: per card the
    body (`CapturedStep`: its shards' loop, reading its routed blob), and
    for a device-routed key the route prologue graph and the exchange's
    static buffers (the lanes each card received, the ts base).

    `marks`, when a caller sets it to a list, receives each replay's phase
    boundaries ("start", "prologues", "exchange", "bodies", and the
    engine's "gathered"): (name, host perf_counter, one timing event a
    block recorded on its card's current stream). Off (None) it costs one
    test a boundary."""

    def __init__(self, cards, bodies, prologues=None, flats=None,
                 sends=None, bases=None, received=None,
                 received_bases=None):
        self.cards = cards
        self.bodies = bodies
        self.prologues = prologues
        self.flats = flats
        self.sends = sends
        self.bases = bases
        self.received = received
        self.received_bases = received_bases
        self.marks: Optional[list] = None

    def mark(self, name: str) -> None:
        """Record a phase boundary on every card (see the class)."""
        if self.marks is None:
            return
        events = []
        for card in self.cards:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(card))
            events.append(event)
        self.marks.append((name, time.perf_counter(), events))

    def replay(self, parts):
        """Queue one step on every card (the prologues, the exchange, the
        bodies) and return each card's outputs, on the first card: views
        of the first card's own output buffer (and of any block that
        shares its device), one copy of every other card's buffer. Returns
        without waiting for a card."""
        self.mark("start")
        if self.prologues is not None:
            for flat, part, graph in zip(self.flats, parts, self.prologues):
                flat.copy_(part, non_blocking=True)
                graph.replay()
            self.mark("prologues")
            self.exchange()
            self.mark("exchange")
            for body in self.bodies:
                body.replay(None, copy_out=False)
        else:
            for body, part in zip(self.bodies, parts):
                body.replay(part, copy_out=False)
        self.mark("bodies")
        return self.outputs_on_first()

    def exchange(self) -> None:
        """The route's copies between the cards (device-routed keys)."""
        route_exchange(self.sends, self.bases, self.received,
                       self.received_bases)

    def outputs_on_first(self) -> List[ProcessOutputs]:
        """Each card's outputs of the last replay, on the first card."""
        first = self.cards[0]
        return [body.arena.views(body.out_flat if same_device(card, first)
                                 else body.out_flat.to(first,
                                                       non_blocking=True))
                for card, body in zip(self.cards, self.bodies)]

    def resident_bytes(self, block: int) -> int:
        """Device bytes block `block`'s graphs keep: the body's pool,
        output and input buffers (the lanes received in the exchange, for
        a device-routed key), and the prologue's pool and input."""
        body = self.bodies[block]
        total = (body.pool_bytes() + int(body.out_flat.nbytes)
                 + int(body.static_blob.nbytes))
        if self.prologues is not None:
            total += (pool_bytes(self.prologues[block].pool())
                      + int(self.flats[block].nbytes))
        return total


class RoutedBlobView:
    """Lazy routed-batch handle returned by ShardedPipelineEngine.submit:
    the staged `[S, rows, B]` wire blob IS the data; EventBatch columns
    unpack on first access (only alert materialization needs them, and
    only for steps that fired). Column attributes proxy to the unpacked
    batch. A pooled blob on loan from the router goes back through
    `release` when the view is garbage-collected. Under multi-process
    feeding the blob holds the local shards only, `shard_ids` their global
    indices."""

    __slots__ = ("blob", "shard_ids", "_batch", "_release", "__weakref__")

    def __init__(self, blob: np.ndarray,
                 release: Optional[Callable[[], None]] = None,
                 shard_ids: Optional[List[int]] = None):
        self.blob = blob
        self.shard_ids = shard_ids
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
    engine runs on the mesh's cards (`make_mesh(S, ...)`), one block of
    shards a card; `device` is its first card."""

    def __init__(self, registry_tensors: RegistryTensors,
                 mesh: Optional[ShardMesh] = None,
                 per_shard_batch: int = 4096,
                 device_routing: Optional[bool] = None, **kwargs):
        device = kwargs.pop("device", None)
        if mesh is None:
            mesh = make_mesh(1, device=device if device is not None
                             else "cuda")
        elif device is not None and not same_device(device, mesh.device):
            raise ValueError(f"device {device!r} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.n_shards = shard_axis_size(mesh)
        # the card blocks: block k on cards[k], shards_per_card shards each
        self.cards = tuple(mesh.cards)
        self.n_cards = len(self.cards)
        self.shards_per_card = mesh.shards_per_card
        # this process's shards (all of them on one controller): a
        # contiguous block of the shard axis
        self.local_shards: List[int] = list(mesh.local_shards)
        self._local_ids = np.asarray(self.local_shards, np.int32)
        self._local = slice(self.local_shards[0], self.local_shards[-1] + 1)
        self._foreign: Optional[EventBatch] = None
        self.sum_reduces, self.sum_reduce_s = 0, 0.0
        if registry_tensors.devices.capacity % self.n_shards:
            raise ValueError(
                f"max_devices {registry_tensors.devices.capacity} must be "
                f"divisible by {self.n_shards} shards")
        super().__init__(registry_tensors, batch_size=per_shard_batch,
                         device=mesh.device, **kwargs)
        # one H2D side stream a card block (the first: the engine's own),
        # and the replays' kernel launches ({name: count} a block) and
        # captures per block
        self._h2d_streams = (
            [self._h2d_stream] + [torch.cuda.Stream(card)
                                  for card in self.cards[1:]]
            if self.device.type == "cuda" else [None] * self.n_cards)
        self.card_kernel_launches: List[Dict[str, int]] = [
            {} for _ in self.cards]
        self.card_graph_captures = [0] * self.n_cards
        self._step_mode = ""
        # pooled host staging buffers only on the card (pinned, so their
        # H2D copies run async); on the CPU the staged "transfer" may
        # alias the host buffer, as the reference's cpu backend does
        ring = 4 if self.device.type == "cuda" else 0
        self.router = ShardRouter(self.n_shards, per_shard_batch,
                                  staging_ring=ring)
        if ring:
            self.router.alloc = lambda shape, dtype: torch.empty(
                shape, dtype=torch.int32, pin_memory=True).numpy()
        if self.is_multiprocess:
            # lockstep: every host captures the same program, whatever its
            # batches' content would pick
            self.router.fixed_wire_rows = WIRE_ROWS
        # the host packer takes a whole mesh's worth of events a batch
        self.packer = EventPacker(per_shard_batch * self.n_shards,
                                  registry_tensors.devices)
        # on-device routing: auto on with two or more shards of one
        # controller (a one-shard "mesh" has nothing to exchange and keeps
        # the host baseline; a cluster host feeds its own shards and hands
        # the rest back through take_foreign)
        if device_routing is None:
            device_routing = self.n_shards >= 2 and not self.is_multiprocess
        elif device_routing and self.is_multiprocess:
            raise ValueError(
                "device_routing is single-controller only: multi-host "
                "clusters feed per-host and forward foreign rows over "
                "the bus edge (take_foreign)")
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

    # -- the multi-process topology ------------------------------------------

    @property
    def is_multiprocess(self) -> bool:
        return self.mesh.is_multiprocess

    @property
    def n_local(self) -> int:
        return len(self.local_shards)

    def take_foreign(self) -> Optional[EventBatch]:
        """Rows this host ingested whose owner shard lives on ANOTHER
        process, as a flat batch with global device indices (None when
        there are none), for the caller to forward over the bus edge to
        their owner: never dropped here."""
        batch, self._foreign = self._foreign, None
        return batch

    def _stash_foreign(self, routed_blob: np.ndarray) -> None:
        """Accumulate the valid rows routed to non-local shards."""
        local = set(self.local_shards)
        others = [s for s in range(self.n_shards) if s not in local]
        sub = routed_blob[others]                       # [F, rows, B]
        if not ((sub[:, 0, :] >> _VALID_SHIFT) & 1).any():
            return
        cols = blob_to_batch_np(sub)                    # local indices
        shard_of = np.repeat(np.asarray(others, np.int32), sub.shape[-1])
        flat = {f.name: np.asarray(getattr(cols, f.name)).reshape(-1)
                for f in dataclasses.fields(cols)}
        flat["device_idx"] = flat["device_idx"] * self.n_shards + shard_of
        rows = np.nonzero(flat["valid"])[0]
        batch = EventBatch(**{k: v[rows] for k, v in flat.items()})
        self._foreign = (batch if self._foreign is None
                         else concat_flat_batches([self._foreign, batch]))

    def _multihost_refusal(self, what: str) -> SiteWhereError:
        return SiteWhereError(
            f"{what} is not available on a live cluster (it would need a "
            f"collective inside the lockstep protocol); each host saves "
            f"its own shard blocks (local_state_shards, no collective). "
            f"Merge every host's checkpoint into the canonical "
            f"any-topology snapshot offline: `python -m sitewhere_tpu_torch "
            f"assemble-checkpoint <host0-ckpt> <host1-ckpt> ... --out "
            f"<dir>`", ErrorCode.GENERIC, http_status=409)

    # -- state layout ----------------------------------------------------------

    def on_initialize(self, monitor) -> None:
        S = self.n_shards
        with self._state_lock:
            if self._state is None:
                self._state = Blocks(_stacked(init_device_state(
                    self.registry.devices.capacity // S,
                    self.measurement_slots, self.max_tenants,
                    device=card), self.shards_per_card)
                    for card in self.cards)
        self._ensure_params()

    def _init_group(self, group: str):
        dims = self._group_dims(group)
        self._built_dims[group] = dims
        init = {"rule": init_rule_state, "model": init_model_state,
                "actuation": init_actuation_state}[group]
        S = self.n_shards
        return Blocks(_stacked(init(self.registry.devices.capacity // S,
                                    *dims, device=card),
                               self.shards_per_card) for card in self.cards)

    def _device_rows(self, column: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            self.router.shard_param(column)[self._local])

    def _place_params(self, params):
        """One copy of the params a card: the replicated tables whole, the
        registry rows of the card's block of shards."""
        n = self.shards_per_card
        rows = ("assignment_status", "tenant_idx", "area_idx",
                "device_type_idx")
        return Blocks(to_device(dataclasses.replace(params, **{
            name: getattr(params, name)[k * n:(k + 1) * n] for name in rows}),
            card) for k, card in enumerate(self.cards))

    def _commit_blocks(self, blocks: Blocks, host) -> None:
        """Copy a host tree whose sharded leaves are stacked `[S_local,
        ...]` into the resident blocks, each block its rows."""
        commit(blocks, split_blocks(host,
                                    [self.shards_per_card] * self.n_cards))

    def _host_blocks(self, blocks: Blocks) -> dict:
        """{field: host `[S_local, ...]` array} of a resident group, the
        blocks concatenated in card order (a copy)."""
        return {f.name: getattr(blocks, f.name).cpu().numpy()
                for f in dataclasses.fields(blocks[0])}

    def _slot_counts(self, counter) -> np.ndarray:
        # per-shard additive partials: the global count is their sum
        return counter.cpu().numpy().sum(0, dtype=np.int32)

    def _device_row(self, field, idx: int) -> torch.Tensor:
        block, row = divmod(idx % self.n_shards - self._local.start,
                            self.shards_per_card)
        return field[block][row, idx // self.n_shards]

    def _sweep_presence(self, now_rel: int, interval_ms: int) -> np.ndarray:
        """The presence check on each card's block, with that card's
        registry rows; the masks come back `[S_local, D/S]`."""
        masks = []
        for k, card in enumerate(self.cards):
            with on_card(card):
                state, newly_missing = check_presence(
                    self._state[k], self._params[k].assignment_status == 1,
                    now_rel, interval_ms)
                commit(self._state[k], state)
            masks.append(newly_missing.cpu().numpy())
        return np.concatenate(masks)

    def owns(self, idx: int) -> bool:
        """Whether global device `idx` lives on one of this host's shards."""
        return self._local.start <= idx % self.n_shards < self._local.stop

    def get_device_state(self, device_token: str):
        """A device of another host's shards answers None (ask its host:
        ownership is static, d % S)."""
        idx = self.registry.devices.lookup(device_token)
        if idx > 0 and not self.owns(idx):
            return None
        return super().get_device_state(device_token)

    def _global_indices(self, mask: np.ndarray) -> np.ndarray:
        # shard-major, as the reference's sweep: local l on s is l*S + s
        shards, local = np.nonzero(mask)
        return local * self.n_shards + self._local_ids[shards]

    # -- the step ----------------------------------------------------------------

    @staticmethod
    def _shard_params(params, i: int):
        """Shard i's params from its card's copy: its registry rows, the
        replicated tables."""
        return dataclasses.replace(
            params, assignment_status=params.assignment_status[i],
            tenant_idx=params.tenant_idx[i], area_idx=params.area_idx[i],
            device_type_idx=params.device_type_idx[i])

    def _card_outputs(self, k: int, blob: torch.Tensor,
                      dropped: Optional[torch.Tensor] = None
                      ) -> ProcessOutputs:
        """Card k's step as its graph captures it: process_batch on each of
        its shards' views of the routed `[S/K, rows, B]` blob, the new
        state copied back through them; the per-row outputs stacked, the
        stats summed over the card's shards in shard order, and the route's
        drop counts (device route) in the lanes' spare slot."""
        groups = (self._state[k], self._rule_state[k], self._model_state[k],
                  self._actuation_state[k])
        params = self._params[k]
        outs = []
        with on_card(self.cards[k]):
            for i in range(blob.shape[0]):
                views = [tree_map(lambda t: t[i], group) for group in groups]
                *new, out = process_batch(
                    self._shard_params(params, i), *views,
                    blob_to_batch(blob[i]),
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

    def _step_into_state(self, blob: torch.Tensor) -> ProcessOutputs:
        """The one-card step as a graph captures it: the routing prologue
        for a flat blob, then the card's shards."""
        dropped = None
        if blob.dim() == 2:
            with on_card(self.cards[0]):
                blob, dropped = device_route_chunk(
                    blob, self.n_shards, self.batch_size,
                    self.route_lane_capacity)
        return self._card_outputs(0, blob, dropped)

    # -- the step over several cards -------------------------------------------

    def _card_parts(self, blob) -> List[torch.Tensor]:
        """A blob's per-card parts, each on its card: a host-routed `[S,
        rows, B]` blob splits on the shard axis, a flat `[rows, S*B]` one
        into each card's lane chunks. Staged parts pass through."""
        if isinstance(blob, (list, tuple)):
            return list(blob)
        blob = torch.as_tensor(blob)
        n, K = self.shards_per_card, self.n_cards
        if blob.dim() == 3:
            parts = [blob[k * n:(k + 1) * n] for k in range(K)]
        else:
            width = blob.shape[1] // K
            parts = [blob[:, k * width:(k + 1) * width] for k in range(K)]
        return [part.contiguous().to(card)
                for part, card in zip(parts, self.cards)]

    def _global_shape(self, parts) -> Tuple[int, ...]:
        """The whole blob's shape from its parts (the step key's)."""
        shape = tuple(parts[0].shape)
        if len(shape) == 3:
            return (shape[0] * len(parts),) + shape[1:]
        return (shape[0], shape[1] * len(parts))

    def _run_step(self, blob, ready):
        """One step under the state lock. One card: the single engine's
        (one graph a key). Several: a replay of every card's captured step,
        or, for a key's first step (and every step on the CPU), the cards'
        step run eagerly on the live buffers; either way the cards' outputs
        are gathered on the first card. Returns (outputs, None), or
        (outputs, (key, parts, per-card outputs)) when the key is to be
        captured."""
        parts = self._card_parts(blob)
        ready = ready or [None] * self.n_cards
        if self.n_cards == 1:
            return super()._run_step(parts[0], ready[0])
        key = step_key(self._step_flags, self._global_shape(parts))
        if key in self._failed_captures:
            raise RuntimeError(f"the step of {key} failed to capture "
                               f"({self._failed_captures[key]})")
        for card, event in zip(self.cards, ready):
            if event is not None:
                torch.cuda.current_stream(card).wait_event(event)
        steps = self._graphs.get(key)
        if steps is not None:
            outs = steps.replay(parts)
            self._step_mode = "replay"
            for k, body in enumerate(steps.bodies):
                self._count_replay(body.kernel_launches, k)
            outputs = self._gather_outputs(outs)
            steps.mark("gathered")
            return outputs, None
        outs = self._cards_step(parts)
        self._step_mode = "eager"
        return (self._gather_outputs(outs),
                (key, parts, outs) if self._captures() else None)

    def _count_replay(self, launches: Dict[str, int], block: int = 0
                      ) -> None:
        """Add one replay's kernel launches on block `block`'s card to
        `graph_kernel_launches` and to the block's `card_kernel_launches`."""
        super()._count_replay(launches)
        counts = self.card_kernel_launches[block]
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n

    def _cards_step(self, parts) -> List[ProcessOutputs]:
        """Every card's step, eagerly: for flat parts the route over the
        cards (each card buckets its chunks, the exchange, each card
        compacts), then each card's shards."""
        if parts[0].dim() == 3:
            return [self._card_outputs(k, part)
                    for k, part in enumerate(parts)]
        routed = device_route_cards(parts, self.n_shards, self.batch_size,
                                    self.route_lane_capacity)
        return [self._card_outputs(k, blob, dropped)
                for k, (blob, dropped) in enumerate(routed)]

    def _gather_outputs(self, outs: List[ProcessOutputs]) -> ProcessOutputs:
        """The cards' outputs as one step's, on the first card: the per-row
        fields and the lanes concatenated in shard order, the three int32
        partials summed in card order."""
        first = self.cards[0]
        with on_card(first):
            fields = {}
            for f in dataclasses.fields(ProcessOutputs):
                parts = [getattr(o, f.name).to(first, non_blocking=True)
                         for o in outs]
                if f.name in _SUMMED_OUTPUTS:
                    total = parts[0]
                    for part in parts[1:]:
                        total = total + part
                    fields[f.name] = total
                else:
                    fields[f.name] = torch.cat(parts)
        return ProcessOutputs(**fields)

    def _capture(self, key_and_blob, outputs: ProcessOutputs) -> None:
        """One card: the single engine's capture. Several: every card's
        step captured on its own card (for a device-routed key, its route
        prologue and its body), unless another thread changed the static
        configuration since the eager step."""
        if self.n_cards == 1:
            return super()._capture(key_and_blob, outputs)
        key, parts, outs = key_and_blob
        if key in self._graphs or key != step_key(
                self._step_flags, self._global_shape(parts)):
            return
        K, n = self.n_cards, self.shards_per_card
        S, B, C = self.n_shards, self.batch_size, self.route_lane_capacity
        if parts[0].dim() == 3:
            bodies = [capture_step(partial(self._card_outputs, k), part,
                                   outs[k])
                      for k, part in enumerate(parts)]
            steps = _CardSteps(self.cards, bodies)
        else:
            flats, prologues, sends, drops, bases = [], [], [], [], []
            for k, (part, card) in enumerate(zip(parts, self.cards)):
                with on_card(card):
                    flat = torch.empty_like(part)
                graph, (send, dropped, base), _ = capture_graph(
                    partial(route_bucket, flat, k * n, S, B, C), card)
                flats.append(flat)
                prologues.append(graph)
                sends.append(send)
                drops.append(dropped)
                bases.append(base)
            received, received_bases = [], []
            for card in self.cards:
                with on_card(card):
                    received.append(torch.empty(
                        (K,) + tuple(sends[0][:n].shape), dtype=torch.int32,
                        device=card))
                    received_bases.append(
                        None if bases[0] is None else
                        torch.empty((), dtype=torch.int32, device=card))

            def body(k, recv):
                blob, dropped = route_compact(recv, drops[k],
                                              received_bases[k], B)
                return self._card_outputs(k, blob, dropped)

            bodies = [capture_step(partial(body, k), received[k], outs[k],
                                   static_blob=received[k])
                      for k in range(K)]
            steps = _CardSteps(self.cards, bodies, prologues, flats, sends,
                               bases, received, received_bases)
        self._graphs[key] = steps
        self.graph_captures += K
        for k in range(K):
            self.card_graph_captures[k] += 1

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
        # a cluster host never runs extra steps: they would pair its sums
        # with a peer's next step; its step loop stops pulling new work
        # while the backlog is over the bound instead
        while (not self.is_multiprocess
               and self._overflow is not None
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
        Returns the number of drain steps. Single-controller only: a
        cluster host's checkpoint saves the backlog itself."""
        if self.is_multiprocess:
            raise RuntimeError(
                "drain_pending is single-controller only; multi-host "
                "checkpoints persist the overflow batch in the manifest")
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
        """The transfer of a flat or routed blob, a part a card block (its
        shards' rows of a routed blob, its lane chunks of a flat one; the
        whole blob on one card), each into the slot's fixed buffer on the
        block's card. On the card async copies on the block's H2D side
        stream, a flat part's one row at a time (each row of a lane chunk
        is contiguous in the pinned host blob, so nothing is copied on the
        host first), returning (parts, one event a block); on the CPU
        plain copies and no events. A ring-bypassing blob (slot None)
        copies on the current streams."""
        host = torch.from_numpy(np.ascontiguousarray(blob))
        K = self.n_cards
        if host.dim() == 3:
            n = self.shards_per_card
            parts = [host[k * n:(k + 1) * n] for k in range(K)]
        else:
            width = host.shape[1] // K
            parts = [host[:, k * width:(k + 1) * width] for k in range(K)]
        if slot is None:
            return [part.to(card, copy=True)
                    for part, card in zip(parts, self.cards)], None
        size = self.shards_per_card * WIRE_ROWS * self.batch_size
        if not slot.buffers or slot.buffers[0].numel() != size:
            slot.buffers = [torch.empty(size, dtype=torch.int32, device=card)
                            for card in self.cards]
        if self.device.type != "cuda":
            out = [buf[:part.numel()].view(part.shape).copy_(part)
                   for buf, part in zip(slot.buffers, parts)]
            return out, None
        out, ready = [], []
        for k, part in enumerate(parts):
            stream = self._h2d_streams[k]
            with torch.cuda.stream(stream):
                dst = slot.buffers[k][:part.numel()].view(part.shape)
                for d, p in ([(dst, part)] if part.is_contiguous()
                             else zip(dst, part)):
                    d.copy_(p, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            out.append(dst)
            ready.append(event)
        return out, ready

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
        host-arena half of stage_prepared). A cluster host stages only its
        local shards' rows (a copy: the pooled routed blob goes back to
        the shelf here) and stashes the others' for take_foreign."""
        if self.is_multiprocess:
            self._stash_foreign(routed_blob)
            local_blob = np.ascontiguousarray(routed_blob[self._local])
            self.router.release_staging_buffer(routed_blob)
            dev, ready, slot = self._stage(local_blob, flight_rec, order,
                                           use_ring)
            return _StagedStep(dev, RoutedBlobView(
                local_blob, shard_ids=self.local_shards), local_blob, None,
                flight=flight_rec, slot=slot, ready=ready)
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
        if self.is_multiprocess:
            outputs = self._all_reduce_sums(outputs)
        rec.end_stage("dispatch")
        if self.n_cards > 1:
            rec.cards = [{"block": k, "card": str(card),
                          "h2d": staged.slot is not None,
                          "exchange": staged.kind == "device",
                          "step": self._step_mode}
                         for k, card in enumerate(self.cards)]
        guard = record_event(self.device)
        if staged.slot is not None:
            self.staging_ring.release(staged.slot, guard)
        self._flight_last = rec
        self._stage_hist.observe(rec.stage_s("dispatch"),
                                 engine=self.name, stage="dispatch")
        if staged.routed_blob is not None and self.router.staging_ring:
            # the pooled host blob returns when the view is collected; the
            # step's guard proves the H2D read it (the first card waited
            # for every card's copy)
            view._release = partial(self.router.release_staging_buffer,
                                    staged.routed_blob, guard)
        self.batches_processed += 1
        # rows this call stepped, from the blob's head bits (an overflow
        # row counts once, on the step that carries it)
        n_events = int(
            ((staged.counted[..., 0, :] >> _VALID_SHIFT) & 1).sum())
        rec.events = n_events
        self._metrics.meter("events").mark(n_events)
        return view, outputs

    def _all_reduce_sums(self, outputs: ProcessOutputs) -> ProcessOutputs:
        """The step's three int32 shard sums over every process: one gloo
        all_reduce(SUM) of the local sums (a host tensor), after the
        replay. Every process makes this call once a step, in the same
        order as the step loop's vote (the mesh's step group).
        `sum_reduces` and `sum_reduce_s` count these calls and the seconds
        of their all_reduce."""
        import torch.distributed as dist

        parts = [getattr(outputs, name) for name in _SUMMED_OUTPUTS]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu()
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=self.mesh.step_group)
        self.sum_reduce_s += time.perf_counter() - t0
        self.sum_reduces += 1
        flat = flat.to(self.device)
        out, pos = {}, 0
        for name, part in zip(_SUMMED_OUTPUTS, parts):
            out[name] = flat[pos:pos + part.numel()].view(part.shape)
            pos += part.numel()
        return outputs.replace(**out)

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
            ids = self._local_ids
            shard_of = np.concatenate(
                [np.full(d.n, ids[s], np.int32) for s, d in enumerate(decs)])

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
                dev=np.concatenate([d.dev * self.n_shards
                                    + self._local_ids[s]
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
        engine that processed the same events. A cluster host raises (409):
        see `local_state_shards`."""
        if self.is_multiprocess:
            raise self._multihost_refusal("multi-host canonical gather")
        with self._state_lock:
            snap = self._host_blocks(self.state)
        out = {}
        for name, a in snap.items():
            out[name] = torch.from_numpy(
                a.sum(0, dtype=a.dtype) if name in _TENANT_STATE_FIELDS
                else self.router.unshard_param(a))
        return DeviceStateTensors(**out)

    def load_canonical_state(self, state: DeviceStateTensors) -> None:
        """Re-shard a flat snapshot onto the resident state (copied in
        place): device fields to their (d % S, d // S) owner, the additive
        tenant counters onto shard 0."""
        if self.is_multiprocess:
            raise self._multihost_refusal("a canonical restore")
        self._ensure_started()
        S = self.n_shards
        out = {}
        for f in dataclasses.fields(state):
            a = np.asarray(getattr(state, f.name))
            c = tuple(getattr(self._state, f.name).shape)   # [S_local, ...]
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
            self._commit_blocks(self._state, DeviceStateTensors(**out))

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
            if self.is_multiprocess:
                raise self._multihost_refusal(
                    f"a multi-host canonical {group}-state gather")
            snap = self._host_blocks(state)
        out = {}
        for name, a in snap.items():
            if name in ("fire_count", _SECOND_COUNTER[group]):
                a = a.sum(0, dtype=a.dtype)
            elif name == "gen":
                a = a.max(0)
            else:
                a = self.router.unshard_param(a)
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
        return type(state[0])(**out)

    def _load_canonical_group(self, group: str, state) -> None:
        """Inverse of _canonical_group, copied into the resident group
        (sized to this engine's dims first): the slab re-shards, `gen`
        goes to every shard (the next step's stale check must see it),
        the additive counters land on shard 0."""
        if self.is_multiprocess:
            raise self._multihost_refusal(
                f"a canonical {group}-state restore")
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
            self._commit_blocks(getattr(self, f"_{group}_state"),
                                type(state)(**out))

    # -- the per-host shard layout (a cluster's gang-restart checkpoint) -----

    def local_state_shards(self):
        """(local shard ids, {field: [S_local, ...] host blocks}): THIS
        host's slice of the device state, a local copy with no collective,
        so any host checkpoints at any time without lockstep. Restores onto
        the same topology (`load_local_state_shards`); elastic restores
        stay the canonical layout's job."""
        with self._state_lock:
            blocks = self._host_blocks(self.state)
        return list(self.local_shards), blocks

    def load_local_state_shards(self, shard_ids, blocks) -> None:
        """Inverse of local_state_shards on the same topology: this host's
        blocks copied into the resident state."""
        if list(shard_ids) != list(self.local_shards):
            raise ValueError(
                f"host-shard checkpoint was taken for shards "
                f"{list(shard_ids)}; this process owns {self.local_shards} "
                f"— per-host checkpoints restore onto the same cluster "
                f"topology only (use a single-controller canonical "
                f"checkpoint to change topology)")
        self._ensure_started()
        out = {}
        for f in dataclasses.fields(DeviceStateTensors):
            local = np.ascontiguousarray(blocks[f.name])
            expect = tuple(getattr(self._state, f.name).shape)
            if tuple(local.shape) != expect:
                raise ValueError(
                    f"host-shard checkpoint field {f.name}: local shape "
                    f"{tuple(local.shape)} != engine {expect} (global "
                    f"{(self.n_shards,) + tuple(local.shape[1:])})")
            out[f.name] = torch.from_numpy(local)
        with self._state_lock:
            self._commit_blocks(self._state, DeviceStateTensors(**out))

    def _local_group_blocks(self, group: str):
        with self._state_lock:
            state = getattr(self, f"_{group}_state")
            if state is None:
                return None
            return self._host_blocks(state)

    def _load_local_group_blocks(self, group: str, blocks) -> None:
        """This host's blocks of a state group, copied into the resident
        group sized to this engine's dims (ValueError when a block's shape
        differs: the family's buckets changed since the save)."""
        self._ensure_started()
        with self._lock, self._state_lock:
            self._ensure_groups_sized()
            state = getattr(self, f"_{group}_state")
            out = {}
            for f in dataclasses.fields(state[0]):
                local = np.ascontiguousarray(blocks[f.name])
                expect = tuple(getattr(state, f.name).shape)
                if tuple(local.shape) != expect:
                    raise ValueError(
                        f"host-shard {group}-state field {f.name}: local "
                        f"shape {tuple(local.shape)} != engine {expect}")
                out[f.name] = torch.from_numpy(local)
            self._commit_blocks(state, type(state[0])(**out))

    def local_rule_state_blocks(self):
        return self._local_group_blocks("rule")

    def load_local_rule_state_blocks(self, blocks) -> None:
        self._load_local_group_blocks("rule", blocks)

    def local_model_state_blocks(self):
        return self._local_group_blocks("model")

    def load_local_model_state_blocks(self, blocks) -> None:
        self._load_local_group_blocks("model", blocks)

    def local_actuation_state_blocks(self):
        return self._local_group_blocks("actuation")

    def load_local_actuation_state_blocks(self, blocks) -> None:
        self._load_local_group_blocks("actuation", blocks)

    def stats(self):
        with self._state_lock:
            s = self.state
            tenant_events = s.tenant_event_count.cpu().sum(
                0, dtype=torch.int32).tolist()
            tenant_alerts = s.tenant_alert_count.cpu().sum(
                0, dtype=torch.int32).tolist()
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
            # a cluster host's tenant totals cover its own shards only
            "scope": "local" if self.is_multiprocess else "global",
        }
