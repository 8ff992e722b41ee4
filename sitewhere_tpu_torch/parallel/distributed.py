"""Cluster bootstrap and window-sharded analytics on the shard axis.

Counterpart of `sitewhere_tpu/parallel/distributed.py`. Its two concerns:

1. **Cluster bootstrap** (`initialize`, `make_global_mesh`, `live_mesh`,
   `process_shard_indices`). `initialize` joins N processes into one
   `torch.distributed` world over gloo (a TCP store at the coordinator's
   address, process 0 hosting it) and opens two gloo groups: the step
   loop's (its stop vote and the step's int32 sums) and the analytics'
   (the partial grids' all-gather), so that a query and a tick never pair
   their collectives across processes. Gloo, not NCCL: NCCL refuses two
   ranks on one GPU, and the collectives are small host tensors; every
   kernel of the step stays on the card. `make_global_mesh` then builds
   the mesh that spans every process's shards (parallel/mesh.py): process
   p holds the contiguous block `[p*S/P, (p+1)*S/P)` on its own device.

2. **Window-sharded replay analytics** (`sharded_windowed_stats`). The
   replay's rows split into S contiguous blocks, one a shard; each block
   folds into its own [K, W] grid, and the S partial grids combine over
   the shard axis. The result is the reference's single-process result bit
   for bit, which fixes two orders the reference's XLA CPU program follows
   (probed):

   * the fold: one pass of `analytics/windows.py` `block_partials` over
     the blocks (each block's rows in row order, one segment-sum launch
     for every block's cells; a block of one row is stored as it is);
   * `combine="psum"`: the collective's order. Counts add as integers.
     Sums add from +0.0 in shard order, `((0 + l0) + l1) + ... + l_{S-1}`,
     operands and results flushed, a NaN that meets a NaN giving way to the
     incoming one. Min and max start from +inf / -inf and take a shard's
     flushed value only where it is strictly smaller / larger, so a NaN
     never enters and a tie keeps the earlier shard's zero;
   * `combine="ring"`: shard 0's ring chain, `((l0 + l_{S-1}) + l_{S-2})
     + ... + l1`, with XLA's elementwise add, minimum and maximum (NaN-
     propagating; -0.0 below +0.0; of two NaNs, min keeps the first unless
     its sign bit is set, max keeps the first only if its sign bit is set).

   With one shard the collective is a no-op in either combine, so the
   local grid passes through unchanged.

   Over a mesh of K cards each card folds its own blocks (one
   `block_partials` pass, one segment-sum launch a card, on that card),
   the `[S/K, K*W]` partials come to the first card in shard order, and
   the combine runs there unchanged; the grids come back on the caller's
   device, which need not be one of the mesh's cards.

   On a multi-process mesh every process passes the full rows, folds only
   its own blocks (one `block_partials` pass, one segment-sum launch on
   its device), all-gathers the `[S_local, K*W]` partials in shard order
   over the analytics group (host tensors), and runs the same combine, so
   every process returns the same grids, the single-process S-shard
   result's bits. The reference's two-process program follows other
   orders there (probed; ROADMAP C): its psum adds each cell in gloo's
   chunked ring order, which differs from cell to cell, and its ring
   answers each process its own first shard's chain.

Empty cells (count 0 on every shard) finalize to the canonical NaN in
mean, min and max, as one device's grid does. The combine is torch ops in
an explicit loop over shards: `torch.sum` over the shard axis promises no
order, on the card least of all.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.windows import (
    WindowedStats, _as_tensor, _quiet, block_partials, finalize_mean,
    grids_of)
from sitewhere_tpu_torch.device import (
    DeviceLike, on_card, own_stream, resolve_device)
from sitewhere_tpu_torch.ops.numerics import flush_denormals
from sitewhere_tpu_torch.parallel.mesh import (
    ShardMesh, make_mesh, shard_axis_size)

_X86_DEFAULT_NAN = -0x00400000   # 0xFFC00000: inf + -inf

# the joined world: its two gloo groups and the global mesh last built
_WORLD: Dict[str, object] = {"step_group": None, "query_group": None,
                             "mesh": None}


def _joined() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join (or form) the multi-process cluster.

    Reads the coordinator ("host:port"), the process count and this
    process's id from the arguments or SWTPU_COORDINATOR /
    SWTPU_NUM_PROCESSES / SWTPU_PROCESS_ID. Returns False for a
    single-process run (no coordinator configured), so callers need no
    special-casing; with one, joins the gloo world (process 0 hosts the
    TCP store at the coordinator's address; every process blocks until
    all have joined) and returns True."""
    coordinator_address = coordinator_address or os.environ.get(
        "SWTPU_COORDINATOR")
    if num_processes is None and "SWTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SWTPU_NUM_PROCESSES"])
    if process_id is None and "SWTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SWTPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"a cluster needs a coordinator, a process count and this "
            f"process's id; got {coordinator_address!r}, {num_processes}, "
            f"{process_id}")
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("this process already joined a cluster")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    # every process creates the groups in this order (a collective)
    _WORLD["step_group"] = dist.new_group(backend="gloo")
    _WORLD["query_group"] = dist.new_group(backend="gloo")
    _WORLD["mesh"] = None
    return True


def shutdown() -> None:
    """Leave the joined world (a no-op when none was joined)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.update(step_group=None, query_group=None, mesh=None)


def make_global_mesh(devices: Optional[Sequence] = None, *,
                     n_shards: Optional[int] = None,
                     device: DeviceLike = "cuda") -> ShardMesh:
    """The mesh over every process's shards.

    In a joined world of P processes: `n_shards` global shards split evenly
    over the processes (ValueError when P does not divide it) on this
    process's `device`; or, from a library caller, `devices`, this
    process's device once for each of its shards (S = P * len(devices));
    with neither, one shard a process. Without a joined world: one shard
    per device given, each on its own card (a device given twice holds
    two blocks), `n_shards` shards on `device`, or one shard per visible
    card, shard s on card s (raises without one)."""
    if devices is not None:
        devs = list(devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        local, dev = len(devs), torch.device(devs[0])
    else:
        local, dev = None, None
    if not _joined():
        if local is not None:
            return make_mesh(local, devices=devs)
        if n_shards is not None:
            return ShardMesh(int(n_shards), resolve_device(device))
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("no CUDA device is visible; pass devices "
                               "(e.g. [torch.device('cpu')] * S) to build a "
                               "mesh elsewhere")
        return ShardMesh(count, cards=[torch.device("cuda", k)
                                       for k in range(count)])
    import torch.distributed as dist

    P, p = dist.get_world_size(), dist.get_rank()
    if local is not None:
        S = local * P
    else:
        S = P if n_shards is None else int(n_shards)
        if S % P:
            raise ValueError(f"{S} shards do not split evenly over {P} "
                             f"processes")
        dev = resolve_device(device)
    mesh = ShardMesh(S, dev, n_processes=P, process_index=p,
                     step_group=_WORLD["step_group"],
                     query_group=_WORLD["query_group"])
    _WORLD["mesh"] = mesh
    return mesh


def live_mesh() -> Optional[ShardMesh]:
    """The default replay mesh. When two or more processes joined: the
    global mesh (the one last built by `make_global_mesh`, else one shard
    a process on this process's card). In one process: one shard on each
    visible card when there are two or more, as the reference's mesh over
    `jax.devices()`; None with one card or none (a mesh of S shards on one
    card does the host route's work and a combine on top). A sharded
    instance's planner takes its engine's mesh instead, and a cluster
    host's planner none (instance.py `_serving_mesh`)."""
    if _joined():
        return _WORLD["mesh"] or make_global_mesh()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return make_global_mesh()


def process_shard_indices(mesh: ShardMesh) -> np.ndarray:
    """Shard indices whose rows THIS process feeds (the multi-host data
    contract: each host stages only its local shards)."""
    return np.asarray(mesh.local_shards, dtype=np.int32)


# -- window-sharded analytics -------------------------------------------------

def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.view(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b as XLA's CPU code adds (bits): operands and result flushed,
    the first NaN operand quieted, inf + -inf the x86 default NaN. The CPU
    collective's `acc += x` is `_add(x, acc)`: the incoming NaN wins."""
    fa, fb = flush_denormals(_f32(a)), flush_denormals(_f32(b))
    r = _bits(flush_denormals(fa + fb))
    r = torch.where(torch.isnan(_f32(r)), _X86_DEFAULT_NAN, r)
    r = torch.where(torch.isnan(fb), _quiet(b), r)
    return torch.where(torch.isnan(fa), _quiet(a), r)


def _extremum_xla(a: torch.Tensor, b: torch.Tensor,
                  is_min: bool) -> torch.Tensor:
    """jnp.minimum / jnp.maximum as XLA's CPU code computes them (bits):
    operands flushed, -0.0 below +0.0, a NaN operand returned as it is; of
    two NaNs, min returns `a` unless its sign bit is set and max returns
    `a` only if it is."""
    fa, fb = flush_denormals(_f32(a)), flush_denormals(_f32(b))
    ba, bb = _bits(fa), _bits(fb)
    if is_min:
        tie = ba | bb          # -0.0 wins a tie of zeros
        r = torch.where(fa < fb, ba, torch.where(fb < fa, bb, tie))
        keep_a = a >= 0        # sign bit clear
    else:
        tie = ba & bb          # +0.0 wins a tie of zeros
        r = torch.where(fa > fb, ba, torch.where(fb > fa, bb, tie))
        keep_a = a < 0
    nan_a, nan_b = torch.isnan(fa), torch.isnan(fb)
    r = torch.where(nan_b, b, r)
    return torch.where(nan_a & (~nan_b | keep_a), a, r)


def _masked(count: torch.Tensor, bits: torch.Tensor, fill: float
            ) -> torch.Tensor:
    """`bits` where the shard has rows, else the f32 `fill` (bits)."""
    return torch.where(count == 0, _bits(torch.tensor(
        fill, dtype=torch.float32, device=bits.device)), bits)


def _combine_psum(count, vsum, vmin, vmax):
    """The partial grids ([S, C] each, f32 as bits) combined as the CPU
    collective combines them: see the module docstring."""
    total = count[0].clone()
    acc_sum = torch.zeros_like(vsum[0])
    acc_min = _bits(torch.full_like(_f32(vmin[0]), float("inf")))
    acc_max = _bits(torch.full_like(_f32(vmax[0]), float("-inf")))
    for s in range(count.shape[0]):
        if s:
            total += count[s]
        acc_sum = _add(vsum[s], acc_sum)
        x = flush_denormals(_f32(_masked(count[s], vmin[s], float("inf"))))
        acc_min = torch.where(x < _f32(acc_min), _bits(x), acc_min)
        x = flush_denormals(_f32(_masked(count[s], vmax[s], float("-inf"))))
        acc_max = torch.where(x > _f32(acc_max), _bits(x), acc_max)
    return total, acc_sum, acc_min, acc_max


def _combine_ring(count, vsum, vmin, vmax):
    """Shard 0's ring chain (the reference's `ppermute` ring, S - 1 steps,
    each bringing the next shard to the left): l0, l_{S-1}, ..., l1."""
    total = count[0].clone()
    acc_sum = vsum[0]
    acc_min = _masked(count[0], vmin[0], float("inf"))
    acc_max = _masked(count[0], vmax[0], float("-inf"))
    for s in range(count.shape[0] - 1, 0, -1):
        total += count[s]
        acc_sum = _add(acc_sum, vsum[s])
        acc_min = _extremum_xla(
            acc_min, _masked(count[s], vmin[s], float("inf")), True)
        acc_max = _extremum_xla(
            acc_max, _masked(count[s], vmax[s], float("-inf")), False)
    return total, acc_sum, acc_min, acc_max


def sharded_windowed_stats(keys, ts_rel, value, valid, *, window_ms: int,
                           num_keys: int, n_windows: int, mesh: ShardMesh,
                           combine: str = "psum",
                           timings: Optional[Dict[str, float]] = None,
                           device: Optional[DeviceLike] = None
                           ) -> WindowedStats:
    """windowed_stats over a mesh: the replay's rows split into one block a
    shard, each block folded into its own [K, W] grid on its shard's card,
    the grids combined over the shard axis (`combine` = "psum" | "ring") on
    the mesh's first card.

    Rows are padded with invalid rows to a multiple of the mesh size, as
    the reference pads them. On a multi-process mesh every process passes
    the same rows and calls this together (a collective on the mesh's
    analytics group); each returns the same grids. Replays on one card
    run one at a time (`_replay_gate`, held on every card a replay
    touches). A `timings` dict receives the host-clock split (`fold_s`,
    `gather_s`, `combine_s`), each part waited for on the devices, and,
    over several cards, `fold_s_by_card`, each card's fold. `device` is
    where the caller's rows are and where the grids come back (default
    the mesh's first card); a card's work runs on the calling thread's own
    stream of that card (device.py `own_stream`)."""
    if combine not in ("psum", "ring"):
        raise ValueError(f"combine {combine!r}: expected 'psum' or 'ring'")
    dev = mesh.device if device is None else resolve_device(device)
    touched = _distinct([dev] + list(mesh.cards))
    with contextlib.ExitStack() as held:
        for card in sorted(touched, key=str):
            held.enter_context(_replay_gate(card))
        for card in touched:
            held.enter_context(own_stream(card))
        stats = _sharded_stats(keys, ts_rel, value, valid,
                               window_ms=window_ms, num_keys=num_keys,
                               n_windows=n_windows, mesh=mesh,
                               combine=combine, timings=timings, device=dev)
        for card in touched:
            if card.type == "cuda":
                # the partial grids are freed only once this stream is done
                torch.cuda.current_stream(card).synchronize()
    return stats


def _distinct(devices) -> List[torch.device]:
    """The distinct devices of a list, first occurrence first ("cuda"
    spelled with the current card's index)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    return out


_GATES: Dict[str, threading.Lock] = {}
_GATES_LOCK = threading.Lock()


def _replay_gate(device: torch.device) -> threading.Lock:
    """One sharded replay at a time on a device. Each holds S partial grids
    (S times the host route's [K, W] grids, ~5.4 GB at 8 shards and 16.7 M
    cells) and the serving executor runs queries on several workers; its
    fold and combine take tens of ms beside a query's seconds of host scan,
    so waiting here costs little and keeps the peak at one replay's."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _GATES_LOCK:
        return _GATES.setdefault(key, threading.Lock())


def _sharded_stats(keys, ts_rel, value, valid, *, window_ms, num_keys,
                   n_windows, mesh, combine, timings=None,
                   device=None) -> WindowedStats:
    S = shard_axis_size(mesh)
    first = mesh.device
    dev = first if device is None else device
    touched = _distinct([dev] + list(mesh.cards))
    K, W = int(num_keys), int(n_windows)
    t0 = _clock(touched, timings)
    cols = [_as_tensor(keys, torch.int32, dev),
            _as_tensor(ts_rel, torch.int32, dev),
            _as_tensor(value, torch.float32, dev),
            _as_tensor(valid, torch.bool, dev)]
    B = cols[0].numel()
    Bp = -(-max(B, 1) // S) * S
    if Bp > B:
        cols = [torch.cat([c, c.new_zeros(Bp - B)]) for c in cols]
    local = mesh.local_shards
    per = Bp // S
    if len(local) < S:
        # this process folds its own contiguous blocks only
        cols = [c[local[0] * per:(local[-1] + 1) * per] for c in cols]
    # each card folds its blocks: one pass, one segment-sum launch a card
    n = mesh.shards_per_card
    folds, marks = [], []
    for k, card in enumerate(mesh.cards):
        block = [c[k * n * per:(k + 1) * n * per].to(card) for c in cols]
        mark = _mark(card, timings)
        with on_card(card):
            parts = block_partials(*block, window_ms=window_ms, num_keys=K,
                                   n_windows=W, n_blocks=n, device=card)
        folds.append([p.view(n, K * W) for p in parts])
        marks.append((mark, _mark(card, timings)))
    t1 = _clock(touched, timings)
    if len(folds) == 1:
        parts = folds[0]
    else:
        # the partial grids meet on the first card in shard order
        parts = [torch.cat([fold[i].to(first) for fold in folds])
                 for i in range(4)]
    if len(local) < S:
        parts = _all_gather_blocks(parts, mesh)
    t2 = _clock(touched, timings)
    count, vsum, vmin, vmax = parts
    del parts, folds
    with on_card(first):
        if S == 1:   # a collective over one shard is the identity
            count, vsum, vmin, vmax = count[0], vsum[0], vmin[0], vmax[0]
        elif combine == "psum":
            count, vsum, vmin, vmax = _combine_psum(count, vsum, vmin, vmax)
        else:
            count, vsum, vmin, vmax = _combine_ring(count, vsum, vmin, vmax)
        out = grids_of(count, vsum, finalize_mean(count, vsum), vmin, vmax,
                       K, W)
    if torch.device(dev) != first:
        out = out.to(dev)
    t3 = _clock(touched, timings)
    if timings is not None:
        timings.update(fold_s=t1 - t0, gather_s=t2 - t1, combine_s=t3 - t2)
        if len(marks) > 1:
            timings["fold_s_by_card"] = [_elapsed(a, b) for a, b in marks]
    return out


def _mark(card: torch.device, timings):
    """A point on `card`'s current stream (an event on the card, the host
    clock elsewhere), or None when no split was asked for."""
    if timings is None:
        return None
    if card.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(card))
        return event
    return time.perf_counter()


def _elapsed(a, b) -> float:
    """Seconds between two `_mark`s (their cards already waited for)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def _clock(devices, timings) -> float:
    """Host clock for the optional split, after the devices are done."""
    if timings is None:
        return 0.0
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return time.perf_counter()


def _all_gather_blocks(parts, mesh: ShardMesh):
    """Every process's [S_local, C] partials, concatenated in shard order
    ([S, C] each) on this process's device. The gloo group carries host
    tensors: one all-gather of the four partials stacked."""
    import torch.distributed as dist

    stacked = torch.stack(parts).cpu()             # [4, S_local, C] int32
    got = [torch.empty_like(stacked) for _ in range(mesh.n_processes)]
    dist.all_gather(got, stacked, group=mesh.query_group)
    merged = torch.cat(got, dim=1).to(mesh.device)  # [4, S, C]
    return list(merged.unbind(0))
