"""The shard axis: S shards of the device population over K cards.

Counterpart of `sitewhere_tpu/parallel/mesh.py`. The reference's mesh is one
`shard` axis over S devices of one process (`make_mesh` over
`jax.devices()`), and each shard owns the devices `d % S == s`. The port
lays the axis out in card blocks:

  - Blocks. A mesh of S shards over K cards (K divides S) puts shard s on
    card `s // (S/K)`: card k holds the contiguous block of shards
    `[k*S/K, (k+1)*S/K)`, every sharded state leaf, per-device parameter
    row and routed blob of the block stacked on a leading axis, `[S/K,
    D/S, ...]` / `[S/K, rows, B]`, in one tensor on that card. K = S is
    the reference's layout, one shard a device; K = 1 puts the whole axis
    on one card. The canonical global layout `[S, D/S, ...]` (checkpoints,
    `convert.py`) is the blocks concatenated in card order.
  - Collectives become explicit tensor ops in a fixed order. `all_to_all`
    is a permute of `[S_src, rows, S_dst, C]` to `[S_dst, rows, S_src, C]`
    (source-major, the flat batch's arrival order), whose cross-card part
    is a copy between cards (ops/route.py); `psum` a sum over the shard
    axis in shard order (int32 sums, so the order cannot change a bit):
    each card sums its block, the K partials meet on the first card;
    `axis_index` the shard's position in the axis.
  - The step (parallel/engine.py) runs the single engine's `process_batch`
    on each shard's views, in a loop over a card's block; on the card each
    block's loop is one captured CUDA graph per static configuration, one
    a card, replayed from one thread so that the cards run at once.

`make_mesh` never substitutes CPU devices for a missing card: it defaults to
"cuda", spreads over every visible card, and raises without one. An
explicit `devices` list names one card a block, and entries may repeat
(the CPU tests use `("cpu",) * K`; several blocks on one card run the
multi-card step on one device).

A mesh may span P processes (parallel/distributed.py `make_global_mesh`
under an initialized `torch.distributed` group). The reference lists process
0's devices first, so process p owns the contiguous block of shards
`[p*S/P, (p+1)*S/P)` (`local_shards`), stacked `[S_local, D/S, ...]` on its
one card; global device d still lives on shard `d % S` at local row
`d // S`. `process_of_shard` is the counterpart of `d.process_index` over the
reference's `mesh.devices.flat`. The collectives between processes go over
the gloo groups the mesh carries: `step_group` for the step loop (its stop
vote and the step's int32 sums), `query_group` for window-sharded analytics,
so that a query and a tick never pair their collectives across processes.
A single-process mesh has one process, every shard local and no groups.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device

SHARD_AXIS = "shard"


def _indexed(device: torch.device) -> torch.device:
    """`device` with its card index spelled out: a bare "cuda" names the
    calling thread's current card, which a kernel wrapper or a device guard
    may move."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ShardMesh:
    """S shards; this process's block of them over its cards, one block a
    card (`cards`). `shape` answers `{SHARD_AXIS: S}` as a JAX mesh's
    does."""

    __slots__ = ("n_shards", "cards", "n_processes", "process_index",
                 "step_group", "query_group")

    def __init__(self, n_shards: int, device=None,
                 n_processes: int = 1, process_index: int = 0,
                 step_group=None, query_group=None,
                 cards: Optional[Sequence[torch.device]] = None):
        if int(n_shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{n_shards}")
        if int(n_shards) % int(n_processes):
            raise ValueError(f"{n_shards} shards do not split evenly over "
                             f"{n_processes} processes")
        if not 0 <= int(process_index) < int(n_processes):
            raise ValueError(f"process {process_index} of {n_processes}")
        if cards is None:
            cards = (device,)
        cards = tuple(torch.device(c) for c in cards)
        if not cards:
            raise ValueError("a mesh needs at least one card")
        n_local = int(n_shards) // int(n_processes)
        if n_local % len(cards):
            raise ValueError(
                f"{len(cards)} cards do not divide the {n_local} shards "
                f"{'of this process ' if int(n_processes) > 1 else ''}"
                f"(each card holds S/K shards)")
        if int(n_processes) > 1 and len(cards) > 1:
            raise ValueError("a process of a multi-process mesh holds one "
                             "card")
        self.n_shards = int(n_shards)
        self.cards: Tuple[torch.device, ...] = cards
        self.n_processes = int(n_processes)
        self.process_index = int(process_index)
        self.step_group = step_group
        self.query_group = query_group

    @property
    def device(self) -> torch.device:
        """The first card: where the shard sums meet and the mesh query's
        partial grids combine."""
        return self.cards[0]

    @property
    def n_cards(self) -> int:
        return len(self.cards)

    @property
    def shards_per_card(self) -> int:
        return len(self.local_shards) // len(self.cards)

    @property
    def is_multiprocess(self) -> bool:
        return self.n_processes > 1

    @property
    def process_of_shard(self) -> np.ndarray:
        """The process owning each shard (contiguous blocks, process 0's
        first)."""
        return np.repeat(np.arange(self.n_processes, dtype=np.int32),
                         self.n_shards // self.n_processes)

    @property
    def local_shards(self) -> List[int]:
        """Global indices of the shards this process holds, ascending."""
        per = self.n_shards // self.n_processes
        return list(range(self.process_index * per,
                          (self.process_index + 1) * per))

    def card_of_shard(self, shard: int) -> int:
        """The block (index into `cards`) holding local shard `shard`."""
        first = self.local_shards[0]
        if not first <= int(shard) <= self.local_shards[-1]:
            raise ValueError(f"shard {shard} is not one of this process's "
                             f"{self.local_shards}")
        return (int(shard) - first) // self.shards_per_card

    def shards_on(self, card: int) -> List[int]:
        """Global indices of the shards block `card` holds, ascending."""
        per = self.shards_per_card
        first = self.local_shards[0] + int(card) * per
        return list(range(first, first + per))

    @property
    def shape(self):
        return {SHARD_AXIS: self.n_shards}

    @property
    def size(self) -> int:
        return self.n_shards

    @property
    def devices(self) -> np.ndarray:
        """The card of each shard, as a JAX mesh's `devices` array (on a
        multi-process mesh this process's card stands for every shard:
        torch names no device of another process)."""
        out = np.empty(self.n_shards, dtype=object)
        if self.is_multiprocess:
            out[:] = [self.device] * self.n_shards
        else:
            per = self.shards_per_card
            out[:] = [self.cards[s // per] for s in range(self.n_shards)]
        return out

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.n_processes}"
                 if self.is_multiprocess else "")
        where = (f"device={self.device}" if self.n_cards == 1 else
                 f"cards=({', '.join(map(str, self.cards))})")
        return f"ShardMesh(n_shards={self.n_shards}, {where}{procs})"


def make_mesh(n_shards: Optional[int] = None,
              device: DeviceLike = "cuda",
              devices: Optional[Sequence[DeviceLike]] = None) -> ShardMesh:
    """A mesh of `n_shards` shards (default 1) in card blocks.

    `devices` names one card a block (entries may repeat; K = its length
    must divide S). Without it, `device` "cuda" (the default) spreads the
    shards over every visible card, K = min(S, visible cards), and raises
    without a CUDA device or when K does not divide S; any other `device`
    ("cpu", "cuda:1") holds every shard in one block."""
    S = 1 if n_shards is None else int(n_shards)
    if devices is not None:
        cards = tuple(_indexed(resolve_device(d)) for d in devices)
        if not cards:
            raise ValueError("a mesh needs at least one card")
        if S % len(cards):
            raise ValueError(f"{len(cards)} cards do not divide {S} shards "
                             f"(each card holds S/K shards)")
        return ShardMesh(S, cards=cards)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        K = min(S, visible)
        if K > 1:
            if S % K:
                raise ValueError(
                    f"{S} shards over {visible} visible cards: {K} cards "
                    f"do not divide {S} shards (pass device='cuda:0' for "
                    f"one card, or devices=... for chosen cards)")
            return ShardMesh(S, cards=tuple(torch.device("cuda", k)
                                            for k in range(K)))
    return ShardMesh(S, cards=(_indexed(dev),))


def shard_axis_size(mesh: ShardMesh) -> int:
    return mesh.shape[SHARD_AXIS]
