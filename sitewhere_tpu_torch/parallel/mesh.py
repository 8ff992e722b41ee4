"""The shard axis: S shards of the device population on one torch device.

Counterpart of `sitewhere_tpu/parallel/mesh.py`. The reference's mesh is one
`shard` axis over S devices of one process (`make_mesh`), and each shard
owns the devices `d % S == s`. One H100 is one device, and NCCL does not put
two ranks of one communicator on one GPU, so in the port the S shards live
on ONE torch device:

  - Layout. Every sharded state leaf, per-device parameter row and routed
    blob carries a leading shard axis, `[S, D/S, ...]` / `[S, rows, B]`, in
    one tensor on the engine's device. That is the reference's canonical
    global layout of a sharded array, so checkpoints and `convert.py` see
    the same shapes.
  - Collectives become explicit tensor ops in a fixed order. `all_to_all`
    is a permute of `[S_src, rows, S_dst, C]` to `[S_dst, rows, S_src, C]`
    (source-major, the flat batch's arrival order); `psum` a sum over the
    shard axis in shard order (int32 sums, so the order cannot change a
    bit); `axis_index` the shard's position in the axis.
  - The step (parallel/engine.py) runs the single engine's `process_batch`
    on shard s's views, in a loop over s, with the routing prologue and the
    sums around it; on the card the whole loop is one captured CUDA graph
    per static configuration.

`make_mesh` never substitutes CPU devices for a missing card: it defaults to
"cuda" and raises without one. Multi-process meshes (several hosts) are not
part of this object: `ShardMesh` is single-controller by construction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device

SHARD_AXIS = "shard"


class ShardMesh:
    """S shards on one torch device. `shape` answers `{SHARD_AXIS: S}` as a
    JAX mesh's does."""

    __slots__ = ("n_shards", "device")

    def __init__(self, n_shards: int, device: torch.device):
        if int(n_shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{n_shards}")
        self.n_shards = int(n_shards)
        self.device = device

    @property
    def shape(self):
        return {SHARD_AXIS: self.n_shards}

    @property
    def size(self) -> int:
        return self.n_shards

    @property
    def devices(self) -> np.ndarray:
        """The device of each shard, as a JAX mesh's `devices` array."""
        out = np.empty(self.n_shards, dtype=object)
        out[:] = [self.device] * self.n_shards
        return out

    def __repr__(self) -> str:
        return f"ShardMesh(n_shards={self.n_shards}, device={self.device})"


def make_mesh(n_shards: Optional[int] = None,
              device: DeviceLike = "cuda") -> ShardMesh:
    """A mesh of `n_shards` shards (default 1) on `device` ("cuda" unless
    the caller asks for the CPU; raises without a CUDA device)."""
    return ShardMesh(1 if n_shards is None else n_shards,
                     resolve_device(device))


def shard_axis_size(mesh: ShardMesh) -> int:
    return mesh.shape[SHARD_AXIS]
