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
"cuda" and raises without one.

A mesh may span P processes (parallel/distributed.py `make_global_mesh`
under an initialized `torch.distributed` group). The reference lists process
0's devices first, so process p owns the contiguous block of shards
`[p*S/P, (p+1)*S/P)` (`local_shards`), stacked `[S_local, D/S, ...]` on its
own torch device; global device d still lives on shard `d % S` at local row
`d // S`. `process_of_shard` is the counterpart of `d.process_index` over the
reference's `mesh.devices.flat`. The collectives between processes go over
the gloo groups the mesh carries: `step_group` for the step loop (its stop
vote and the step's int32 sums), `query_group` for window-sharded analytics,
so that a query and a tick never pair their collectives across processes.
A single-process mesh has one process, every shard local and no groups.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device

SHARD_AXIS = "shard"


class ShardMesh:
    """S shards, this process's block of them on one torch device. `shape`
    answers `{SHARD_AXIS: S}` as a JAX mesh's does."""

    __slots__ = ("n_shards", "device", "n_processes", "process_index",
                 "step_group", "query_group")

    def __init__(self, n_shards: int, device: torch.device,
                 n_processes: int = 1, process_index: int = 0,
                 step_group=None, query_group=None):
        if int(n_shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{n_shards}")
        if int(n_shards) % int(n_processes):
            raise ValueError(f"{n_shards} shards do not split evenly over "
                             f"{n_processes} processes")
        if not 0 <= int(process_index) < int(n_processes):
            raise ValueError(f"process {process_index} of {n_processes}")
        self.n_shards = int(n_shards)
        self.device = device
        self.n_processes = int(n_processes)
        self.process_index = int(process_index)
        self.step_group = step_group
        self.query_group = query_group

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

    @property
    def shape(self):
        return {SHARD_AXIS: self.n_shards}

    @property
    def size(self) -> int:
        return self.n_shards

    @property
    def devices(self) -> np.ndarray:
        """The device of each shard, as a JAX mesh's `devices` array (on a
        multi-process mesh this process's device stands for every shard:
        torch names no device of another process)."""
        out = np.empty(self.n_shards, dtype=object)
        out[:] = [self.device] * self.n_shards
        return out

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.n_processes}"
                 if self.is_multiprocess else "")
        return (f"ShardMesh(n_shards={self.n_shards}, device={self.device}"
                f"{procs})")


def make_mesh(n_shards: Optional[int] = None,
              device: DeviceLike = "cuda") -> ShardMesh:
    """A mesh of `n_shards` shards (default 1) on `device` ("cuda" unless
    the caller asks for the CPU; raises without a CUDA device)."""
    return ShardMesh(1 if n_shards is None else n_shards,
                     resolve_device(device))


def shard_axis_size(mesh: ShardMesh) -> int:
    return mesh.shape[SHARD_AXIS]
