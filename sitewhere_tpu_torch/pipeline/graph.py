"""The step as one CUDA graph per static configuration.

Counterpart of the reference engine's compile seam
(`sitewhere_tpu/pipeline/engine.py:457-499`, `_step_static_config`,
`_build_step_blob`, `_ensure_step_current`): the reference dispatches the
whole step as one XLA program and retraces only when a trace-time static
changes. Here the unit of dispatch is a captured CUDA graph, one per
`step_key`: the four stage flags of the reference's static config
(programs enabled, program node limit, models enabled, actuation enabled)
and the wire blob's shape (the three layouts). Every table is
capacity-sized, so a params refresh copies into the captured buffers and
never recaptures, as a rule edit reuses the reference's compiled program.

The engine keeps the invariants a graph relies on (pipeline/engine.py):
  - the step's state lives in engine-owned static buffers, updated in
    place by the step (`commit`), the counterpart of donation: a path that
    would replace a buffer copies into it instead, or drops the graphs;
  - the first step of a key runs eagerly on the live buffers and its
    result is kept; the capture follows and executes nothing, so no step
    is applied twice (the stateful slabs update in place);
  - each replay copies its outputs out of the graph's memory (one
    device-to-device copy of `OutputArena.nbytes`), because a graph's
    outputs are overwritten by its next replay while the pipelined feeder
    keeps several steps in flight.

The blob input: one graph per key reads one static blob buffer, and each
replay first copies the step's blob into it on the compute stream — from
pinned host memory for a serial submit, from the staging ring's device
slot for a staged one. One graph per ring slot would save that copy (at
most 2.6 MB device-to-device at B=131072, a few microseconds of HBM time)
but capture each key `h2d_buffer_depth` times.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from sitewhere_tpu_torch.ops.geofence_kernel import points_in_zones_kernel
from sitewhere_tpu_torch.pipeline.step import ProcessOutputs
from sitewhere_tpu_torch.tree import tree_leaves

# the hand-written kernels a step can launch: name -> wrapper (each counts
# its own launches and its captures)
STEP_KERNELS = {"points_in_zones": points_in_zones_kernel}
_ALIGN = 16


def step_key(flags: Dict, blob_shape) -> Tuple:
    """The static configuration a captured step is valid for."""
    return (bool(flags["programs_enabled"]), int(flags["program_node_limit"]),
            bool(flags["models_enabled"]), bool(flags["actuation_enabled"]),
            tuple(blob_shape))


def same_layout(a, b) -> bool:
    """True if two trees of tensors have the same leaf shapes and dtypes."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def commit(static, new) -> None:
    """Copy every leaf of `new` into the matching leaf of `static` (same
    tree), skipping leaves that already are the static tensor."""
    for dst, src in zip(tree_leaves(static), tree_leaves(new)):
        if src is not dst:
            dst.copy_(src)


class OutputArena:
    """The layout of one step's ProcessOutputs in a flat byte buffer, each
    field at a 16-byte aligned offset, so that a step's outputs move in
    one copy and come back as typed views."""

    def __init__(self, like: ProcessOutputs):
        self.fields = []
        offset = 0
        for f in dataclasses.fields(like):
            t = getattr(like, f.name)
            nbytes = t.numel() * t.element_size()
            self.fields.append((f.name, t.dtype, tuple(t.shape), offset,
                                nbytes))
            offset += -(-nbytes // _ALIGN) * _ALIGN
        self.nbytes = offset

    def views(self, flat: torch.Tensor) -> ProcessOutputs:
        return ProcessOutputs(**{
            name: flat[off:off + n].view(dtype).view(shape)
            for name, dtype, shape, off, n in self.fields})

    def store(self, flat: torch.Tensor, outputs: ProcessOutputs) -> None:
        out = self.views(flat)
        for name, *_ in self.fields:
            getattr(out, name).copy_(getattr(outputs, name))


class CapturedStep:
    """One key's captured step: the graph, the static blob it reads, the
    static output buffer it writes, and the kernel launches one replay
    makes (`kernel_launches`, name -> count)."""

    def __init__(self, graph, static_blob, arena, out_flat,
                 kernel_launches: Dict[str, int], pool_handle):
        self.graph = graph
        self.static_blob = static_blob
        self.arena = arena
        self.out_flat = out_flat
        self.kernel_launches = kernel_launches
        self.pool_handle = pool_handle

    def replay(self, blob) -> ProcessOutputs:
        """Copy `blob` (host or device, the key's shape) into the static
        blob, replay on the current stream, and return a copy of the
        outputs. Returns without waiting for the card."""
        if not isinstance(blob, torch.Tensor):
            blob = torch.from_numpy(blob)
        self.static_blob.copy_(blob, non_blocking=True)
        self.graph.replay()
        return self.arena.views(self.out_flat.clone())

    def pool_bytes(self) -> int:
        """Device bytes the graph's private memory pool holds (the
        intermediates of the step)."""
        return sum(int(seg["total_size"])
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self.pool_handle))


def capture_step(step_fn: Callable[[torch.Tensor], ProcessOutputs],
                 blob_like: torch.Tensor, outputs_like: ProcessOutputs
                 ) -> CapturedStep:
    """Capture `step_fn(static_blob)` into a CUDA graph on `blob_like`'s
    card. Nothing runs: the graph is recorded, with the outputs copied into
    a static buffer laid out after `outputs_like`. Other threads may keep
    using the card meanwhile (thread-local capture mode). A failed capture
    raises."""
    device = blob_like.device
    with torch.cuda.device(device):
        static_blob = torch.empty_like(blob_like)
        arena = OutputArena(outputs_like)
        out_flat = torch.empty(arena.nbytes, dtype=torch.uint8,
                               device=device)
        before = {name: w.captures for name, w in STEP_KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            arena.store(out_flat, step_fn(static_blob))
    launches = {name: w.captures - before[name]
                for name, w in STEP_KERNELS.items()}
    return CapturedStep(graph, static_blob, arena, out_flat, launches,
                        graph.pool())
