"""Leaf mapping over (nested) dataclasses of arrays — the port's stand-in for
JAX's pytree utilities, used to move tables and state between numpy, the
CPU and the card — and `Blocks`, the per-card blocks of one such tree on a
mesh over several cards (parallel/mesh.py)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


class Blocks(tuple):
    """The per-card blocks of one tree (state group, params): block k lives
    on card k, its sharded leaves stacked `[S/K, ...]`. `tree_map` maps
    each block and `tree_leaves` lists every block's leaves in card order,
    so `commit` and `same_layout` (pipeline/graph.py) work block by block.
    A field read answers the `BlockField` of the blocks' fields."""

    __slots__ = ()

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return BlockField(getattr(block, name) for block in self)


class BlockField(tuple):
    """One field of every block, in card order: the per-card parts of a
    `[S, ...]` tensor split on its leading axis. Reads gather to the host
    (`cpu`), writes scatter from it (`copy_`)."""

    __slots__ = ()

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(int(t.shape[0]) for t in self),)
                          + tuple(self[0].shape[1:]))

    def cpu(self) -> torch.Tensor:
        """The parts concatenated on the host, `[S, ...]` (a copy)."""
        return torch.cat([t.cpu() for t in self])

    def copy_(self, src) -> "BlockField":
        """Copy a `[S, ...]` tensor into the parts, each its rows."""
        src = torch.as_tensor(src)
        start = 0
        for t in self:
            t.copy_(src[start:start + t.shape[0]])
            start += t.shape[0]
        return self


def split_blocks(tree, sizes):
    """The blocks of a host tree whose leaves are stacked `[S, ...]`: block
    k takes `sizes[k]` rows of every leaf, in order (views)."""
    out, start = [], 0
    for n in sizes:
        out.append(tree_map(lambda a, s=start, n=n: a[s:s + n], tree))
        start += n
    return Blocks(out)


def tree_map(fn: Callable, obj):
    """A copy of dataclass `obj` with `fn` applied to every non-dataclass
    field (recursing into nested dataclasses and into the blocks of a
    `Blocks`)."""
    if isinstance(obj, Blocks):
        return Blocks(tree_map(fn, block) for block in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return fn(obj)


def tree_leaves(obj) -> list:
    """The non-dataclass fields of dataclass `obj`, depth first, in field
    order (a `Blocks`: every block's, in card order)."""
    if isinstance(obj, Blocks):
        return [leaf for block in obj for leaf in tree_leaves(block)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in tree_leaves(getattr(obj, f.name))]
    return [obj]


def to_device(obj, device):
    """Every leaf as a torch tensor on `device` (array leaves are copied and
    keep their dtype: int32 stays int32, bool stays bool)."""
    return tree_map(lambda a: (a if isinstance(a, torch.Tensor)
                               else torch.from_numpy(np.array(a)))
                    .to(device), obj)
