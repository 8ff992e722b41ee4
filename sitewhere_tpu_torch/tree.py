"""Leaf mapping over (nested) dataclasses of arrays — the port's stand-in for
JAX's pytree utilities, used to move tables and state between numpy, the
CPU and the card."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable, obj):
    """A copy of dataclass `obj` with `fn` applied to every non-dataclass
    field (recursing into nested dataclasses)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return fn(obj)


def tree_leaves(obj) -> list:
    """The non-dataclass fields of dataclass `obj`, depth first, in field
    order."""
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
