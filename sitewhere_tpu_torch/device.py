"""Device selection for the port's entry points.

Everything that allocates device tensors takes a `device` argument that
defaults to "cuda". There is no automatic fallback: asking for CUDA on a
machine without a CUDA device raises, so a run that meant to measure the
card can never silently measure the CPU instead. Tests pass "cpu".
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device`; raises RuntimeError for a CUDA device when
    CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' explicitly to run on the CPU")
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether `a` and `b` name one device ("cuda" is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == \
        (current if b.index is None else b.index)


_local = threading.local()


@contextlib.contextmanager
def own_stream(device: torch.device) -> Iterator[None]:
    """Run the enclosed work on the calling thread's own CUDA stream of
    `device` (made at first use; a no-op off the card). PyTorch's streams do
    not synchronise with the legacy default stream, so work and waits in
    here (a query's copies and syncs) neither wait for nor hold up the work
    other threads queue on their streams, the engine's step included.
    The stream comes from PyTorch's pool (32 a priority, round robin), so
    past 32 threads two may share one; captures record on a stream of
    their own (pipeline/graph.py `capture_stream`)."""
    if device.type != "cuda":
        yield
        return
    streams = _local.__dict__.setdefault("streams", {})
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(index)
    with torch.cuda.stream(stream):
        yield


def on_card(device: torch.device):
    """`device` as the calling thread's current card for the enclosed work
    (a no-op off the card): work of one card carries that card's index,
    whatever card a kernel library or an earlier block left current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
