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


_local = threading.local()


@contextlib.contextmanager
def own_stream(device: torch.device) -> Iterator[None]:
    """Run the enclosed work on the calling thread's own CUDA stream of
    `device` (made at first use; a no-op off the card). PyTorch's streams do
    not synchronise with the legacy default stream, so work and waits in
    here (a query's copies and syncs) neither wait for nor hold up the work
    other threads queue on their streams, the engine's step included."""
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
