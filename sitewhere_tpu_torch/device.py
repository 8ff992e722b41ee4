"""Device selection for the port's entry points.

Everything that allocates device tensors takes a `device` argument that
defaults to "cuda". There is no automatic fallback: asking for CUDA on a
machine without a CUDA device raises, so a run that meant to measure the
card can never silently measure the CPU instead. Tests pass "cpu".
"""

from __future__ import annotations

from typing import Union

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
