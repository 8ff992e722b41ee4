"""sitewhere_tpu_torch: the IoT event platform's hot path on PyTorch + CUDA.

A port of `sitewhere_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays the reference; this package keeps its layout and names
(`model/`, `registry/`, `ops/`, `pipeline/`) so every module has a visible
counterpart, and imports nothing of it: the host-side pieces it needs
(interners, wire packer, lane decoder) are its own copies.

It covers the single-device step — wire unpack, validation, threshold and
geofence rules, the device-state fold, the stateful stages (rule programs,
anomaly models, actuation policies), alert and command lanes, alert
materialization and the presence sweep — with the geofence containment as
a hand-written Hopper kernel (`csrc/geofence.cu`).

Entry points run on `device="cuda"` unless the caller asks for the CPU;
without a CUDA device they raise (`device.resolve_device`), they never fall
back to the CPU on their own.
"""

from sitewhere_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
