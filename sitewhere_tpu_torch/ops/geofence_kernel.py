"""Geofence containment on the card: wrapper of the CUDA kernel
`csrc/geofence.cu` (replaces the TPU kernel
`sitewhere_tpu/ops/pallas_geofence.py:points_in_zones_pallas`).

`points_in_zones_kernel(lat, lon, vertices)` computes the same bool [B, Z]
as the plain `ops.geofence.points_in_zones`, bit for bit. On CPU tensors it
IS the plain version; on CUDA tensors it launches the kernel (built at first
use, see ops/cuda_build.py) once, on the current stream, without
synchronising, or raises — it never takes the plain path for a CUDA tensor.
The kernel sizes its own grid and shared memory (one persistent block per
SM, zones walked in chunks when the table is large); `launch_plan` reports
the choice.
`points_in_zones_kernel.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from sitewhere_tpu_torch.ops import cuda_build
from sitewhere_tpu_torch.ops.geofence import points_in_zones

KERNEL_SOURCE = "geofence"


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.swt_points_in_zones
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swt_error_string.argtypes = [ctypes.c_int]
        lib.swt_error_string.restype = ctypes.c_char_p
        lib.swt_points_in_zones_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.swt_points_in_zones_plan.restype = ctypes.c_int
    return lib


def _check(lat: torch.Tensor, lon: torch.Tensor,
           vertices: torch.Tensor) -> None:
    for name, t in (("lat", lat), ("lon", lon), ("vertices", vertices)):
        if t.device != lat.device:
            raise ValueError(f"{name} is on {t.device}, lat on {lat.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lat.dim() != 1 or lon.shape != lat.shape:
        raise ValueError(f"lat/lon must both be [B], got {tuple(lat.shape)} "
                         f"and {tuple(lon.shape)}")
    if vertices.dim() != 3 or vertices.shape[2] != 2:
        raise ValueError(f"vertices must be [Z, V, 2], got "
                         f"{tuple(vertices.shape)}")
    if max(lat.shape[0], vertices.shape[0], vertices.shape[1]) >= 2 ** 31:
        raise ValueError("B, Z and V must each be below 2^31")


def points_in_zones_kernel(lat: torch.Tensor, lon: torch.Tensor,
                           vertices: torch.Tensor) -> torch.Tensor:
    """Even-odd containment of points [B] in polygons [Z, V, 2] -> bool
    [B, Z]; see the module docstring for where it runs."""
    if lat.device.type == "cpu":
        return points_in_zones(lat, lon, vertices)
    _check(lat, lon, vertices)
    if lat.device.type != "cuda":
        raise ValueError(f"no geofence kernel for device {lat.device}")
    B, (Z, V) = lat.shape[0], vertices.shape[:2]
    out = torch.empty((B, Z), dtype=torch.bool, device=lat.device)
    if B == 0 or Z == 0:
        return out
    lib = _library()
    rc = lib.swt_points_in_zones(
        lat.data_ptr(), lon.data_ptr(), vertices.data_ptr(), out.data_ptr(),
        B, Z, V, lat.device.index,
        torch.cuda.current_stream(lat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"geofence kernel launch failed: "
            f"{lib.swt_error_string(rc).decode()} (cudaError {rc})")
    points_in_zones_kernel.launches += 1
    return out


points_in_zones_kernel.launches = 0


def launch_plan(B: int, Z: int, V: int, device: int = 0) -> dict:
    """How the kernel launches for these sizes on CUDA card `device`: zones
    per chunk, points per tile, dynamic shared bytes, blocks per SM, grid,
    and where the zone table is read from ("registers": staged, V <= 32
    vertex y's in registers; "shared": staged; "global": zones too large to
    stage).
    For reports; launches nothing."""
    lib = _library()
    plan = (ctypes.c_int * 6)()
    rc = lib.swt_points_in_zones_plan(B, Z, V, device, plan)
    if rc != 0:
        raise RuntimeError(f"geofence kernel plan failed: "
                           f"{lib.swt_error_string(rc).decode()}")
    out = dict(zip(("zones_per_chunk", "points_per_tile", "shared_bytes",
                    "blocks_per_sm", "grid"), plan))
    out["zone_table"] = ("registers", "registers", "shared", "global")[plan[5]]
    return out
