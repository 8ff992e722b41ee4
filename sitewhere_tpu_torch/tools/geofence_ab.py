"""Times builds of the geofence kernel's source against each other on one
card, in turns.

    python3 -m sitewhere_tpu_torch.tools.geofence_ab [NAME=SOURCE.cu ...]

Run it from the repo root: it takes its worlds and timers from
chip_smoke.py. Each SOURCE is a version of csrc/geofence.cu with the same C
interface, for example an earlier commit's (`git show
<commit>:sitewhere_tpu_torch/csrc/geofence.cu > parent.cu`) or a text edit
of the current one; the current csrc/geofence.cu always runs, as
"current". All are built together with the port's nvcc flags. On
chip_smoke's adversarial fixture and its KERNEL_WORLDS each build is held
bit for bit against the plain version; on the worlds each is then timed in
turns, in the order given and then in reverse, per call
(chip_smoke.time_cuda: the kernels' `ms`) and queued
(chip_smoke.time_cuda_queued: their `queued_ms`). Every build is called
the same way, straight through its C entry, with no launch counter. Prints
one JSON line per world, then the card line; exits 1 if a build differs
from the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from sitewhere_tpu_torch.ops import cuda_build


def _build(sources: dict) -> dict:
    """name -> library, every nvcc started together; ptxas lines printed."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
        library = cuda_build.BUILD_DIR / f"ab-{name}-{digest}.so"
        procs[name] = (library, subprocess.Popen(
            cuda_build.nvcc_command(Path(source), library),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libraries = {}
    for name, (library, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n"
                               f"{out[-4000:]}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
        libraries[name] = library
    return libraries


def _entry(library: Path):
    """points_in_zones of one build, as a function of CUDA tensors."""
    fn = ctypes.CDLL(str(library)).swt_points_in_zones
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(lat, lon, verts):
        out = torch.empty((lat.shape[0], verts.shape[0]), dtype=torch.bool,
                          device=lat.device)
        rc = fn(lat.data_ptr(), lon.data_ptr(), verts.data_ptr(),
                out.data_ptr(), lat.shape[0], verts.shape[0],
                verts.shape[1], lat.device.index,
                torch.cuda.current_stream(lat.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{library.name}: cudaError {rc}")
        return out
    return run


def main(argv=None) -> int:
    import chip_smoke as cs
    from sitewhere_tpu_torch.ops.geofence import points_in_zones

    if not torch.cuda.is_available():
        print("geofence_ab: no CUDA device available", file=sys.stderr)
        return 2
    sources = {"current": cuda_build.CSRC_DIR / "geofence.cu"}
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, source = arg.partition("=")
        sources[name] = Path(source)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fns = {name: _entry(lib) for name, lib in _build(sources).items()}
    order = list(fns) + list(fns)[::-1]
    worlds = [("adversarial", None, None)] + [
        (world, cs.random_world(seed, cs.BATCH, Z, V, box=cs.LAT_LON_BOX,
                                radius=radius), True)
        for world, seed, Z, V, radius in cs.KERNEL_WORLDS]
    failed = False
    for world, arrays, timed in worlds:
        if arrays is None:
            arrays = cs.adversarial_world()
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        ref = points_in_zones(*args)
        row = {"world": world, "B": args[0].shape[0],
               "Z": args[2].shape[0], "V": args[2].shape[1],
               "mismatches": {n: int((f(*args) != ref).sum())
                              for n, f in fns.items()}}
        failed |= any(row["mismatches"].values())
        if timed:
            ms = {n: [] for n in fns}
            queued = {n: [] for n in fns}
            for n in order:
                ms[n].append(cs.time_cuda(lambda: fns[n](*args)))
                queued[n].append(cs.time_cuda_queued(lambda: fns[n](*args)))
            row["ms_turns"], row["queued_ms_turns"] = ms, queued
            row["ms"] = {n: statistics.mean(t) for n, t in ms.items()}
            row["queued_ms"] = {n: statistics.mean(t)
                                for n, t in queued.items()}
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
