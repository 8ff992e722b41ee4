"""Builds the port's CUDA C++ kernels at first use and loads them with ctypes.

Each source `sitewhere_tpu_torch/csrc/<name>.cu` has a plain C interface and
compiles on its own with nvcc into `sitewhere_tpu_torch/_build/`
(git-ignored), under a file name keyed by a hash of the source and the
flags: an edited source rebuilds, an unchanged one loads the library built
before. nvcc's output (ptxas register and shared-memory report included)
is kept beside the library as `<library>.log`.

Nothing here runs at import time, and nothing falls back: a missing nvcc,
a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def nvcc_command(source: Path, output: Path) -> List[str]:
    """The nvcc command line that builds `source` into the library
    `output`."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives (hash-keyed)."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named kernel whose library is missing, all nvcc
    processes started together; returns name -> library path."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".so.log"), "w")
        procs[name] = (
            subprocess.Popen(nvcc_command(CSRC_DIR / f"{name}.cu", tmp),
                             stdout=log, stderr=subprocess.STDOUT),
            tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{build_log(name)[-4000:]}")
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for the current build of csrc/<name>.cu ("" if it was
    not built on this checkout)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
