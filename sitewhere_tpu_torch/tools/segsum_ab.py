"""Times builds of the segment-sum kernel's source against each other on one
card, in turns.

    python3 -m sitewhere_tpu_torch.tools.segsum_ab [NAME=SOURCE.cu[:int64] ...]

Run it from the repo root: it takes its fixtures and timers from
chip_smoke.py. Each SOURCE is a version of csrc/segsum.cu, for example an
earlier commit's (`git show <commit>:sitewhere_tpu_torch/csrc/segsum.cu >
.chipcheck/parent.cu`); a source whose name ends in `:int64` has the older
C interface (int64 offsets; no offset width, row count or scratch). The current
csrc/segsum.cu always runs twice: as "current" with int32 offsets, as the
port passes them, and as "current_int64" with int64 offsets. All are built
together with the port's nvcc flags. On three inputs, each build is held
bit for bit against the plain version and then timed in turns, in the
order given and then in reverse, per call (chip_smoke.time_cuda) and
queued (chip_smoke.time_cuda_queued), beside `index_add_` (one PyTorch call
for the same sums in no fixed order), the byte bound of the int32-offset
inputs and the chain floor of the longest segment:
  - "query": the sum grid of chip_smoke phase 9's monolithic query in
    shape: 131072 keys x 128 one-minute windows, 77 windows each holding
    78,640 rows of keys drawn from 100,000 devices (~6.06 M rows, most
    cells 0-3 rows);
  - "hot_cell": the adversarial window fixture's sum grid
    (chip_smoke.adversarial_window_rows with its 100,000-row cell), taken
    from the port's `windowed_stats` on the card;
  - "chatty": 256 cells of ~3,700 rows side by side (hourly windows of 1 Hz
    devices, phase 9's chatty query in shape).
Prints one JSON line per input, then the card line; exits 1 if a build
differs from the plain version.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from sitewhere_tpu_torch.ops import cuda_build
from sitewhere_tpu_torch.tools.geofence_ab import _build


def _entry(library: Path, int64_only: bool, offset_dtype):
    """segment_row_sum of one build, as a function of CUDA tensors. A build
    with the older interface (`int64_only`) takes int64 offsets and no
    offset width, row count or scratch."""
    lib = ctypes.CDLL(str(library))
    fn = lib.swt_segment_row_sum
    if int64_only:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.swt_segsum_scratch_bytes.argtypes = [ctypes.c_longlong]
        lib.swt_segsum_scratch_bytes.restype = ctypes.c_longlong
    fn.restype = ctypes.c_int

    def run(values, offsets):
        offsets = offsets.to(offset_dtype)
        out = torch.empty(offsets.numel() - 1, dtype=torch.float32,
                          device=values.device)
        extra = []
        if not int64_only:
            n = values.numel()
            scratch = torch.empty(lib.swt_segsum_scratch_bytes(n),
                                  dtype=torch.uint8, device=values.device)
            extra = [offsets.element_size(), n, scratch.data_ptr()]
        rc = fn(values.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                offsets.numel() - 1, *extra, values.device.index,
                torch.cuda.current_stream(values.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{library.name}: cudaError {rc}")
        return out
    return run


def _from_counts(counts: torch.Tensor, seed: int):
    """(values f32, offsets int32) for segments of these row counts."""
    gen = torch.Generator(device=counts.device).manual_seed(seed)
    n = int(counts.sum())
    values = torch.randn(n, generator=gen, device=counts.device) * 30.0
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                          device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    return values, offsets


def query_inputs(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys, windows = 131072, 128
    cells = torch.cat([
        torch.randint(1, 100_001, (78_640,), generator=gen, device=dev)
        * windows + w for w in range(77)])
    counts = torch.bincount(cells, minlength=keys * windows)
    return _from_counts(counts, seed)


def chatty_inputs(dev, seed):
    rng = np.random.default_rng(seed)
    counts = torch.from_numpy(rng.poisson(3686, 256)).to(dev)
    return _from_counts(counts, seed)


def hot_cell_inputs(dev):
    import chip_smoke as cs
    import sitewhere_tpu_torch.analytics.windows as windows_mod

    keys, ts, value, valid = cs.adversarial_window_rows(
        cs.SEED + 90, cs.ADVERSARIAL_ROWS, cs.ADVERSARIAL_KEYS,
        cs.READ_WINDOWS, cs.READ_WINDOW_MS, hot_rows=cs.HOT_ROWS)
    seen = []
    real = windows_mod.segment_row_sum

    def keep(values, offsets):
        seen.append((values, offsets))
        return real(values, offsets)

    windows_mod.segment_row_sum = keep
    try:
        windows_mod.windowed_stats(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (keys, ts.astype(np.int32), value, valid)),
            window_ms=cs.READ_WINDOW_MS, num_keys=cs.ADVERSARIAL_KEYS,
            n_windows=cs.READ_WINDOWS, device=dev)
    finally:
        windows_mod.segment_row_sum = real
    return seen[0]


def main(argv=None) -> int:
    import chip_smoke as cs
    from sitewhere_tpu_torch.ops.segsum import segment_row_sum_plain

    if not torch.cuda.is_available():
        print("segsum_ab: no CUDA device available", file=sys.stderr)
        return 2
    current = cuda_build.CSRC_DIR / "segsum.cu"
    sources, kinds = {"current": current}, {"current": (False, torch.int32)}
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, source = arg.partition("=")
        old = source.endswith(":int64")
        sources[name] = Path(source[:-len(":int64")] if old else source)
        kinds[name] = (old, torch.int64 if old else torch.int32)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libraries = _build(sources)
    fns = {name: _entry(lib, *kinds[name]) for name, lib in libraries.items()}
    fns["current_int64"] = _entry(libraries["current"], False, torch.int64)
    order = list(fns) + list(fns)[::-1]
    clock_mhz = cs.sm_clock_mhz()
    failed = False
    for world, make in (("query", lambda: query_inputs(dev, cs.SEED)),
                        ("hot_cell", lambda: hot_cell_inputs(dev)),
                        ("chatty", lambda: chatty_inputs(dev, cs.SEED))):
        values, offsets = make()
        ref = segment_row_sum_plain(values, offsets)
        counts = (offsets[1:] - offsets[:-1]).long()
        S, n, longest = counts.numel(), values.numel(), int(counts.max())
        row = {"world": world, "rows": n, "segments": S,
               "longest_segment": longest,
               "mismatches": {name: int((f(values, offsets).view(torch.int32)
                                         != ref.view(torch.int32)).sum())
                              for name, f in fns.items()}}
        failed |= any(row["mismatches"].values())
        ms = {name: [] for name in fns}
        queued = {name: [] for name in fns}
        for name in order:
            ms[name].append(cs.time_cuda(lambda: fns[name](values, offsets)))
            queued[name].append(cs.time_cuda_queued(
                lambda: fns[name](values, offsets)))
        seg = torch.repeat_interleave(torch.arange(S, device=dev), counts,
                                      output_size=n)
        row.update({
            "ms_turns": ms, "queued_ms_turns": queued,
            "ms": {k: statistics.mean(t) for k, t in ms.items()},
            "queued_ms": {k: statistics.mean(t) for k, t in queued.items()},
            "library_ms": cs.time_cuda(lambda: torch.zeros(
                S, device=dev).index_add_(0, seg, values)),
            "bound_ms": (n * 4 + (S + 1) * 4 + S * 4)
            / cs.H100_HBM_BYTES_S * 1e3,
            "chain_floor_ms": longest * cs.FADD_LATENCY_CYCLES
            / clock_mhz / 1e3,
            "sm_clock_mhz": clock_mhz})
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
