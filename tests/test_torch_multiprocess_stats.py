"""Window-sharded analytics on a two-process mesh: the reference's
tests/test_multiprocess.py sharded-stats drill on the port, held bit for
bit.

Two OS processes join a gloo world and build a 4-shard global mesh on the
CPU, 2 shards a process. Every process passes the same rows (non-integer
values spanning eleven decades, and rows carrying denormals, signed zeros,
infinities and NaNs) to `sharded_windowed_stats` under both combines; each
folds its own two blocks and all-gathers the partials. The parent holds
both processes' grids (every count, every f32 cell as a bit pattern)
against each other and against the JAX package's single-controller
4-shard call over conftest's virtual CPU devices.

That is the order the probe of the reference fixed (ROADMAP C): the JAX
package's own two-process program gives deterministic bits that differ
from its single-process ones (its psum adds each cell in gloo's chunked
ring order, and its ring answers each process its first shard's chain, so
its two processes disagree), and it refuses NaN rows outright; the port
returns the single-process 4-shard result on every process. Tolerance:
none.
"""

import numpy as np
import pytest

from test_torch_multiprocess_pipeline import _free_port, run_two

CASES = [(1001, 5, 4, 0.0, 11), (4096, 16, 8, 0.0, 12), (1001, 3, 2, 0.3, 13),
         (999, 5, 4, 0.8, 14), (3, 1, 1, 0.0, 15), (0, 2, 2, 0.0, 16)]

_CHILD = r"""
import sys
pid = int(sys.argv[1]); coord = sys.argv[2]; path = sys.argv[3] + str(pid)
import numpy as np
from test_torch_multiprocess_stats import CASES, rows
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, make_global_mesh, sharded_windowed_stats)

assert initialize(coord, num_processes=2, process_id=pid) is True
mesh = make_global_mesh(n_shards=4, device="cpu")
out = {}
for c, (n, K, W, special, seed) in enumerate(CASES):
    for combine in ("psum", "ring"):
        timings = {}
        st = sharded_windowed_stats(*rows(n, K, W, special, seed),
                                    window_ms=1, num_keys=K, n_windows=W,
                                    mesh=mesh, combine=combine,
                                    timings=timings)
        assert set(timings) == {"fold_s", "gather_s", "combine_s"}
        for f in ("count", "sum", "mean", "min", "max"):
            out[f"{c}_{combine}_{f}"] = getattr(st, f).view(
                __import__("torch").int32).numpy()
np.savez(path, **out)
print(f"STATSOK {pid}", flush=True)
"""


def rows(n, K, W, special, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, n).astype(np.int32)
    ts = rng.integers(-1, W + 1, n).astype(np.int32)
    value = (rng.standard_normal(n) *
             10.0 ** rng.integers(-5, 6, n)).astype(np.float32)
    specials = np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf], np.float32),
        np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x000116C2,
                  0x800116C2, 0x00800000], np.uint32).view(np.float32)])
    hit = rng.random(n) < special
    value[hit] = specials[rng.integers(0, len(specials), int(hit.sum()))]
    valid = rng.random(n) > 0.1
    return keys, ts, value, valid


def test_two_process_sharded_stats_bit_equal_to_single_controller(tmp_path):
    from sitewhere_tpu.parallel.distributed import (
        sharded_windowed_stats as jax_sharded)
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh

    outs = run_two(_CHILD, [f"127.0.0.1:{_free_port()}",
                            str(tmp_path / "host")], tmp_path)
    assert all(f"STATSOK {pid}" in outs[pid] for pid in range(2)), outs
    got = [np.load(tmp_path / f"host{pid}.npz") for pid in range(2)]
    for c, (n, K, W, special, seed) in enumerate(CASES):
        for combine in ("psum", "ring"):
            want = jax_sharded(*rows(n, K, W, special, seed), window_ms=1,
                               num_keys=K, n_windows=W, mesh=jax_mesh(4),
                               combine=combine)
            for f in ("count", "sum", "mean", "min", "max"):
                key = f"{c}_{combine}_{f}"
                w = np.asarray(getattr(want, f)).view(np.int32)
                for pid in range(2):
                    assert np.array_equal(got[pid][key], w), (key, pid)


@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_orders_the_probe_fixed_tell_the_cells_apart(combine):
    """The one-row-a-shard values the probe used: the single-controller
    order the port keeps gives other bits than the sums the reference's
    two-process run gave there ((l2 + l3) + l0) + l1 for psum, and process
    1's chain l2, l1, l0, l3 for ring), so the parity above pins which
    order the port follows."""
    from sitewhere_tpu.parallel.distributed import (
        sharded_windowed_stats as jax_sharded)
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh

    vals = np.array([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24], np.float32)
    keys = np.zeros(4, np.int32)
    st = jax_sharded(keys, keys, vals, np.ones(4, bool), window_ms=1,
                     num_keys=1, n_windows=1, mesh=jax_mesh(4),
                     combine=combine)
    if combine == "psum":
        other = np.float32(np.float32(np.float32(vals[2] + vals[3])
                                      + vals[0]) + vals[1])
    else:
        other = np.float32(np.float32(np.float32(vals[2] + vals[1])
                                      + vals[0]) + vals[3])
    single = np.asarray(st.sum).reshape(-1)[0]
    assert single.view(np.int32) != other.view(np.int32)
