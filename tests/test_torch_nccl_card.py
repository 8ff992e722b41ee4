"""The multi-process data plane over NCCL, on two or more cards (JAX-free;
`cuda` marker; skips below two visible cards).

Two pairs of processes run the same world (chip_smoke.py's, small) on a
4-shard global mesh, two shards a process: one pair a card each
(CUDA_VISIBLE_DEVICES 0 and 1: every process holds its own card, so the
collectives go over NCCL), one pair both on the first card (gloo: NCCL
refuses two ranks on one card). Each process feeds the same steps (the
rows its shards own), then a `ClusterStepLoop` a few ticks under the
profiler (every thread's host ops), then one mesh query on the main thread
while the loop ticks on its own thread, on both processes, within a
deadline. The NCCL pair is held bit for bit against the gloo pair: every
step's summed outputs, every local block, the alerts and the query's grids
(equal to the single-process call on the card too); and the NCCL pair's
profiled all_reduces of the sums make no host copy. On a machine with
two or more cards:
`python -m pytest --noconftest -m cuda tests/test_torch_nccl_card.py`.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_multiprocess_pipeline import REPO, _free_port

pytestmark = pytest.mark.cuda

S, STEPS, EVENTS = 4, 3, 160
SMALL = dict(max_devices=512, n_registered=400, n_zones=24, n_verts=8,
             batch=256)
QUERY = dict(rows=200_003, K=4096, W=8, window_ms=1000)
QUERY_DEADLINE_S = 60

_CHILD = r"""
import json, sys, threading, time
pid, coord = int(sys.argv[1]), sys.argv[2]
path, epoch = sys.argv[3] + str(pid), int(sys.argv[4])
import numpy as np
import torch
import torch.distributed as dist
from chip_smoke import (
    _alert_keys, build_world, profile_cards, stats_digest, synthetic_batch)
from test_torch_nccl_card import EVENTS, QUERY, S, SMALL, STEPS, query_rows
from sitewhere_tpu_torch.parallel.cluster import (
    ClusterControl, ClusterStepLoop)
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, make_global_mesh, sharded_windowed_stats)
from sitewhere_tpu_torch.parallel.engine import ShardedPipelineEngine

card = torch.device("cuda", 0)
torch.cuda.set_device(card)
assert initialize(coord, num_processes=2, process_id=pid) is True
mesh = make_global_mesh(n_shards=S, device="cuda")
engine = build_world(card, "auto", epoch, shards=S, mesh=mesh,
                     alert_lane_capacity=SMALL["batch"], **SMALL)
out = {"collectives": mesh.collectives, "cards": [str(c) for c in
                                                   mesh.cards]}


def share(t):
    batch = synthetic_batch(engine.packer, SMALL["n_registered"], EVENTS,
                            7000 + t, t_off_ms=1100 * t)
    rows = [i for i in np.nonzero(np.asarray(batch.valid))[0]
            if engine.owns(int(np.asarray(batch.device_idx)[i]))]
    return ShardedPipelineEngine._slice_flat(batch, np.asarray(rows))


sums, alerts = [], []
for t in range(STEPS):
    view, o = engine.submit(share(t))
    sums.append({k: getattr(o, k).cpu().numpy().tolist()
                 for k in ("tenant_counts", "processed", "alerts")})
    alerts += _alert_keys(engine.materialize_alerts(view, o))
loop = ClusterStepLoop(engine, control=ClusterControl(mesh),
                       idle_interval_s=0.002,
                       on_alerts=lambda a: alerts.extend(_alert_keys(a)))
dist.barrier()
loop.start()
batches = [share(STEPS + t) for t in range(2)]
out["profile"] = profile_cards(
    lambda: [loop.feed(b).wait(60) for b in batches], [card],
    ranges=("swt::all_reduce_sums", "swt::vote"))
# a mesh query on this thread while the loop ticks on its own
dist.barrier()
done, got = threading.Event(), {}

def query():
    got["digest"] = stats_digest(sharded_windowed_stats(
        *query_rows(), window_ms=QUERY["window_ms"], num_keys=QUERY["K"],
        n_windows=QUERY["W"], mesh=mesh))
    done.set()

t0 = time.perf_counter()
ticks = loop.tick_count
worker = threading.Thread(target=query, daemon=True)
worker.start()
out["query_done"] = done.wait(timeout=float(sys.argv[5]))
out["query_s"] = time.perf_counter() - t0
out["ticks_during_query"] = loop.tick_count - ticks
if not out["query_done"]:
    print("QUERY HUNG", flush=True)
    import os
    os._exit(4)
out["query"] = got["digest"]
dist.barrier()
loop.stop()
assert loop.fatal is None, loop.fatal
out.update(sums=sums, alerts=sorted(alerts), ticks=loop.tick_count,
           reduces=engine.sum_reduces, votes=loop.control.votes)
np.savez(path, **engine.local_state_shards()[1])
with open(path + ".json", "w") as fh:
    json.dump(out, fh)
print(f"NCCLOK {pid}", flush=True)
"""


def query_rows():
    rng = np.random.default_rng(4242)
    n, K, W = QUERY["rows"], QUERY["K"], QUERY["W"]
    return (rng.integers(0, K, n).astype(np.int32),
            rng.integers(0, W * QUERY["window_ms"], n).astype(np.int32),
            (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n))
            .astype(np.float32),
            rng.random(n) > 0.1)


def _pair(tmp, name, visible, epoch):
    """Run the child as processes 0 and 1, process p seeing the card
    `visible[p]`; returns their json records and blocks."""
    d = tmp / name
    d.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    coord = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(pid), f"127.0.0.1:{coord}",
         str(d / "host"), str(epoch), str(QUERY_DEADLINE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, CUDA_VISIBLE_DEVICES=visible[pid]), cwd=str(d))
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait(timeout=30)
    assert all(f"NCCLOK {pid}" in outs[pid] for pid in range(2)), outs
    return [(json.load(open(d / f"host{pid}.json")),
             np.load(d / f"host{pid}.npz")) for pid in range(2)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (one process a card)")
    import chip_smoke
    from sitewhere_tpu_torch.ops import cuda_build
    from sitewhere_tpu_torch.ops import geofence_kernel, segsum, stateful

    # every kernel built once, before the children load it
    cuda_build.build([geofence_kernel.KERNEL_SOURCE, stateful.KERNEL_SOURCE,
                      segsum.KERNEL_SOURCE])
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ids.split(",") if ids else [str(k) for k in
                                      range(torch.cuda.device_count())]
    epoch = int(time.time() * 1000) - chip_smoke.EPOCH_LAG_MS
    tmp = tmp_path_factory.mktemp("nccl")
    return {"nccl": _pair(tmp, "nccl", ids[:2], epoch),
            "gloo": _pair(tmp, "gloo", [ids[0]] * 2, epoch)}


def test_each_pair_takes_its_backend(pairs):
    for backend, hosts in pairs.items():
        for info, _ in hosts:
            assert info["collectives"] == backend
            assert info["cards"] == ["cuda:0"]


def test_nccl_pair_bit_equal_to_the_gloo_pair(pairs):
    for (a, blocks_a), (b, blocks_b) in zip(pairs["nccl"], pairs["gloo"]):
        assert a["sums"] == b["sums"]
        assert a["alerts"] == b["alerts"]
        assert a["query"] == b["query"]
        assert a["reduces"] == a["ticks"] + STEPS
        assert sorted(blocks_a.files) == sorted(blocks_b.files)
        for name in blocks_a.files:
            assert np.array_equal(blocks_a[name].view(np.uint8),
                                  blocks_b[name].view(np.uint8)), name
    assert sum(s["processed"] for s in pairs["nccl"][0][0]["sums"]) > 0


def test_the_query_equals_the_single_process_call(pairs):
    from chip_smoke import stats_digest
    from sitewhere_tpu_torch.parallel.distributed import (
        sharded_windowed_stats)
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    want = stats_digest(sharded_windowed_stats(
        *query_rows(), window_ms=QUERY["window_ms"], num_keys=QUERY["K"],
        n_windows=QUERY["W"], mesh=make_mesh(S, device="cuda:0")))
    assert all(info["query"] == want for hosts in pairs.values()
               for info, _ in hosts)


def test_nccl_sums_make_no_host_copy(pairs):
    for backend, hosts in pairs.items():
        for info, _ in hosts:
            sums = info["profile"]["swt::all_reduce_sums"]
            assert sums["ranges"] > 0, info["profile"]
            if backend == "nccl":
                assert sums["host_copies"] == 0, info["profile"]
            else:   # the gloo form copies the sums out and back
                assert sums["host_copies"] >= 2, info["profile"]


def test_a_query_beside_the_ticking_loop_completes(pairs):
    for hosts in pairs.values():
        for info, _ in hosts:
            assert info["query_done"]
            assert info["query_s"] < QUERY_DEADLINE_S
            # the loop went on ticking, its collectives beside the query's
            assert info["ticks_during_query"] > 0, info
