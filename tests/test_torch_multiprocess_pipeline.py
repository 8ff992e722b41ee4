"""The port's sharded engine on a two-process mesh: the reference's
tests/test_multiprocess.py per-host feeding, then one exchange of the
lockstep step loop with foreign rows forwarded over the bus edge.

Two OS processes join a gloo world (parallel/distributed.py `initialize`)
and build a 4-shard global mesh on the CPU, 2 shards a process. Each
feeds the same world:

  1. per-host feeding through `submit`, as the reference's child does: a
     batch of the devices its own shards hold (the global `processed` is
     16 on both, the alerts and state are local, nothing comes back from
     `take_foreign`), then a mixed batch whose other-host rows come back
     through `take_foreign` (their tokens checked);
  2. a `ClusterStepLoop` on each process with a `ForeignRowForwarder` and
     a `ForeignRowsConsumer` over busnet: host p feeds two rounds of the
     devices `i % 2 == p`; the rows of the peer's shards are forwarded and
     folded on the peer; then the stop vote ends both loops after the
     same tick.

Each child writes its local state blocks, its alerts and the `processed`
totals it read. The parent holds them against the JAX package's
single-controller 4-shard engine over conftest's virtual CPU devices fed
the same rows (each device's rows in the same order): every local block
bit-equal to the JAX engine's blocks of the same shards, the alerts of
both hosts together set-equal to the JAX engine's, `processed` the same
global total on both hosts, and every forwarded row folded once.
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 1_700_000_000_000
CHILD_DEADLINE_S = 120

_CHILD = r"""
import json, os, sys, time
pid = int(sys.argv[1]); coord = sys.argv[2]
bus0, bus1 = int(sys.argv[3]), int(sys.argv[4]); path = sys.argv[5] + str(pid)
EPOCH = int(sys.argv[6])
import numpy as np
from sitewhere_tpu_torch.model import (
    Device, DeviceAssignment, DeviceType, DeviceMeasurement)
from sitewhere_tpu_torch.parallel import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.cluster import (
    ClusterControl, ClusterStepLoop, ForeignRowForwarder,
    ForeignRowsConsumer)
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, make_global_mesh)
from sitewhere_tpu_torch.pipeline.engine import ThresholdRule
from sitewhere_tpu_torch.registry import DeviceManagement, RegistryTensors
from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
from sitewhere_tpu_torch.runtime.busnet import BusClient, BusServer

assert initialize(coord, num_processes=2, process_id=pid) is True
mesh = make_global_mesh(n_shards=4, device="cpu")
assert mesh.local_shards == [2 * pid, 2 * pid + 1]

dm = DeviceManagement()
dt = dm.create_device_type(DeviceType(token="t"))
rt = RegistryTensors(64, 4, 4)
for i in range(16):
    d = dm.create_device(Device(token=f"d{i}", device_type_id=dt.id))
    dm.create_device_assignment(DeviceAssignment(token=f"a{i}",
                                                 device_id=d.id))
rt.attach(dm, "tenant")
e = ShardedPipelineEngine(rt, mesh=mesh, per_shard_batch=8)
e.packer.epoch_base_ms = EPOCH
e.start()
e.add_threshold_rule(ThresholdRule(token="r", measurement_name="m",
                                   operator=">", threshold=1.0))
assert e.is_multiprocess and e.local_shards == mesh.local_shards
assert not e.device_routing
alerts = []

def keep(batch_alerts):
    alerts.extend([a.device_id, a.type, int(a.level), int(a.event_date)]
                  for a in batch_alerts)

def owner(i):
    return (rt.devices.lookup(f"d{i}") % 4) // 2

# 1. aligned feeding: each host ingests only devices its shards own
mine = [i for i in range(16) if owner(i) == pid]
b = e.packer.pack_events(
    [DeviceMeasurement(name="m", value=10.0 + i, event_date=EPOCH + 1000 + i)
     for i in mine], [f"d{i}" for i in mine])[0]
rb, out = e.submit(b)
got = e.materialize_alerts(rb, out)
keep(got)
assert int(out.processed) == 16, int(out.processed)
assert len(got) == len(mine) == 8
assert {a.device_id for a in got} == {f"d{i}" for i in mine}
assert e.take_foreign() is None
for i in mine:
    st = e.get_device_state(f"d{i}")
    assert st is not None and st.last_measurements["m"][1] == 10.0 + i
other = next(i for i in range(16) if owner(i) != pid)
assert e.get_device_state(f"d{other}") is None  # the peer host's

# mixed feeding: foreign-owned rows hand back for bus forwarding
mixed = [0, 1, 2, 3]
b2 = e.packer.pack_events(
    [DeviceMeasurement(name="m", value=50.0 + i, event_date=EPOCH + 2000 + i)
     for i in mixed], [f"d{i}" for i in mixed])[0]
rb, out = e.submit(b2)
keep(e.materialize_alerts(rb, out))
assert int(out.processed) == 4, int(out.processed)
foreign = e.take_foreign()
toks = sorted(rt.devices.token_of(int(ix)) for ix in
              np.asarray(foreign.device_idx)[np.asarray(foreign.valid)])
expect = sorted(f"d{i}" for i in mixed if owner(i) != pid)
assert toks == expect, (toks, expect)
assert e.take_foreign() is None

# 2. the lockstep step loop, foreign rows forwarded over busnet
naming = TopicNaming(instance="mp-test")
bus = EventBus(partitions=2)
server = BusServer(bus, host="127.0.0.1", port=bus0 if pid == 0 else bus1)
server.start()
peer = 1 - pid
peers = {peer: BusClient("127.0.0.1", bus1 if pid == 0 else bus0)}
forwarder = ForeignRowForwarder(pid, peers, naming, local_bus=bus)
reduces = e.sum_reduces
loop = ClusterStepLoop(e, control=ClusterControl(mesh),
                       idle_interval_s=0.002, on_alerts=keep,
                       forward_foreign=lambda fb: forwarder.forward(e, fb))
consumer = ForeignRowsConsumer(bus, naming, e, loop,
                               owner_check=lambda t: owner(int(t[1:])) == pid)
consumer.start()
import torch.distributed as dist
dist.barrier()          # both edges up before anything is forwarded
loop.start()
entering = [i for i in range(16) if i % 2 == pid]
expect_in = sum(1 for i in range(16) if i % 2 == peer and owner(i) == pid)
for r in range(2):
    batch = e.packer.pack_events(
        [DeviceMeasurement(name="m", value=100.0 + 10 * r + i,
                           event_date=EPOCH + 3000 + 100 * r + i)
         for i in entering], [f"d{i}" for i in entering])[0]
    assert loop.feed(batch).wait(60)
deadline = time.monotonic() + 60
while consumer.consumed_rows < 2 * expect_in:
    assert time.monotonic() < deadline, consumer.consumed_rows
    assert loop.fatal is None, loop.fatal
    time.sleep(0.01)
t = loop.tick_count
while loop.tick_count < t + 3:
    assert time.monotonic() < deadline
    time.sleep(0.01)
dist.barrier(); loop.stop()
assert loop.fatal is None, loop.fatal
consumer.stop()
# the loop's own counters: one vote and one sums' all_reduce a tick
processed = [t.processed for t in loop.history]
assert len(processed) == loop.tick_count
assert sum(processed) == loop.processed
assert loop.control.votes == loop.tick_count
assert e.sum_reduces - reduces == loop.tick_count
shard_ids, blocks = e.local_state_shards()
np.savez(path, **{f"state.{k}": v for k, v in blocks.items()})
with open(path + ".json", "w") as fh:
    json.dump({"alerts": alerts, "processed": processed,
               "forwarded": forwarder.forwarded,
               "consumed": consumer.consumed_rows,
               "dead_lettered": forwarder.dead_lettered,
               "misrouted": consumer.misrouted_rows,
               "shard_ids": shard_ids, "ticks": loop.tick_count}, fh)
server.stop()
print(f"PIPEOK {pid}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two(child: str, args, tmp_path, deadline_s=CHILD_DEADLINE_S):
    """Run `child` as processes 0 and 1 (argv: pid, then `args`); a child
    that fails or outlives its deadline fails the test, and its peer is
    killed with it. Returns the two outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, str(pid), *[str(a) for a in args]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(tmp_path)) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=deadline_s)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait(timeout=30)
    return outs


def _jax_reference():
    """The JAX single-controller 4-shard engine fed the same rows, each
    device's in the children's order."""
    from sitewhere_tpu.model import (
        Device, DeviceAssignment, DeviceMeasurement, DeviceType)
    from sitewhere_tpu.parallel import ShardedPipelineEngine, make_mesh
    from sitewhere_tpu.pipeline.engine import ThresholdRule
    from sitewhere_tpu.registry import DeviceManagement, RegistryTensors

    dm = DeviceManagement()
    dt = dm.create_device_type(DeviceType(token="t"))
    rt = RegistryTensors(64, 4, 4)
    for i in range(16):
        d = dm.create_device(Device(token=f"d{i}", device_type_id=dt.id))
        dm.create_device_assignment(DeviceAssignment(token=f"a{i}",
                                                     device_id=d.id))
    rt.attach(dm, "tenant")
    e = ShardedPipelineEngine(rt, mesh=make_mesh(4), per_shard_batch=8,
                              device_routing=False)
    e.packer.epoch_base_ms = EPOCH
    e.start()
    e.add_threshold_rule(ThresholdRule(token="r", measurement_name="m",
                                       operator=">", threshold=1.0))
    rounds = [
        [(i, 10.0 + i, EPOCH + 1000 + i) for i in range(16)],
        [(i, 50.0 + i, EPOCH + 2000 + i) for i in range(4)],
        [(i, 100.0 + i, EPOCH + 3000 + i) for i in range(16)],
        [(i, 110.0 + i, EPOCH + 3100 + i) for i in range(16)],
    ]
    alerts, processed = [], 0
    for rows in rounds:
        batch = e.packer.pack_events(
            [DeviceMeasurement(name="m", value=v, event_date=ts)
             for _, v, ts in rows], [f"d{i}" for i, _, _ in rows])[0]
        routed, out = e.submit(batch)
        processed += int(out.processed)
        alerts += [[a.device_id, a.type, int(a.level), int(a.event_date)]
                   for a in e.materialize_alerts(routed, out)]
    return e, alerts, processed


def test_two_process_pipeline_feeding_and_forwarding(tmp_path):
    import json

    coord, bus0, bus1 = _free_port(), _free_port(), _free_port()
    outs = run_two(_CHILD, [f"127.0.0.1:{coord}", bus0, bus1,
                            str(tmp_path / "host"), EPOCH], tmp_path)
    assert all(f"PIPEOK {pid}" in outs[pid] for pid in range(2)), outs
    ref, ref_alerts, ref_processed = _jax_reference()
    got_alerts = []
    for pid in range(2):
        with open(tmp_path / f"host{pid}.json") as fh:
            info = json.load(fh)
        got_alerts += info["alerts"]
        assert info["shard_ids"] == [2 * pid, 2 * pid + 1]
        # phase 2: 32 rows folded over the cluster, the same total on both
        assert sum(info["processed"]) == 32, info["processed"]
        assert info["forwarded"] > 0 and info["dead_lettered"] == 0
        assert info["misrouted"] == 0
        blocks = np.load(tmp_path / f"host{pid}.npz")
        for name in blocks.files:
            want = np.asarray(getattr(ref._state, name.split(".", 1)[1]))
            want = want[2 * pid:2 * pid + 2]
            got = blocks[name]
            assert got.shape == want.shape, name
            assert got.dtype == want.dtype, name
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
                name
    infos = [json.load(open(tmp_path / f"host{p}.json"))
             for p in range(2)]
    # every row forwarded by one host was consumed by the other
    assert infos[0]["forwarded"] == infos[1]["consumed"]
    assert infos[1]["forwarded"] == infos[0]["consumed"]
    assert ref_processed == 16 + 4 + 32
    assert sorted(map(tuple, got_alerts)) == sorted(map(tuple, ref_alerts))
