"""The port's multi-process data plane with several cards a process, on the
CPU: two processes over gloo, each holding its four of S = 8 shards in two
card blocks (`("cpu", "cpu")`), held bit for bit against the JAX package's
single-controller 8-device engine and against the port's one-block-a-
process form.

Each child joins the world and builds two meshes collectively
(`make_global_mesh(n_shards=8, devices=...)`): two blocks a process (the
2 x 2 form) and one (2 x 1). Both meshes take gloo (CPU processes). Every
step each host feeds both engines the rows of the devices its shards own
(aligned feeding: the hosts' rows together are the whole batch), so each
engine's step equals the reference's step over the whole batch:

  - every step's summed outputs (`tenant_counts`, `processed`, `alerts`,
    after the all_reduce) equal on both forms and equal to the JAX
    engine's psums;
  - every local block of every state group (device state, rule programs,
    anomaly models, actuation policies) equal on both forms and to the
    JAX engine's rows of the same shards; the alerts of both hosts
    together set-equal to the JAX engine's;
  - a `host-shards` checkpoint saved on 2 x 2 restores onto a fresh 2 x 1
    engine and, saved again there, onto a fresh 2 x 2 engine, every block
    as saved; one more step on the restored engine equals the original's;
  - the mesh query over 2 x 2 under both combines: the same grids on both
    processes and on the 2 x 1 mesh, equal to the single-process 8-shard
    call and to the JAX call over 8 virtual devices. Tolerance: none.
"""

import json

import numpy as np
import pytest

from test_torch_multiprocess_pipeline import _free_port, run_two

EPOCH = 1_700_000_000_000
S, B, D, STEPS = 8, 32, 64, 4
KW = dict(measurement_slots=4, max_tenants=4, alert_lane_capacity=64,
          max_rule_programs=4, rule_program_nodes=8,
          rule_program_state_slots=4, max_anomaly_models=2,
          anomaly_model_features=2, anomaly_model_layers=1,
          anomaly_model_width=4, max_actuation_policies=2,
          command_lane_capacity=16)
THRESHOLD = {"type": "threshold", "token": "r", "measurement_name": "m",
             "operator": ">", "threshold": 50.0}
PROGRAM = {"token": "debounce", "alert_level": "WARNING",
           "when": {"debounce": {"pred": "value", "measurement": "m",
                                 "op": ">", "value": 60.0}, "count": 2}}
MODEL = {"token": "hot", "kind": "mlp", "threshold": 0.5,
         "alert_level": "WARNING", "alert_type": "anomaly.hot",
         "features": [{"feature": "value", "measurement": "m",
                       "mean": 50.0, "std": 25.0}],
         "layers": [{"weights": [[1.0]], "bias": [0.0]}],
         "output": {"weights": [40.0], "bias": -38.3}}
POLICY = {"token": "on-threshold", "source": "threshold",
          "min_level": "INFO", "debounce_ms": 0, "command": "shutdown",
          "params": [1]}
QUERY = dict(n=5003, K=7, W=6, seed=1515)
SUMS = ("tenant_counts", "processed", "alerts")
GROUPS = ("rule", "model", "actuation")


def traffic(step):
    """Step `step`'s rows: (device i, value, ts), two rows a device (16 a
    shard, half of B), values straddling every rule's threshold."""
    rng = np.random.default_rng(1000 + step)
    rows = []
    for r in range(2):
        for i in range(D):
            rows.append((i, float(rng.uniform(0.0, 100.0)),
                         EPOCH + 1000 * step + 100 * r + i))
    return rows


def query_rows():
    rng = np.random.default_rng(QUERY["seed"])
    n, K, W = QUERY["n"], QUERY["K"], QUERY["W"]
    return (rng.integers(0, K, n).astype(np.int32),
            rng.integers(0, W, n).astype(np.int32),
            (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n))
            .astype(np.float32),
            rng.random(n) > 0.1)


def setup_engine(eng, mod):
    """Rules and families, as both packages' engines take them."""
    eng.packer.epoch_base_ms = EPOCH
    eng.packer.measurements.intern("m")
    eng.upsert_rule(*mod.rule_from_dict(dict(THRESHOLD)))
    eng.start()
    eng.upsert_rule_program(dict(PROGRAM))
    eng.upsert_anomaly_model(dict(MODEL))
    eng.upsert_actuation_policy(dict(POLICY))
    return eng


def registry(model, tensors):
    """D devices d0.. of one type, each assigned (the same on every host
    and in the reference, so every index agrees)."""
    dm = model.DeviceManagement()
    dt = dm.create_device_type(model.DeviceType(token="t"))
    rt = tensors(2 * D, 4, 4)
    for i in range(D):
        d = dm.create_device(model.Device(token=f"d{i}",
                                          device_type_id=dt.id))
        dm.create_device_assignment(model.DeviceAssignment(
            token=f"a{i}", device_id=d.id))
    rt.attach(dm, "tenant")
    return rt


_CHILD = r"""
import json, sys, types
pid = int(sys.argv[1]); coord = sys.argv[2]; path = sys.argv[3] + str(pid)
import numpy as np
import torch
from test_torch_multiprocess_cards import (
    B, GROUPS, KW, QUERY, S, STEPS, SUMS, query_rows, registry,
    setup_engine, traffic)
from sitewhere_tpu_torch import model as tmodel
from sitewhere_tpu_torch.model import DeviceMeasurement
from sitewhere_tpu_torch.parallel import ShardedPipelineEngine
from sitewhere_tpu_torch.parallel.distributed import (
    initialize, make_global_mesh, sharded_windowed_stats)
from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.registry import DeviceManagement, RegistryTensors

model = types.SimpleNamespace(DeviceManagement=DeviceManagement,
                              **{k: getattr(tmodel, k) for k in (
                                  "Device", "DeviceType",
                                  "DeviceAssignment")})
assert initialize(coord, num_processes=2, process_id=pid) is True
meshes = {K: make_global_mesh(n_shards=S, devices=["cpu"] * K)
          for K in (2, 1)}
for K, mesh in meshes.items():
    assert mesh.collectives == "gloo", mesh.collectives
    assert mesh.n_cards == K and mesh.local_shards == list(
        range(4 * pid, 4 * pid + 4))
    assert [mesh.shards_on(k) for k in range(K)] == [
        mesh.local_shards[k * 4 // K:(k + 1) * 4 // K] for k in range(K)]


def build(K):
    eng = ShardedPipelineEngine(registry(model, RegistryTensors),
                                mesh=meshes[K], per_shard_batch=B, **KW)
    eng = setup_engine(eng, tengine)
    assert eng.is_multiprocess and eng.n_cards == K
    assert not eng.device_routing
    return eng


def share(eng, step):
    rows = [r for r in traffic(step) if eng.owns(
        eng.packer.devices.lookup(f"d{r[0]}"))]
    return eng.packer.pack_events(
        [DeviceMeasurement(name="m", value=v, event_date=ts)
         for _, v, ts in rows], [f"d{i}" for i, _, _ in rows])[0]


def step(eng, s):
    view, out = eng.submit(share(eng, s))
    alerts = [[a.device_id, a.type, int(a.level), int(a.event_date)]
              for a in eng.materialize_alerts(view, out)]
    eng.take_command_fires()
    return {k: getattr(out, k).numpy().tolist() for k in SUMS}, alerts


def blocks(eng):
    out = {f"state.{k}": v for k, v in eng.local_state_shards()[1].items()}
    for g in GROUPS:
        for k, v in (getattr(eng, f"local_{g}_state_blocks")() or {}).items():
            out[f"{g}.{k}"] = np.asarray(v)
    return out


def same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), \
            f"{what}: {k}"


engines = {K: build(K) for K in (2, 1)}
sums, alerts = [], []
for s in range(STEPS):
    got = {K: step(e, s) for K, e in engines.items()}
    assert got[2] == got[1], (s, got)
    sums.append(got[2][0])
    alerts += got[2][1]
two, one = engines[2], engines[1]
same(blocks(two), blocks(one), "2 x 2 against 2 x 1")
np.savez(path, **blocks(two))

# host-shards: 2 x 2 -> 2 x 1 -> 2 x 2
saved = blocks(two)
PipelineCheckpointer(path + "-a").save(two)
c = build(1)
PipelineCheckpointer(path + "-a").restore(c)
np.savez(path + "-on-2x1", **blocks(c))
PipelineCheckpointer(path + "-b").save(c)
d = build(2)
PipelineCheckpointer(path + "-b").restore(d)
np.savez(path + "-on-2x2", **blocks(d))
after = [step(e, STEPS) for e in (d, two)]
np.savez(path + "-after-restored", **blocks(d))
np.savez(path + "-after", **blocks(two))

# the mesh query over 2 x 2 (and 2 x 1), both combines
grids = {}
for combine in ("psum", "ring"):
    for K in (2, 1):
        timings = {}
        st = sharded_windowed_stats(*query_rows(), window_ms=1,
                                    num_keys=QUERY["K"],
                                    n_windows=QUERY["W"],
                                    mesh=meshes[K], combine=combine,
                                    timings=timings)
        for f in ("count", "sum", "mean", "min", "max"):
            grids[f"{combine}.{K}.{f}"] = getattr(st, f).view(
                torch.int32).numpy()
    assert "fold_s_by_card" in timings or K == 1
np.savez(path + "-query", **grids)
with open(path + ".json", "w") as fh:
    json.dump({"sums": sums, "alerts": alerts,
               "shard_ids": two.local_shards,
               "after_restore": after,
               "reduces": two.sum_reduces, "steps": STEPS + 1}, fh)
print(f"CARDSOK {pid}", flush=True)
"""


def _jax_reference():
    """The JAX single-controller 8-shard engine over conftest's virtual CPU
    devices, fed every step's whole batch: (engine, each step's sums,
    alerts)."""
    import types

    from sitewhere_tpu import model as jmodel
    from sitewhere_tpu.model import DeviceMeasurement
    from sitewhere_tpu.parallel import ShardedPipelineEngine, make_mesh
    from sitewhere_tpu.pipeline import engine as jengine
    from sitewhere_tpu.registry import DeviceManagement, RegistryTensors

    model = types.SimpleNamespace(
        DeviceManagement=DeviceManagement, Device=jmodel.Device,
        DeviceType=jmodel.DeviceType,
        DeviceAssignment=jmodel.DeviceAssignment)
    e = ShardedPipelineEngine(registry(model, RegistryTensors),
                              mesh=make_mesh(S), per_shard_batch=B,
                              device_routing=False, **KW)
    setup_engine(e, jengine)
    sums, alerts = [], []
    for s in range(STEPS):
        rows = traffic(s)
        batch = e.packer.pack_events(
            [DeviceMeasurement(name="m", value=v, event_date=ts)
             for _, v, ts in rows], [f"d{i}" for i, _, _ in rows])[0]
        routed, out = e.submit(batch)
        sums.append({k: np.asarray(getattr(out, k)).tolist() for k in SUMS})
        alerts += [[a.device_id, a.type, int(a.level), int(a.event_date)]
                   for a in e.materialize_alerts(routed, out)]
        e.take_command_fires()
    return e, sums, alerts


def _jax_blocks(e, pid):
    lo, hi = 4 * pid, 4 * pid + 4
    out = {f"state.{f}": np.asarray(getattr(e._state, f))[lo:hi]
           for f in e._state.__dataclass_fields__}
    for g in GROUPS:
        state = getattr(e, f"_{g}_state")
        out.update({f"{g}.{f}": np.asarray(getattr(state, f))[lo:hi]
                    for f in state.__dataclass_fields__})
    return out


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """Runs the two children once: (their directory, their json records,
    the JAX reference engine, its sums, its alerts)."""
    tmp = tmp_path_factory.mktemp("cards")
    outs = run_two(_CHILD, [f"127.0.0.1:{_free_port()}", str(tmp / "host")],
                   tmp)
    assert all(f"CARDSOK {pid}" in outs[pid] for pid in range(2)), outs
    infos = [json.load(open(tmp / f"host{pid}.json")) for pid in range(2)]
    return (tmp, infos) + _jax_reference()


def test_sums_and_blocks_equal_jax_and_one_block_a_process(hosts):
    """Each step's sums (one all_reduce a step) and every local block of
    every state group, on both processes of the 2 x 2 form (the children
    hold it equal to the 2 x 1 form), against the JAX engine."""
    tmp, infos, ref, ref_sums, _ = hosts
    assert sum(s["processed"] for s in ref_sums) == STEPS * 2 * D
    for pid, info in enumerate(infos):
        assert info["shard_ids"] == list(range(4 * pid, 4 * pid + 4))
        assert info["reduces"] == info["steps"]
        assert info["sums"] == ref_sums, (pid, info["sums"], ref_sums)
        got = np.load(tmp / f"host{pid}.npz")
        want = _jax_blocks(ref, pid)
        assert sorted(got.files) == sorted(want), pid
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), \
                (pid, name)


def test_alerts_of_both_hosts_equal_jax(hosts):
    _, infos, _, _, ref_alerts = hosts
    got = [tuple(a) for info in infos for a in info["alerts"]]
    assert ref_alerts and sorted(got) == sorted(map(tuple, ref_alerts))


def test_host_shards_checkpoint_crosses_card_layouts(hosts):
    """Each child saved on 2 x 2, restored onto 2 x 1, saved there and
    restored onto 2 x 2: every block as saved each time; one more step of
    the restored engine beside the original: the same sums, alerts and
    blocks."""
    tmp, infos, _, _, _ = hosts
    for pid, info in enumerate(infos):
        saved = np.load(tmp / f"host{pid}.npz")
        after = np.load(tmp / f"host{pid}-after.npz")
        for what, want in (("on-2x1", saved), ("on-2x2", saved),
                           ("after-restored", after)):
            got = np.load(tmp / f"host{pid}-{what}.npz")
            assert sorted(got.files) == sorted(want.files)
            for name in want.files:
                assert np.array_equal(got[name].view(np.uint8),
                                      want[name].view(np.uint8)), \
                    (pid, what, name)
        restored, original = info["after_restore"]
        assert restored == original


@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_mesh_query_over_two_blocks_a_process_equals_one_process(
        hosts, combine):
    """Every grid of both processes, over 2 x 2 and 2 x 1, against the
    single-process 8-shard call and the JAX call over conftest's 8 virtual
    CPU devices, bit for bit."""
    import torch

    from sitewhere_tpu.parallel.distributed import (
        sharded_windowed_stats as jax_sharded)
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
    from sitewhere_tpu_torch.parallel.distributed import (
        sharded_windowed_stats)
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    tmp = hosts[0]
    grids = [np.load(tmp / f"host{pid}-query.npz") for pid in range(2)]
    kw = dict(window_ms=1, num_keys=QUERY["K"], n_windows=QUERY["W"],
              combine=combine)
    st = sharded_windowed_stats(*query_rows(),
                                mesh=make_mesh(S, device="cpu"), **kw)
    jst = jax_sharded(*query_rows(), mesh=jax_mesh(S), **kw)
    for f in ("count", "sum", "mean", "min", "max"):
        want = getattr(st, f).view(torch.int32).numpy()
        jax_want = np.asarray(getattr(jst, f)).view(np.int32)
        np.testing.assert_array_equal(want, jax_want,
                                      err_msg=f"{combine} {f} against JAX")
        for pid in range(2):
            for K in (2, 1):
                got = grids[pid][f"{combine}.{K}.{f}"]
                what = f"host {pid} {combine} {K} card(s) {f}"
                np.testing.assert_array_equal(got, want, err_msg=what)
                np.testing.assert_array_equal(got, jax_want,
                                              err_msg=f"{what} against JAX")
