"""The port's checkpointer (sitewhere_tpu_torch/persist/checkpoint.py) held
against the JAX package's, on the CPU.

The world of tests/test_torch_pipeline.py (two tenants, registered and
unassigned devices, zones, threshold/geofence rules), with the rule
programs, anomaly models and actuation policies of
tests/test_torch_pipeline_stateful.py where a case says "stateful":
  - interchange, both ways: an engine of one package runs a few steps and
    saves; a fresh engine of the other package restores; both continue on
    the same traffic with identical alerts (order included), command fires,
    canonical state and every state group (f32 as bit patterns), counters,
    manifests and presence transitions — on the main path and with every
    family caught mid-window; a pre-slab (legacy column) checkpoint
    migrates into the slab in both packages;
  - sharded -> single: a JAX ShardedPipelineEngine over a shard-congruent
    registry saves; the port's single engine restores it (its registry
    mirror rebuilt under the congruent indices) and continues as the
    sharded engine does;
  - assembly: `assemble_canonical` / `write_assembled` give the JAX
    functions' manifests and arrays on the same per-host directories;
  - the checkpointer's behaviour: digest quarantine and fall-back, the
    torn-write drill, `keep` GC, the stale-writer fence, `recover` over the
    bus, an overflow backlog's install (its alerts ahead of the next step's,
    as the reference orders them), the refusal of the `host-shards` layout,
    and a restore into an engine whose captured step (a stand-in bound to
    the engine's buffers, as a CUDA graph is) then goes on bit-equal;
  - the engine's pending-alert list drains at the head of the next
    materialize_alerts, as the JAX engine's does.
The same restore into an engine that has captured its CUDA graph on the
card is in tests/test_torch_durable_card.py. Tolerance: none.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu.persist import checkpoint as jckpt
from sitewhere_tpu.pipeline import engine as jengine
from sitewhere_tpu.runtime import faults as j_faults
from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
from sitewhere_tpu_torch.persist import checkpoint as tckpt
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.pipeline.graph import commit, step_key
from sitewhere_tpu_torch.pipeline.step import process_batch
from sitewhere_tpu_torch.runtime import faults as t_faults
from sitewhere_tpu_torch.runtime.bus import EventBus
from sitewhere_tpu_torch.tree import tree_leaves

from test_torch_pipeline import (
    B, D, K, M, PRESENCE_MS, RULES, T, V, Z, _alert_key, _polygon,
    assert_bits_equal, assert_dataclass_bits_equal, make_cols)
from test_torch_pipeline_stateful import BUCKETS, MODELS, POLICIES, PROGRAMS
from test_torch_staging import port_registry

KWARGS = dict(batch_size=B, measurement_slots=M, max_tenants=T,
              max_threshold_rules=16, max_geofence_rules=8,
              alert_lane_capacity=K, presence_missing_interval_ms=PRESENCE_MS,
              **BUCKETS)
CUT, AFTER = 3, 3          # steps before the save, steps after the restore
EPOCH = 1_700_000_000_000  # the port engines' packer epoch base
_SEQ = iter(range(100_000))


@pytest.fixture(autouse=True)
def _always_disarm():
    j_faults.disarm()
    t_faults.disarm()
    yield
    j_faults.disarm()
    t_faults.disarm()


# -- worlds -------------------------------------------------------------------

def jax_registry(n_devices=D, shard_classes=1):
    """The JAX control plane -> registry mirror of tests/test_torch_pipeline
    (two tenants, sensor/tracker types, six zones, dev-unassigned and
    dev-2.. with active assignments), `n_devices` rows."""
    from sitewhere_tpu.model import (
        Area, Device, DeviceAssignment, DeviceType, Zone)
    from sitewhere_tpu.model.common import Location
    from sitewhere_tpu.registry import DeviceManagement, RegistryTensors

    rng = np.random.default_rng(2024)
    jreg = RegistryTensors(max_devices=D, max_zones=Z, max_zone_vertices=V,
                           shard_classes=shard_classes)
    dms, types, areas = {}, {}, {}
    for tenant in ("t1", "t2"):
        dm = DeviceManagement()
        jreg.attach(dm, tenant)
        dms[tenant] = dm
        types[tenant] = {t: dm.create_device_type(DeviceType(token=t))
                         for t in ("sensor", "tracker")}
        areas[tenant] = dm.create_area(Area(token=f"area-{tenant}"))
    for z in range(1, 7):
        tenant = "t1" if z <= 4 else "t2"
        poly = _polygon(rng, rng.uniform(0, 10, 2),
                        int(rng.integers(3, V + 1)))
        dms[tenant].create_zone(Zone(
            token=f"z{z}", area_id=areas[tenant].id,
            bounds=[Location(lat, lon) for lat, lon in poly]))
    dms["t1"].create_device(Device(token="dev-unassigned",
                                   device_type_id=types["t1"]["sensor"].id))
    for i in range(2, n_devices):
        tenant = "t1" if i < 150 else "t2"
        device = dms[tenant].create_device(Device(
            token=f"dev-{i}", device_type_id=types[tenant][
                "tracker" if i % 3 == 0 else "sensor"].id))
        dms[tenant].create_device_assignment(DeviceAssignment(
            token=f"as-{i}", device_id=device.id,
            area_id=areas[tenant].id))
    return jreg


def _setup(eng, mod, stateful):
    for name in ("m1", "m2", "m3"):
        eng.packer.measurements.intern(name)
    for spec in RULES:
        eng.upsert_rule(*mod.rule_from_dict(dict(spec)))
    eng.start()
    if stateful:
        for spec in PROGRAMS:
            eng.upsert_rule_program(dict(spec))
        for spec in MODELS:
            eng.upsert_anomaly_model(dict(spec))
        for spec in POLICIES:
            eng.upsert_actuation_policy(dict(spec))
    return eng


def jax_engine(jreg, stateful=False, **kw):
    eng = jengine.PipelineEngine(jreg, name=f"ckpt-ref-{next(_SEQ)}",
                                 **dict(KWARGS, **kw))
    return _setup(eng, jengine, stateful)


def port_engine(jreg, epoch_base_ms, stateful=False, **kw):
    eng = tengine.PipelineEngine(port_registry(jreg), device="cpu",
                                 name=f"ckpt-{next(_SEQ)}",
                                 **dict(KWARGS, **kw))
    eng.packer.epoch_base_ms = epoch_base_ms
    return _setup(eng, tengine, stateful)


# -- traffic ------------------------------------------------------------------

TOKENS = [None, "dev-unassigned"] + [f"dev-{i}" for i in range(2, D)]


def pack(eng, seed, step):
    """Batch `seed` of tests/test_torch_pipeline's traffic for `eng`: the
    rows' devices by TOKEN (index i of the sequential world), so engines
    whose interners lay tokens out differently get the same events; steps
    are a second apart."""
    cols = make_cols(seed, "compact")
    tokens = [TOKENS[i] for i in cols["device_idx"]]
    idx = np.array([eng.packer.devices.lookup(t) if t else 0
                    for t in tokens], np.int32)
    ts = eng.packer.epoch_base_ms + (cols["ts"].astype(np.int64)
                                     + 1000 * step)
    return eng.packer.pack_columns(
        idx, cols["event_type"], ts,
        **{k: cols[k] for k in ("mm_idx", "value", "lat", "lon",
                                "elevation", "alert_type_idx",
                                "alert_level")})


def step(eng, seed, k):
    """One submit + materialize + fire drain; (alert keys, fires)."""
    routed, out = eng.submit_routed(pack(eng, seed, k))
    alerts = [_alert_key(a) for a in eng.materialize_alerts(routed, out)]
    return alerts, eng.take_command_fires()


def assert_same_engines(ref, got, what=""):
    """Every state group bit-equal, and the counters and manifests."""
    assert_dataclass_bits_equal(ref.canonical_state(), got.canonical_state(),
                                f"{what} state")
    for group in ("rule", "model", "actuation"):
        assert_dataclass_bits_equal(
            getattr(ref, f"canonical_{group}_state")(),
            getattr(got, f"canonical_{group}_state")(), f"{what} {group}")
    for name in ("rule_program_counters", "anomaly_model_counters",
                 "actuation_policy_counters", "rule_program_manifest",
                 "anomaly_model_manifest", "actuation_policy_manifest"):
        assert getattr(got, name)() == getattr(ref, name)(), (what, name)


def presence(eng, monkeypatch, at_ms):
    monkeypatch.setattr(time, "time", lambda: at_ms / 1000.0)
    return eng.presence_sweep()


PACKAGES = {"jax": jckpt, "port": tckpt}


def make(package, jreg, epoch, stateful):
    if package == "jax":
        return jax_engine(jreg, stateful)
    return port_engine(jreg, epoch, stateful)


# -- interchange ----------------------------------------------------------------

@pytest.mark.parametrize("stateful", [False, True], ids=["main", "stateful"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_interchange_continues_bit_identically(src, dst, stateful, tmp_path,
                                              monkeypatch):
    jreg = jax_registry()
    a = make(src, jreg, EPOCH, stateful)
    epoch = a.packer.epoch_base_ms
    fired = 0
    for k in range(CUT):
        alerts, fires = step(a, 700 + k, k)
        fired += len(alerts) + len(fires)
    path = PACKAGES[src].PipelineCheckpointer(str(tmp_path)).save(a)
    b = make(dst, jax_registry(), epoch + 12345, False)   # nothing installed
    PACKAGES[dst].PipelineCheckpointer(str(tmp_path)).restore(b, path)
    assert b.packer.epoch_base_ms == epoch
    assert_same_engines(a, b, "restored")
    for k in range(CUT, CUT + AFTER):
        got, want = step(b, 700 + k, k), step(a, 700 + k, k)
        assert got == want, f"step {k}"
        fired += len(want[0]) + len(want[1])
    assert fired > 0
    assert_same_engines(a, b, "continued")
    at = epoch + 1000 * (CUT + AFTER) + 600
    assert presence(b, monkeypatch, at) == presence(a, monkeypatch, at)
    assert_dataclass_bits_equal(a.canonical_state(), b.canonical_state(),
                                "after presence")
    if stateful:
        counters = b.rule_program_counters()
        assert sum(c["fires"] for c in counters.values()) > 0
        assert b.commands_fired > 0


def _legacy(path, prefix, flag_field):
    """Rewrite a checkpoint's `prefix` group into the pre-slab layout
    (six separate columns), as the reference's migration tests do."""
    from sitewhere_tpu.ops.slab import unpack_state_slab_np
    from sitewhere_tpu.persist.atomic import write_digest_manifest

    npz = os.path.join(path, "state.npz")
    with np.load(npz) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    planes = unpack_state_slab_np(arrays.pop(f"{prefix}slab"))
    for name in ("value", "aux", "ts", "counter", "row_gen"):
        arrays[f"{prefix}{name}"] = planes[name]
    arrays[f"{prefix}{flag_field}"] = planes["flag"].astype(bool)
    np.savez_compressed(npz, **arrays)
    write_digest_manifest(path)


@pytest.mark.parametrize("prefix,flag", [("rulestate.", "root_prev"),
                                         ("modelstate.", "score_prev")])
def test_pre_slab_checkpoint_migrates_in_both_packages(prefix, flag,
                                                       tmp_path):
    jreg = jax_registry()
    a = jax_engine(jreg, stateful=True)
    epoch = a.packer.epoch_base_ms
    for k in range(CUT):
        step(a, 720 + k, k)
    path = jckpt.PipelineCheckpointer(str(tmp_path)).save(a)
    _legacy(path, prefix, flag)
    b = port_engine(jax_registry(), epoch)
    c = jax_engine(jax_registry())
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(b, path)
    jckpt.PipelineCheckpointer(str(tmp_path)).restore(c, path)
    assert_same_engines(a, b, "port migrated")
    assert_same_engines(a, c, "jax migrated")
    for k in range(CUT, CUT + 2):
        want = step(a, 720 + k, k)
        assert step(b, 720 + k, k) == want == step(c, 720 + k, k)
    assert_same_engines(a, b)


def test_sharded_checkpoint_restores_onto_the_port(tmp_path):
    """A 4-shard JAX engine over a shard-congruent registry, every family
    mid-window, saves; the port's single engine (a sequential world)
    restores it: its interner takes the congruent indices and its registry
    mirror re-mirrors every row under them. Both continue with the same
    alerts and fires per device, the same counters and bit-equal state."""
    from sitewhere_tpu.parallel import ShardedPipelineEngine, make_mesh

    n = 120        # 4 congruence classes of 64 rows hold them
    # lanes wide enough that neither layout drops a fire (the sharded
    # engine's lanes are per shard, so an overflow keeps other rows)
    lanes = dict(alert_lane_capacity=4 * B, command_lane_capacity=4 * B)
    sreg = jax_registry(n, shard_classes=4)
    sharded = ShardedPipelineEngine(
        sreg, mesh=make_mesh(4), per_shard_batch=B,
        name=f"ckpt-sharded-{next(_SEQ)}",
        **{k: v for k, v in dict(KWARGS, **lanes).items()
           if k != "batch_size"})
    _setup(sharded, jengine, stateful=True)
    for k in range(CUT):
        step(sharded, 740 + k, k)
    path = jckpt.PipelineCheckpointer(str(tmp_path)).save(sharded)

    single = port_engine(jax_registry(n), sharded.packer.epoch_base_ms,
                         **lanes)
    before = single.registry.devices.snapshot()
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(single, path)
    assert single.registry.devices.snapshot() == \
        sharded.registry.devices.snapshot() != before
    # the mirror's rows moved with their tokens
    snap = single.registry.snapshot()
    ref = sharded.registry.snapshot()
    for name in ("assignment_status", "tenant_idx", "area_idx",
                 "device_type_idx"):
        assert_bits_equal(getattr(ref, name), getattr(snap, name), name)
    assert_same_engines(sharded, single, "restored")
    for k in range(CUT, CUT + AFTER):
        a_alerts, a_fires = step(sharded, 740 + k, k)
        b_alerts, b_fires = step(single, 740 + k, k)
        assert sorted(b_alerts) == sorted(a_alerts), f"step {k}"
        key = lambda f: (f["device"], f["policy"])  # noqa: E731
        assert sorted(b_fires, key=key) == sorted(a_fires, key=key)
    assert_same_engines(sharded, single, "continued")
    assert sharded.commands_dropped == single.commands_dropped == 0


# -- assembly -------------------------------------------------------------------

def _host_dirs(tmp_path, with_extras):
    """Two per-host checkpoints of a 4-shard JAX engine (host 0 owns
    shards [0, 2], host 1 [1, 3]), in the reference's on-disk format; with
    `with_extras` host 1 also diverges in its measurement order and epoch
    base, and carries an overflow backlog and a pending alert."""
    from sitewhere_tpu.parallel import ShardedPipelineEngine, make_mesh

    from test_assemble_checkpoint import _write_host_ckpt

    eng = ShardedPipelineEngine(
        jax_registry(120, shard_classes=4), mesh=make_mesh(4),
        per_shard_batch=B, name=f"ckpt-hosts-{next(_SEQ)}",
        **{k: v for k, v in KWARGS.items() if k != "batch_size"})
    _setup(eng, jengine, stateful=False)
    for k in range(2):
        step(eng, 760 + k, k)
    shard_ids, blocks = eng.local_state_shards()
    interners = {"devices": eng.packer.devices.snapshot(),
                 "measurements": eng.packer.measurements.snapshot(),
                 "alert_types": eng.packer.alert_types.snapshot(),
                 "tenants": eng.registry.tenants.snapshot()}
    rules = [jengine.rule_to_dict(kind, r) for kind, rs in
             eng.list_rules().items() for r in rs]
    paths = []
    for host, ids in enumerate([[0, 2], [1, 3]]):
        host_blocks = {name: np.asarray(block)[ids]
                       for name, block in blocks.items()}
        extras = {}
        base = eng.packer.epoch_base_ms
        mine = dict(interners)
        if with_extras and host == 1:
            base += 2000
            mine["measurements"] = [None, "m2", "m1", "m3"]
            lm = host_blocks["last_measurement"].copy()
            lm[..., 1], lm[..., 2] = lm[..., 2].copy(), lm[..., 1].copy()
            host_blocks["last_measurement"] = lm
            lts = host_blocks["last_measurement_ts"].copy()
            lts[..., 1], lts[..., 2] = lts[..., 2].copy(), lts[..., 1].copy()
            host_blocks["last_measurement_ts"] = np.where(
                lts == -(2 ** 31), lts, lts - 2000).astype(np.int32)
            # trackers of tenant t1: `neq-tracker` fires on m2 != 50
            devs = [eng.packer.devices.lookup(f"dev-{i}")
                    for i in (3, 6, 9, 12, 15)]
            rows = len(devs)
            extras["overflow"] = {
                "device_idx": np.array(devs, np.int32),
                "tenant_idx": np.zeros(rows, np.int32),
                "event_type": np.zeros(rows, np.int32),
                "ts": np.full(rows, 1500, np.int32),
                "mm_idx": np.full(rows, 1, np.int32),       # m2 here
                "value": np.full(rows, 95.5, np.float32),
                "lat": np.zeros(rows, np.float32),
                "lon": np.zeros(rows, np.float32),
                "elevation": np.zeros(rows, np.float32),
                "alert_type_idx": np.zeros(rows, np.int32),
                "alert_level": np.zeros(rows, np.int32),
                "valid": np.ones(rows, bool)}
            extras["pending"] = [{"device_id": "dev-7", "type": "late",
                                  "level": 2, "source": 1,
                                  "message": "stashed", "event_date": 7}]
        paths.append(_write_host_ckpt(
            tmp_path / f"h{host}", ids, 4, host_blocks, mine, base,
            process_id=host, rules=rules, **extras))
    return paths


def _npz(path):
    with np.load(os.path.join(path, "state.npz")) as data:
        return {k: np.asarray(data[k]) for k in data.files}


@pytest.mark.parametrize("with_extras", [False, True],
                         ids=["one_cluster", "divergent_hosts"])
def test_assembly_matches_the_reference(with_extras, tmp_path):
    paths = _host_dirs(tmp_path, with_extras)
    jm, jarrays, jover = jckpt.assemble_canonical(paths)
    tm, tarrays, tover = tckpt.assemble_canonical(paths)
    assert tm == jm
    assert sorted(tarrays) == sorted(jarrays)
    for name in jarrays:
        assert_bits_equal(jarrays[name], tarrays[name], name)
    assert (tover is None) == (jover is None) == (not with_extras)
    for name in jover or {}:
        assert_bits_equal(jover[name], tover[name], f"overflow {name}")
    jpath = jckpt.write_assembled(paths, str(tmp_path / "jax"))
    tpath = tckpt.write_assembled(paths, str(tmp_path / "port"))
    assert os.path.basename(jpath) == os.path.basename(tpath)
    for name in ("manifest.json", "digest.json"):
        assert os.path.exists(os.path.join(tpath, name))
    with open(os.path.join(jpath, "manifest.json")) as fj, \
            open(os.path.join(tpath, "manifest.json")) as ft:
        assert json.load(ft) == json.load(fj)
    ja, ta = _npz(jpath), _npz(tpath)
    assert sorted(ta) == sorted(ja)
    for name in ja:
        assert_bits_equal(ja[name], ta[name], name)
    for bad in ([paths[0]], [paths[0], paths[0]]):
        with pytest.raises(tckpt.SiteWhereCheckpointError):
            tckpt.assemble_canonical(bad)


def test_assembled_checkpoint_restores_onto_the_port(tmp_path):
    """An assembled checkpoint (overflow backlog and a pending alert
    included) restores into the port's engine and the JAX single engine
    alike: the same state, and the same step alerts after — on the port
    preceded by the checkpoint's pending alert and the folded backlog's,
    at the head of the next materialize. The reference loses those (its
    `_install_overflow` extends the list materialize_alerts just rebound;
    ROADMAP.md queue C)."""
    paths = _host_dirs(tmp_path, with_extras=True)
    out = jckpt.write_assembled(paths, str(tmp_path / "assembled"))
    jreg = jax_registry(120, shard_classes=4)
    a = jax_engine(jreg)
    b = port_engine(jreg, EPOCH)
    for eng, mod in ((a, jckpt), (b, tckpt)):
        mod.PipelineCheckpointer(str(tmp_path / "assembled")).restore(
            eng, out)
    assert a._pending_alerts == []        # the reference's loss
    pending = [_alert_key(x) for x in b._pending_alerts]
    assert pending[0][4] == "stashed"
    assert [p[3] for p in pending[1:]] == ["threshold.violation"] * 5
    assert_same_engines(a, b, "assembled")
    got, want = step(b, 780, 9), step(a, 780, 9)
    assert got[0][:6] == pending and got[0][6:] == want[0]
    assert got[1] == want[1] and want[0]
    assert not b._pending_alerts


# -- the checkpointer's own behaviour ---------------------------------------------

@pytest.fixture
def small():
    """A port engine with a few steps of traffic, and its world's JAX
    registry."""
    jreg = jax_registry()
    eng = port_engine(jreg, 1_700_000_000_000)
    for k in range(2):
        step(eng, 800 + k, k)
    return jreg, eng


def test_digest_quarantine_and_fallback(small, tmp_path):
    jreg, eng = small
    ckpt = tckpt.PipelineCheckpointer(str(tmp_path))
    good = ckpt.save(eng)
    step(eng, 802, 2)
    bad = ckpt.save(eng)
    with open(os.path.join(bad, "state.npz"), "r+b") as fh:
        fh.truncate(100)
    fresh = port_engine(jreg, 0)
    assert ckpt.latest() == good                    # quarantined
    assert os.path.isdir(bad + ".quarantine")
    assert tckpt.PipelineCheckpointer(str(tmp_path)).latest() == good
    ckpt.restore(fresh)
    with np.load(os.path.join(good, "state.npz")) as data:
        assert_bits_equal(data["state.event_count"],
                          fresh.canonical_state().event_count)
    # the JAX package reads the same directory the same way
    assert jckpt.PipelineCheckpointer(str(tmp_path)).latest() == good
    with pytest.raises(tckpt.SiteWhereCheckpointError, match="unreadable"):
        ckpt.restore(fresh, bad + ".quarantine")


def test_torn_write_drill_falls_back_to_last_good(small, tmp_path):
    jreg, eng = small
    ckpt = tckpt.PipelineCheckpointer(str(tmp_path))
    good = ckpt.save(eng)
    t_faults.arm(t_faults.FaultPlan(seed=1, rules=[
        t_faults.FaultRule("checkpoint_torn_write", times=1)]))
    torn = ckpt.save(eng)
    t_faults.disarm()
    assert torn != good and os.path.isdir(torn)
    assert ckpt.latest() == good
    assert os.path.isdir(torn + ".quarantine")
    fresh = port_engine(jreg, 0)
    ckpt.restore(fresh)
    assert fresh.packer.epoch_base_ms == eng.packer.epoch_base_ms


def test_keep_limit_gc(small, tmp_path):
    _, eng = small
    ckpt = tckpt.PipelineCheckpointer(str(tmp_path), keep=2)
    paths = [ckpt.save(eng) for _ in range(4)]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(p)
                                            for p in paths[2:]]
    assert ckpt.latest() == paths[-1]
    assert ckpt.last_timings["bytes"] > 0


def test_stale_writer_fenced_and_epoch_reported(small, tmp_path):
    """tests/test_recovery.py TestCheckpointFencing on the port."""
    from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

    jreg, eng = small
    current = tckpt.PipelineCheckpointer(str(tmp_path))
    current.recovery_epoch = 3
    path = current.save(eng)
    with open(os.path.join(path, "manifest.json")) as fh:
        assert json.load(fh)["recovery_epoch"] == 3
    zombie = tckpt.PipelineCheckpointer(str(tmp_path))
    zombie.recovery_epoch = 2
    rejected = GLOBAL_METRICS.counter("fencing.rejected").value
    with pytest.raises(tckpt.SiteWhereCheckpointError, match="fenced"):
        zombie.save(eng)
    assert GLOBAL_METRICS.counter("fencing.rejected").value == rejected + 1
    assert current.save(eng)
    revived = tckpt.PipelineCheckpointer(str(tmp_path))
    assert revived.last_restore_epoch is None
    revived.restore(port_engine(jreg, 0))
    assert revived.last_restore_epoch == 3


def test_recover_replays_exactly_the_records_past_the_offsets(tmp_path):
    """tests/test_persist.py test_recover_replays_uncommitted on the
    port, with packed wire blobs as the bus values: the recovered engine
    replays only the uncommitted tail and ends bit-equal to the
    uninterrupted one, alerts included."""
    jreg = jax_registry()
    eng = port_engine(jreg, 1_700_000_000_000, stateful=True)
    bus = EventBus(partitions=2, data_dir=str(tmp_path / "bus"))
    blobs = [batch_to_blob(pack(eng, 820 + k, k)) for k in range(5)]
    for k, blob in enumerate(blobs):
        bus.publish("events", f"k{k}".encode(),
                    np.int32(blob.shape[0]).tobytes() + blob.tobytes())
    bus.flush()

    def decode(record):
        rows = int(np.frombuffer(record.value[:4], np.int32)[0])
        return np.frombuffer(record.value[4:], np.int32).reshape(
            rows, -1).copy()

    def run(engine, blob):
        out = engine.submit_blob(blob)
        batch = blob_to_batch(torch.from_numpy(blob))
        return [_alert_key(a) for a in engine.materialize_alerts(batch, out)]

    consumer = bus.consumer("events", "pipeline")
    for record in consumer.poll(2):
        run(eng, decode(record))
    bus.commit(consumer)
    ckpt = tckpt.PipelineCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(eng, bus, consumer_groups=[consumer])
    expected = [run(eng, decode(r)) for r in consumer.poll(10)]
    assert len(expected) == 3 and any(expected)

    fresh = port_engine(jreg, 0)
    bus2 = EventBus(partitions=2, data_dir=str(tmp_path / "bus"))
    replayed = []

    def handler(records):
        replayed.extend(run(fresh, decode(r)) for r in records)

    assert ckpt.recover(fresh, bus2, "events", "pipeline", handler) == 3
    assert sorted(replayed) == sorted(expected)
    assert_same_engines(eng, fresh, "recovered")
    assert bus2.consumer("events", "pipeline").lag() == 0


def test_host_shards_layout_refused_by_both_single_engines(small, tmp_path):
    from test_assemble_checkpoint import _write_host_ckpt

    jreg, eng = small
    blocks = {name: arr[None] for name, arr in
              tckpt._group_arrays(eng.canonical_state()).items()}
    interners = {"devices": eng.packer.devices.snapshot(),
                 "measurements": [None], "alert_types": [None],
                 "tenants": [None]}
    path = _write_host_ckpt(tmp_path / "ckpt-00000000", [0], 1, blocks,
                            interners, 5, rules=[RULES[0]])
    fresh = port_engine(jreg, 0)
    before = fresh.canonical_state()
    with pytest.raises(tckpt.SiteWhereCheckpointError, match="host-shards"):
        tckpt.PipelineCheckpointer(str(tmp_path)).restore(fresh)
    assert fresh.packer.epoch_base_ms == 0
    assert_dataclass_bits_equal(before, fresh.canonical_state(), "untouched")
    with pytest.raises(AttributeError, match="load_local_state_shards"):
        jckpt.PipelineCheckpointer(str(tmp_path)).restore(
            jax_engine(jax_registry()), path)


class StandInGraph:
    """What a captured CUDA graph is to the engine, on the CPU: bound at
    'capture' to the engine's params and state buffers of that moment, it
    replays the step on THOSE buffers and commits the new state into them.
    A restore that rebinds a buffer instead of copying into it leaves the
    stand-in reading the old one."""

    kernel_launches: dict = {}

    def __init__(self, engine):
        self.engine = engine
        self.bound = (engine._params, engine._state, engine._rule_state,
                      engine._model_state, engine._actuation_state)
        self.ptrs = self.pointers()

    def pointers(self):
        return [t.data_ptr() for group in self.bound
                for t in tree_leaves(group)]

    def replay(self, blob):
        params, *groups = self.bound
        eng = self.engine
        *new, out = process_batch(
            params, *groups, blob_to_batch(torch.as_tensor(blob)),
            alert_lane_capacity=eng.alert_lane_capacity,
            command_lane_capacity=eng.command_lane_capacity,
            **eng._step_flags)
        for dst, src in zip(groups, new):
            commit(dst, src)
        return out


@pytest.mark.parametrize("stateful", [False, True], ids=["main", "stateful"])
def test_restore_into_a_captured_engine_copies_in_place(stateful, tmp_path):
    jreg = jax_registry()
    ref = jax_engine(jreg, stateful)
    epoch = ref.packer.epoch_base_ms
    src = port_engine(jreg, epoch, stateful)
    for k in range(CUT):
        step(ref, 840 + k, k)
        step(src, 840 + k, k)
    path = tckpt.PipelineCheckpointer(str(tmp_path)).save(src)
    # the target has captured its step on other traffic first
    tgt = port_engine(jax_registry(), epoch, stateful)
    step(tgt, 990, 0)
    assert not tgt._graphs                   # the CPU never captures ...
    key = step_key(tgt._step_flags, batch_to_blob(pack(tgt, 0, 0)).shape)
    tgt._graphs[key] = graph = StandInGraph(tgt)   # ... so stand in
    tgt.graph_captures = captures = 1
    tckpt.PipelineCheckpointer(str(tmp_path)).restore(tgt, path)
    assert tgt._graphs.get(key) is graph and tgt.graph_captures == captures
    assert graph.pointers() == graph.ptrs
    for k in range(CUT, CUT + AFTER):
        want = step(ref, 840 + k, k)
        assert step(tgt, 840 + k, k) == want == step(src, 840 + k, k)
    assert_same_engines(ref, tgt, "captured target")


def test_pending_alerts_drain_first_like_the_reference():
    """Alerts on the engine's pending list come back at the head of the
    next materialize_alerts, before the step's own, as the JAX engine
    returns them; a lane fetch that runs out of retries keeps them for the
    next one (the port's engine)."""
    from sitewhere_tpu.model.event import DeviceAlert as JAlert
    from sitewhere_tpu_torch.model.event import DeviceAlert as TAlert

    jreg = jax_registry()
    a = jax_engine(jreg)
    b = port_engine(jreg, a.packer.epoch_base_ms)
    stash = [dict(device_id=f"dev-{i}", type="late", message=f"m{i}",
                  event_date=1000 + i) for i in (5, 3, 9)]
    a._pending_alerts.extend(JAlert(**d) for d in stash)
    b._pending_alerts.extend(TAlert(**d) for d in stash)
    got, want = step(b, 870, 0), step(a, 870, 0)
    assert got == want and len(got[0]) > 3
    assert [k[4] for k in got[0][:3]] == ["m5", "m3", "m9"]
    assert a._pending_alerts == b._pending_alerts == []
    b._pending_alerts.extend(TAlert(**d) for d in stash)
    t_faults.arm(t_faults.FaultPlan.from_json({"seed": 3, "rules": [
        {"point": "lane_fetch_error", "times": 3}]}))
    routed, out = b.submit_routed(pack(b, 871, 1))
    with pytest.raises(t_faults.FaultError):
        b.materialize_alerts(routed, out)
    t_faults.disarm()
    assert [x.message for x in b._pending_alerts] == ["m5", "m3", "m9"]
    assert [k[4] for k in step(b, 872, 2)[0][:3]] == ["m5", "m3", "m9"]
