"""The port's step and engine held against the JAX package's, on the CPU.

One world — two tenants, registered and unassigned devices, zones, and
threshold/geofence rules built through the JAX package's control plane —
is mirrored into the port (sitewhere_tpu_torch.convert). The same traffic,
made with numpy from a seed, then runs through:
  - the JAX fused step (the engine's own jitted step, stateful stages off)
    and the port's `process_batch` + `check_presence`, for all three wire
    variants: every output field and state leaf must be bit-equal;
  - the JAX `PipelineEngine` and the port's: the same materialized alerts
    in the same order, the same canonical state, the same presence
    transitions.
Tolerance: none (f32 compared as int32 bit patterns, dtypes included).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops.pack import batch_to_blob as j_batch_to_blob
from sitewhere_tpu.ops.pack import empty_batch as j_empty_batch
from sitewhere_tpu.pipeline.state_tensors import init_device_state_np
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.pipeline import engine as tengine
from sitewhere_tpu_torch.pipeline.step import check_presence, process_batch

D, Z, V = 256, 8, 8          # device capacity, zone table, vertices per zone
B, M, T, K = 128, 4, 4, 32   # batch, measurement slots, tenants, lane capacity
PRESENCE_MS = 500

RULES = [
    {"type": "threshold", "token": "hot", "measurement_name": "m1",
     "operator": ">", "threshold": 90.0, "alert_level": "CRITICAL"},
    {"type": "threshold", "token": "cold-t2", "measurement_name": "m1",
     "operator": "<", "threshold": 5.0, "tenant_token": "t2",
     "alert_type": "cold", "alert_level": "INFO"},
    {"type": "threshold", "token": "eq", "measurement_name": "m2",
     "operator": "==", "threshold": 50.0, "alert_level": "ERROR"},
    {"type": "threshold", "token": "neq-tracker", "measurement_name": "m2",
     "operator": "!=", "threshold": 50.0, "device_type_token": "tracker"},
    {"type": "threshold", "token": "gte", "measurement_name": "m3",
     "operator": ">=", "threshold": 99.0, "alert_message": "m3 high"},
    {"type": "threshold", "token": "zero", "measurement_name": "m3",
     "operator": "==", "threshold": 0.0},
    {"type": "threshold", "token": "any-extreme", "operator": ">",
     "threshold": 99.8, "alert_type": "extreme"},
    {"type": "threshold", "token": "ghost", "operator": ">",
     "threshold": 0.0, "tenant_token": "no-such-tenant"},
    {"type": "geofence", "token": "in-z1", "zone_token": "z1",
     "condition": "inside", "alert_level": "WARNING"},
    {"type": "geofence", "token": "out-z2", "zone_token": "z2",
     "condition": "outside"},
    {"type": "geofence", "token": "in-z5", "zone_token": "z5",
     "condition": "inside", "alert_level": "CRITICAL"},
    {"type": "geofence", "token": "out-z6", "zone_token": "z6",
     "condition": "outside", "alert_level": "INFO"},
    {"type": "geofence", "token": "in-ghost", "zone_token": "no-such-zone",
     "condition": "inside"},
]

BATCH_FIELDS = ("device_idx", "tenant_idx", "event_type", "ts", "mm_idx",
                "value", "lat", "lon", "elevation", "alert_type_idx",
                "alert_level", "valid")


def assert_bits_equal(ref, got, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} != {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}"
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def assert_dataclass_bits_equal(ref, got, what):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(got)], what
    for name in names:
        r, g = getattr(ref, name), getattr(got, name)
        if dataclasses.is_dataclass(r):
            assert_dataclass_bits_equal(r, g, f"{what}.{name}")
        else:
            assert_bits_equal(r, g, f"{what}.{name}")


def _polygon(rng, center, nv):
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    r = rng.uniform(2, 6, nv)
    return [(float(center[0] + a), float(center[1] + b))
            for a, b in zip(r * np.sin(ang), r * np.cos(ang))]


def _jax_params_dict(p):
    def table(t):
        return {f.name: np.asarray(getattr(t, f.name))
                for f in dataclasses.fields(t)}

    return {"assignment_status": np.asarray(p.assignment_status),
            "tenant_idx": np.asarray(p.tenant_idx),
            "area_idx": np.asarray(p.area_idx),
            "device_type_idx": np.asarray(p.device_type_idx),
            "threshold": table(p.threshold), "zones": table(p.zones),
            "geofence": table(p.geofence)}


@pytest.fixture(scope="module")
def world():
    """The JAX world (control plane -> registry mirror -> engine) and the
    port's engine over the same registry snapshot and rules."""
    from sitewhere_tpu.model import (
        Area, Device, DeviceAssignment, DeviceType, Zone)
    from sitewhere_tpu.model.common import Location
    from sitewhere_tpu.pipeline import engine as jengine
    from sitewhere_tpu.registry import DeviceManagement, RegistryTensors

    rng = np.random.default_rng(2024)
    jreg = RegistryTensors(max_devices=D, max_zones=Z, max_zone_vertices=V)
    dms, types, areas = {}, {}, {}
    for tenant in ("t1", "t2"):
        dm = DeviceManagement()
        jreg.attach(dm, tenant)
        dms[tenant] = dm
        types[tenant] = {t: dm.create_device_type(DeviceType(token=t))
                         for t in ("sensor", "tracker")}
        areas[tenant] = dm.create_area(Area(token=f"area-{tenant}"))
    zones = []
    for z in range(1, 7):
        tenant = "t1" if z <= 4 else "t2"
        poly = _polygon(rng, rng.uniform(0, 10, 2), int(rng.integers(3, V + 1)))
        zones.append((f"z{z}", tenant, poly))
        dms[tenant].create_zone(Zone(
            token=f"z{z}", area_id=areas[tenant].id,
            bounds=[Location(lat, lon) for lat, lon in poly]))
    # index 1: a device with no active assignment; 2..255 registered, so
    # the last row (D-1) is ACTIVE — what a clamped out-of-range gather reads
    dm = dms["t1"]
    dm.create_device(Device(token="dev-unassigned",
                            device_type_id=types["t1"]["sensor"].id))
    for i in range(2, D):
        tenant = "t1" if i < 150 else "t2"
        dm = dms[tenant]
        device = dm.create_device(Device(
            token=f"dev-{i}",
            device_type_id=types[tenant]["tracker" if i % 3 == 0
                                         else "sensor"].id))
        dm.create_device_assignment(DeviceAssignment(
            token=f"as-{i}", device_id=device.id,
            area_id=areas[tenant].id))

    kwargs = dict(batch_size=B, measurement_slots=M, max_tenants=T,
                  max_threshold_rules=16, max_geofence_rules=8,
                  alert_lane_capacity=K,
                  presence_missing_interval_ms=PRESENCE_MS)
    jeng = jengine.PipelineEngine(jreg, name="torch-parity-ref", **kwargs)
    treg = convert.registry_from_snapshot(
        dataclasses.asdict(jreg.snapshot()),
        jreg.devices.snapshot(), jreg.tenants.snapshot(),
        device_type_tokens=jreg.device_types.snapshot(),
        zone_tokens=jreg.zones_interner.snapshot(),
        area_tokens=jreg.areas.snapshot(),
        assignment_tokens=jreg.assignments.snapshot())
    teng = tengine.PipelineEngine(treg, device="cpu", **kwargs)
    teng.packer.epoch_base_ms = jeng.packer.epoch_base_ms
    for eng, mod in ((jeng, jengine), (teng, tengine)):
        for name in ("m1", "m2", "m3"):
            eng.packer.measurements.intern(name)
        for spec in RULES:
            eng.upsert_rule(*mod.rule_from_dict(dict(spec)))
        eng.start()
    return {"jreg": jreg, "jeng": jeng, "treg": treg, "teng": teng,
            "zones": zones}


def test_registry_mirror_matches_control_plane_mirror(world):
    """The port's row-taking mirror (mirror_devices / mirror_zone) builds
    the same columns and interner indices as the reference's mirror of the
    same control-plane world, padding included."""
    from sitewhere_tpu_torch.registry import RegistryTensors

    reg = RegistryTensors(max_devices=D, max_zones=Z, max_zone_vertices=V)
    for token, tenant, poly in world["zones"]:
        reg.mirror_zone(token, tenant, poly, area=f"area-{tenant}")
    reg.mirror_devices(["dev-unassigned"], "t1", "sensor", status=0)
    ids = range(2, D)
    reg.mirror_devices(
        [f"dev-{i}" for i in ids],
        tenant=["t1" if i < 150 else "t2" for i in ids],
        device_type=["tracker" if i % 3 == 0 else "sensor" for i in ids],
        area=[f"area-{'t1' if i < 150 else 't2'}" for i in ids])
    ref = dataclasses.asdict(world["jreg"].snapshot())
    got = dataclasses.asdict(reg.snapshot())
    for name in ref:
        if name != "version":
            assert_bits_equal(ref[name], got[name], name)
    jreg = world["jreg"]
    for j, t in ((jreg.devices, reg.devices), (jreg.tenants, reg.tenants),
                 (jreg.device_types, reg.device_types),
                 (jreg.zones_interner, reg.zones_interner),
                 (jreg.areas, reg.areas)):
        assert t.snapshot() == j.snapshot(), j.name


def make_cols(seed, variant, n=B - 9, oob=False):
    """One batch of traffic (relative ts) for a wire variant. Devices
    include unknown (0) rows, and with `oob` rows past the device capacity
    (up to the wire field's 2^22 - 1)."""
    rng = np.random.default_rng(seed)
    dev = rng.integers(0, D, n)
    dev[rng.random(n) < 0.08] = 0
    if oob:
        dev[:6] = [D, D + 1, D + 77, 2 ** 22 - 1, 4000, D]
    if variant == "packed":
        et = rng.choice([0, 0, 0, 2, 4], n)
    else:
        et = rng.choice([0, 0, 0, 1, 1, 2, 5], n)
    is_meas, is_loc, is_alert = et == 0, et == 1, et == 2
    value = rng.uniform(0, 100, n).astype(np.float32)
    special = rng.random(n)
    value[special < 0.06] = 50.0
    value[(special >= 0.06) & (special < 0.1)] = np.nan
    value[(special >= 0.1) & (special < 0.13)] = np.float32(1e-45)
    value[(special >= 0.13) & (special < 0.15)] = 99.9
    # few distinct timestamps: equal-ts ties inside a device's rows
    ts = (rng.integers(0, 40, n) * 25).astype(np.int32)
    cols = {
        "device_idx": dev.astype(np.int32),
        "tenant_idx": np.zeros(n, np.int32),
        "event_type": et.astype(np.int32),
        "ts": ts,
        "mm_idx": np.where(is_meas, rng.choice([0, 1, 2, 3, 5], n),
                           0).astype(np.int32),
        "value": np.where(is_meas, value, 0).astype(np.float32),
        "lat": np.where(is_loc, rng.uniform(-5, 15, n), 0).astype(np.float32),
        "lon": np.where(is_loc, rng.uniform(-5, 15, n), 0).astype(np.float32),
        "elevation": (np.where(is_loc, rng.uniform(1, 50, n), 0)
                      .astype(np.float32) if variant == "full"
                      else np.zeros(n, np.float32)),
        "alert_type_idx": np.where(is_alert, rng.integers(0, 9, n),
                                   0).astype(np.int32),
        "alert_level": np.where(is_alert, rng.integers(0, 4, n),
                                0).astype(np.int32),
        "valid": np.ones(n, bool),
    }
    return cols


def pad_to_batch(cols):
    """JAX EventBatch (numpy) padded to B rows, as the packer pads."""
    n = len(cols["device_idx"])
    out = j_empty_batch(B)
    padded = {}
    for name in BATCH_FIELDS:
        col = np.array(getattr(out, name))
        col[:n] = cols[name]
        padded[name] = col
    return out.replace(**padded)


_ROWS = {"full": 5, "compact": 4, "packed": 3}


def _blob_for(cols, variant):
    jb = pad_to_batch(cols)
    blob = j_batch_to_blob(jb)
    assert blob.shape[0] == _ROWS[variant]
    tb = tpack.EventBatch(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                             for k in BATCH_FIELDS})
    assert tpack.batch_to_blob(tb).tobytes() == blob.tobytes()
    return blob


def _run_step_trace(world, blobs, now_rel):
    """Both steps over `blobs` from fresh state, then one presence sweep at
    `now_rel`; asserts bit-equality after every step."""
    jeng = world["jeng"]
    jparams = jeng._ensure_params()
    tparams = convert.params_from_numpy(_jax_params_dict(jparams), "cpu")
    s_np = init_device_state_np(D, M, T)
    jstate = jnp_tree(s_np)
    tstate = convert.state_from_numpy(dataclasses.asdict(s_np), "cpu")
    rs, ms, acts = jeng._rule_state, jeng._model_state, jeng._actuation_state
    for step, blob in enumerate(blobs):
        jstate, rs, ms, acts, jout = jeng._step_blob(
            jparams, jstate, rs, ms, acts, jnp.asarray(blob))
        tstate, _, _, _, tout = process_batch(
            tparams, tstate, None, None, None,
            tpack.blob_to_batch(torch.from_numpy(blob)),
            alert_lane_capacity=K)
        assert_dataclass_bits_equal(jout, tout, f"step {step} outputs")
        assert_dataclass_bits_equal(jstate, tstate, f"step {step} state")
    jeng._rule_state, jeng._model_state = rs, ms
    jeng._actuation_state = acts
    registered = np.asarray(jparams.assignment_status) == 1
    jstate, jmissing = jeng._presence(jstate, jnp.asarray(registered),
                                      np.int32(now_rel), np.int32(PRESENCE_MS))
    tstate, tmissing = check_presence(tstate, torch.from_numpy(registered),
                                      now_rel, PRESENCE_MS)
    assert_bits_equal(jmissing, tmissing, "newly_missing")
    assert_dataclass_bits_equal(jstate, tstate, "state after presence")
    return np.asarray(jout.alert_lanes), np.asarray(jmissing)


def jnp_tree(state_np):
    return dataclasses.replace(state_np, **{
        f.name: jnp.asarray(getattr(state_np, f.name))
        for f in dataclasses.fields(state_np)})


@pytest.mark.parametrize("variant", ["full", "compact", "packed"])
def test_step_trace_bit_equal(world, variant):
    seed0 = {"full": 100, "compact": 200, "packed": 300}[variant]
    blobs = [_blob_for(make_cols(seed0 + s, variant, oob=(s == 1)), variant)
             for s in range(3)]
    lanes, missing = _run_step_trace(world, blobs, now_rel=900)
    assert lanes[3, 0] > 0            # the rules fired
    assert missing.any() and not missing.all()


def test_out_of_range_device_index_matches_xla_clamp(world):
    """Device indices >= D ride the wire (22-bit field). XLA clamps such a
    gather to row D-1 (here an ACTIVE device), so the rows count as valid
    events of D-1's tenant and fire rules, while the folds drop them; the
    port clamps explicitly and must agree."""
    cols = make_cols(7, "compact", oob=True)
    assert (cols["device_idx"] >= D).sum() == 6
    blob = _blob_for(cols, "compact")
    _run_step_trace(world, [blob], now_rel=0)
    tparams = convert.params_from_numpy(
        _jax_params_dict(world["jeng"]._ensure_params()), "cpu")
    tstate = convert.state_from_numpy(
        dataclasses.asdict(init_device_state_np(D, M, T)), "cpu")
    *_, out = process_batch(tparams, tstate, None, None, None,
                            tpack.blob_to_batch(torch.from_numpy(blob)),
                            alert_lane_capacity=K)
    assert out.valid[:6].all()        # gathered status of row D-1
    with pytest.raises(IndexError):   # what unclamped torch indexing does
        tparams.assignment_status[torch.from_numpy(cols["device_idx"][:6])
                                  .long()]


def _alert_key(a):
    return (a.device_id, int(a.source), int(a.level), a.type, a.message,
            a.event_date)


def test_engine_differential(world, monkeypatch):
    """Same multi-batch trace through both engines: identical alerts (in
    order), canonical state, presence transitions, device-state reads and
    stats. The clock is pinned and both packers share epoch_base_ms."""
    import time

    jeng, teng = world["jeng"], world["teng"]
    assert_dataclass_bits_equal(
        convert.params_from_numpy(_jax_params_dict(jeng._ensure_params()),
                                  "cpu"),
        teng._ensure_params(), "compiled params")
    init = init_device_state_np(D, M, T)
    jeng.load_canonical_state(init)
    teng.load_canonical_state(convert.state_from_numpy(
        dataclasses.asdict(init), "cpu"))
    base = jeng.packer.epoch_base_ms
    trace = [("compact", 400), ("packed", 401), ("full", 402),
             ("compact", 403), ("packed", 404)]
    n_alerts = 0
    for variant, seed in trace:
        cols = make_cols(seed, variant)
        args = (cols["device_idx"], cols["event_type"],
                base + cols["ts"].astype(np.int64))
        kw = {k: cols[k] for k in ("mm_idx", "value", "lat", "lon",
                                   "elevation", "alert_type_idx",
                                   "alert_level")}
        jb, out_j = jeng.submit_routed(jeng.packer.pack_columns(*args, **kw))
        tb, out_t = teng.submit_routed(teng.packer.pack_columns(*args, **kw))
        ja = jeng.materialize_alerts(jb, out_j)
        ta = teng.materialize_alerts(tb, out_t)
        assert [_alert_key(a) for a in ta] == [_alert_key(a) for a in ja]
        n_alerts += len(ta)
    assert n_alerts > 0
    assert teng.alerts_dropped == jeng.alerts_dropped > 0   # storms overflow K
    assert teng.d2h_fetches == 2 * len(trace)
    assert_dataclass_bits_equal(jeng.canonical_state(),
                                teng.canonical_state(), "canonical state")
    # the numpy interchange form carries the same bits both ways
    as_numpy = convert.state_to_numpy(teng.canonical_state())
    ref = dataclasses.asdict(jeng.canonical_state())
    assert sorted(as_numpy) == sorted(ref)
    for name, arr in as_numpy.items():
        assert_bits_equal(ref[name], arr, f"state_to_numpy.{name}")
    assert_dataclass_bits_equal(
        jeng.canonical_state(), convert.state_from_numpy(as_numpy, "cpu"),
        "state_from_numpy")
    for token in ("dev-2", "dev-3", "dev-151", "dev-unassigned", "nobody"):
        js, ts_ = jeng.get_device_state(token), teng.get_device_state(token)
        if js is None:
            assert ts_ is None
            continue
        for name in ("device_id", "last_interaction_date",
                     "presence_missing_date", "presence",
                     "last_measurements", "last_location", "last_alerts"):
            # repr: NaN readings compare equal by their printed value
            assert repr(getattr(ts_, name)) == repr(getattr(js, name)), \
                (token, name)
    js, ts_ = jeng.stats(), teng.stats()
    for key in ("batches", "tenant_event_count", "tenant_alert_count"):
        assert ts_[key] == js[key], key

    # presence: all events lie in [base, base + 975]; at base + 1000 the
    # devices last seen before base + 500 turn missing, once
    monkeypatch.setattr(time, "time", lambda: (base + 1000) / 1000.0)
    j_missing = jeng.presence_sweep()
    t_missing = teng.presence_sweep()
    assert t_missing == j_missing and t_missing
    assert teng.presence_sweep() == jeng.presence_sweep() == []
    assert_dataclass_bits_equal(jeng.canonical_state(),
                                teng.canonical_state(), "after presence")


def test_rule_crud_and_dict_round_trip(world):
    from sitewhere_tpu.pipeline import engine as jengine
    from sitewhere_tpu_torch.errors import DuplicateTokenError

    for spec in RULES:
        kind, rule = tengine.rule_from_dict(dict(spec))
        jkind, jrule = jengine.rule_from_dict(dict(spec))
        assert kind == jkind
        assert tengine.rule_to_dict(kind, rule) == \
            jengine.rule_to_dict(jkind, jrule)
    teng = world["teng"]
    kind, rule = teng.get_rule("hot")
    assert kind == "threshold" and rule.threshold == 90.0
    with pytest.raises(DuplicateTokenError):
        teng.create_rule("threshold", rule)
    version = teng._rules_version
    assert teng.remove_rule("in-ghost")
    assert not teng.remove_rule("in-ghost")
    teng.add_geofence_rule(tengine.rule_from_dict(
        dict(RULES[-1]))[1])
    assert teng._rules_version == version + 2
    assert [r.token for r in teng.list_rules()["geofence"]] == \
        [r["token"] for r in RULES if r["type"] == "geofence"]
