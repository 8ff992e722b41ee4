"""The port's ingest host tier end to end, held against the JAX package's on
the CPU.

One world is built twice, once through each package's control plane
(DeviceManagement attached to the registry mirror, same creation order),
with the same rules and epoch. Then:
  - the bulk lane: the same wire bytes — hot frames for registered,
    unassigned and unknown devices, empty and new measurement names,
    REGISTER control frames, deliveries cut mid-frame so the remainder
    path runs — through the JAX `BulkWireIngestService` and the port's, the
    port's both inline and through its persistence worker. Canonical state,
    the event log's columns (all but the per-process id prefix, the
    wall-clock received date, and a persisted alert's random id), the
    persisted rule alerts, the unregistered-device records and the
    forwarded control frames must be identical (the tests/test_native.py
    bulk scenario, held against the JAX run);
  - the object path: the same decoded requests through both packages'
    `InboundProcessingService`, persistence triggers and
    `PayloadEnrichment`: persisted events, rule alerts and enriched
    payloads must be identical.
Tolerance: none (f32 compared as bit patterns).
"""

import dataclasses
import time

import msgpack
import numpy as np
import pytest

import sitewhere_tpu.model as jmodel
import sitewhere_tpu.model.common as jcommon
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.persist.event_management as jem
import sitewhere_tpu.persist.eventlog as jeventlog
import sitewhere_tpu.pipeline.engine as jengine
import sitewhere_tpu.pipeline.enrichment as jenrich
import sitewhere_tpu.pipeline.inbound as jinbound
import sitewhere_tpu.registry as jregistry
import sitewhere_tpu.runtime.bus as jbus
import sitewhere_tpu.sources.fastlane as jfast
import sitewhere_tpu_torch.model as tmodel
import sitewhere_tpu_torch.model.common as tcommon
import sitewhere_tpu_torch.model.event as tevent
import sitewhere_tpu_torch.persist.event_management as tem
import sitewhere_tpu_torch.persist.eventlog as teventlog
import sitewhere_tpu_torch.pipeline.engine as tengine
import sitewhere_tpu_torch.pipeline.enrichment as tenrich
import sitewhere_tpu_torch.pipeline.inbound as tinbound
import sitewhere_tpu_torch.registry as tregistry
import sitewhere_tpu_torch.registry.store as tstore
import sitewhere_tpu_torch.runtime.bus as tbus
import sitewhere_tpu_torch.sources.fastlane as tfast
from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireCodec, encode_frame)
from test_torch_pipeline import assert_dataclass_bits_equal

D, Z, V, B, M = 128, 4, 8, 64, 8
TENANT = "t1"
RULES = [
    {"type": "threshold", "token": "hot", "measurement_name": "m1",
     "operator": ">", "threshold": 90.0, "alert_level": "CRITICAL"},
    {"type": "threshold", "token": "any", "operator": ">",
     "threshold": 99.5, "alert_type": "extreme"},
    {"type": "geofence", "token": "in-z1", "zone_token": "z1",
     "condition": "inside", "alert_level": "WARNING"},
    {"type": "geofence", "token": "out-z2", "zone_token": "z2",
     "condition": "outside"},
]
PKG = {
    "jax": dict(model=jmodel, common=jcommon, event=jevent, em=jem,
                eventlog=jeventlog, engine=jengine, enrich=jenrich,
                inbound=jinbound, bus=jbus, fast=jfast,
                DeviceManagement=jregistry.DeviceManagement,
                RegistryTensors=jregistry.RegistryTensors, kw={}),
    "port": dict(model=tmodel, common=tcommon, event=tevent, em=tem,
                 eventlog=teventlog, engine=tengine, enrich=tenrich,
                 inbound=tinbound, bus=tbus, fast=tfast,
                 DeviceManagement=tstore.DeviceManagement,
                 RegistryTensors=tregistry.RegistryTensors,
                 kw={"device": "cpu"}),
}


def _build(pkg, name, epoch):
    """The world through `pkg`'s control plane, and a started engine."""
    p = PKG[pkg]
    mdl = p["model"]
    rng = np.random.default_rng(7)
    dm = p["DeviceManagement"]()
    reg = p["RegistryTensors"](max_devices=D, max_zones=Z,
                               max_zone_vertices=V)
    reg.attach(dm, TENANT)
    types = {t: dm.create_device_type(mdl.DeviceType(token=t))
             for t in ("sensor", "tracker")}
    area = dm.create_area(mdl.Area(token="area-1"))
    for z in (1, 2):
        c = rng.uniform(0, 10, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
        dm.create_zone(mdl.Zone(token=f"z{z}", area_id=area.id, bounds=[
            p["common"].Location(float(c[0] + 4 * np.sin(a)),
                                 float(c[1] + 4 * np.cos(a)))
            for a in ang]))
    dm.create_device(mdl.Device(token="dev-unassigned",
                                device_type_id=types["sensor"].id))
    for i in range(2, 60):
        d = dm.create_device(mdl.Device(
            token=f"dev-{i}",
            device_type_id=types["tracker" if i % 3 == 0 else "sensor"].id))
        dm.create_device_assignment(mdl.DeviceAssignment(
            token=f"as-{i}", device_id=d.id, area_id=area.id))
    eng = p["engine"].PipelineEngine(
        reg, batch_size=B, measurement_slots=M, max_tenants=4,
        max_threshold_rules=8, max_geofence_rules=8, alert_lane_capacity=32,
        name=name, **p["kw"])
    eng.packer.epoch_base_ms = epoch
    for spec in RULES:
        eng.upsert_rule(*p["engine"].rule_from_dict(dict(spec)))
    eng.start()
    return dm, reg, eng


@pytest.fixture(scope="module")
def world():
    epoch = int(time.time() * 1000) - 5000
    return {"epoch": epoch,
            "jax": _build("jax", "ingest-parity-ref", epoch),
            "inline": _build("port", "ingest-parity-inline", epoch),
            "worker": _build("port", "ingest-parity-worker", epoch)}


def _stream(epoch, seed=3, n=330):
    """Wire bytes: hot frames (three segments: measurements and alerts
    only, then locations without and with elevation) and REGISTER frames;
    returns (bytes, the tokens the registry does not validate, the
    REGISTER frames)."""
    rng = np.random.default_rng(seed)
    frames, unregistered, registers = [], [], []
    for i in range(n):
        if i % 40 == 17:
            reg = encode_frame(MessageType.REGISTER, WireCodec.encode_register(
                f"new-{i}", "sensor", area_token="area-1"))
            frames.append(reg)
            registers.append(reg)
        r = rng.random()
        token = (f"ghost-{i}" if r < 0.04 else "dev-unassigned"
                 if r < 0.07 else f"dev-{int(rng.integers(2, 60))}")
        if r < 0.07:
            unregistered.append(token)
        ts = epoch + int(rng.integers(0, 900))
        segment = i * 3 // n
        kind = rng.choice(3, p=[0.6, 0.3, 0.1])
        if kind == 1 and segment == 0:
            kind = 0
        if kind == 0:
            value = float(rng.choice([rng.uniform(0, 100), 99.9, np.nan,
                                      95.0]))
            name = str(rng.choice(["m1", "m1", "m2", "", "m-new"]))
            frames.append(encode_frame(MessageType.MEASUREMENT,
                                       WireCodec.encode_measurement(
                                           token, ts, name, value)))
        elif kind == 1:
            frames.append(encode_frame(MessageType.LOCATION,
                                       WireCodec.encode_location(
                                           token, ts,
                                           float(rng.uniform(-5, 15)),
                                           float(rng.uniform(-5, 15)),
                                           float(rng.uniform(1, 9))
                                           if segment == 2 else 0.0)))
        else:
            frames.append(encode_frame(MessageType.ALERT,
                                       WireCodec.encode_alert(
                                           token, ts,
                                           str(rng.choice(["door", "",
                                                           "smoke"])),
                                           int(rng.integers(0, 4)),
                                           "from device")))
    return b"".join(frames), unregistered, registers


def _deliveries(data):
    """Cut the stream into deliveries at offsets inside frames."""
    cuts = [0, 1001, len(data) // 3 + 3, 2 * len(data) // 3 + 5, len(data)]
    return [data[a:b] for a, b in zip(cuts, cuts[1:])]


def _topic_values(bus, name):
    out = []
    for part in bus.topic(name).partitions:
        out.extend(v for _, _, v, _ in part.read(0, 10_000))
    return out


LOG_SKIP = ("id", "id_prefix", "received_date")
LOG_NAMES = [n for n in teventlog._COLUMNS if n not in LOG_SKIP]


def _tokens_for_ids(dm):
    """A package's entity ids (uuids, random per store) -> their tokens."""
    return {e.id: e.token for store in (dm.devices, dm.device_types,
                                         dm.areas)
            for e in store.all()}


def _tokenized(value, ids):
    if isinstance(value, dict):
        return {k: _tokenized(v, ids) for k, v in value.items()}
    return ids.get(value, value) if isinstance(value, str) else value


def _log_rows(log, eventlog, ids):
    """Every row of the tenant's log in query order: each column but the
    ones LOG_SKIP names (a persisted rule alert's id is random too), f32 as
    bits, entity ids as tokens; id_seq relative to the log's first."""
    names = LOG_NAMES
    cols = log.query_columns(TENANT, eventlog.EventFilter(), names)
    n = len(cols["event_type"])
    seq = np.asarray(cols["id_seq"])
    cols["id_seq"] = seq - seq.min()
    rows = []
    for i in range(n):
        row = []
        for name in names:
            v = np.asarray(cols[name])[i]
            if isinstance(v, np.floating):
                v = int(np.float32(v).view(np.int32))
            row.append(_tokenized(v.item() if isinstance(v, np.generic)
                                  else v, ids))
        rows.append(tuple(row))
    return rows


def _run_bulk(world, side, data, worker=False):
    kind = "jax" if side == "jax" else "port"
    p = PKG[kind]
    dm, reg, eng = world[side]
    naming = p["bus"].TopicNaming()
    bus = p["bus"].EventBus(partitions=1)
    log = p["eventlog"].ColumnarEventLog(segment_rows=64)
    events = p["em"].DeviceEventManagement(log, registry=dm, tenant=TENANT)
    controls = []
    svc = p["fast"].BulkWireIngestService(
        eng, eventlog=log, events=events, bus=bus, tenant=TENANT,
        naming=naming, registry=dm, persist_async=worker,
        control_sink=lambda frame, meta: controls.append(frame))
    svc.start()
    for part in _deliveries(data):
        svc.on_encoded_event_received(part)
    if worker:
        svc.persister.flush()
    svc.stop()
    assert svc._remainder == b"" and svc.failed_counter.value == 0
    return {"log": log, "bus": bus, "naming": naming, "controls": controls,
            "svc": svc}


def test_bulk_lane_matches_jax(world, monkeypatch):
    from sitewhere_tpu_torch.ops import pack as tpack

    layouts = []
    variant = tpack.wire_variant_for
    monkeypatch.setattr(tpack, "wire_variant_for", lambda b: layouts.append(
        variant(b)[0]) or variant(b))
    data, unregistered, registers = _stream(world["epoch"])
    ref = _run_bulk(world, "jax", data)
    got = _run_bulk(world, "inline", data)
    # the deliveries ran every wire layout: packed, compact and full
    assert sorted(set(layouts)) == [3, 4, 5]
    wrk = _run_bulk(world, "worker", data, worker=True)
    jeng = world["jax"][2]
    for run, side in ((got, "inline"), (wrk, "worker")):
        teng = world[side][2]
        assert run["controls"] == ref["controls"] == registers
        topic = run["naming"].inbound_unregistered_device_events(TENANT)
        assert _topic_values(run["bus"], topic) == _topic_values(
            ref["bus"], topic) == [t.encode() for t in unregistered]
        assert_dataclass_bits_equal(jeng.canonical_state(),
                                    teng.canonical_state(), side)
        assert teng.batches_processed == jeng.batches_processed > 0
        assert teng.packer.measurements.snapshot() == \
            jeng.packer.measurements.snapshot()
        assert teng.packer.alert_types.snapshot() == \
            jeng.packer.alert_types.snapshot()
        for key in ("tenant_event_count", "tenant_alert_count"):
            assert teng.stats()[key] == jeng.stats()[key], key
    ids = {side: _tokens_for_ids(world[side][0])
           for side in ("jax", "inline", "worker")}
    want = _log_rows(ref["log"], jeventlog, ids["jax"])
    # the rule alerts the services persisted (source SYSTEM)
    alerts = [r for r in want if r[LOG_NAMES.index("alert_source")] == 1]
    assert len(want) > 330 and len(alerts) > 0
    assert _log_rows(got["log"], teventlog, ids["inline"]) == want
    # on the worker, hot rows and alert rows interleave in another order:
    # the same rows, and bulk ids still one contiguous sequence
    rows = _log_rows(wrk["log"], teventlog, ids["worker"])
    seq = LOG_NAMES.index("id_seq")
    strip = lambda rs: sorted(repr(r[:seq] + r[seq + 1:]) for r in rs)  # noqa
    assert strip(rows) == strip(want)
    assert sorted(r[seq] for r in rows) == list(range(len(rows)))
    markers = [msgpack.unpackb(v, raw=False) for v in _topic_values(
        wrk["bus"], wrk["naming"].inbound_enriched_batches(TENANT))]
    assert sum(m["n"] for m in markers) == \
        wrk["log"].count(TENANT) - len(alerts)


def _requests(epoch, ev):
    """Decoded-request records (sources/manager's msgpack form) with fixed
    event ids, for registered, unassigned and unknown devices."""
    rng = np.random.default_rng(11)
    out = []
    for k in range(24):
        token = ("ghost-x" if k == 5 else "dev-unassigned" if k == 9
                 else f"dev-{int(rng.integers(2, 60))}")
        ts = epoch + 1000 + k
        batch = ev.DeviceEventBatch(
            device_token=token,
            measurements=[ev.DeviceMeasurement(
                id=f"m-{k}", name=str(rng.choice(["m1", "m2"])),
                value=float(rng.choice([50.0, 97.5, 99.9])),
                event_date=ts, received_date=ts)],
            locations=[ev.DeviceLocation(
                id=f"l-{k}", latitude=float(rng.uniform(-5, 15)),
                longitude=float(rng.uniform(-5, 15)), event_date=ts,
                received_date=ts)] if k % 2 else [],
            alerts=[ev.DeviceAlert(id=f"a-{k}", type="door", level=2,
                                   message="open", event_date=ts,
                                   received_date=ts)] if k % 5 == 0 else [])
        out.append(msgpack.packb({
            "sourceId": "src", "deviceToken": token,
            "kind": "DeviceEventBatch",
            "request": jcommon._asdict(batch), "metadata": {}},
            use_bin_type=True))
    return out


def _normal(d):
    """An event's dict without the wall-clock received date; a rule
    alert's random id dropped too."""
    d = dict(d)
    d.pop("received_date", None)
    if d.get("source") not in (None, 0):
        d.pop("id", None)
    return d


def _run_inbound(world, side, records):
    kind = "jax" if side == "jax" else "port"
    p = PKG[kind]
    dm, reg, eng = world[side]
    naming = p["bus"].TopicNaming()
    bus = p["bus"].EventBus(partitions=1)
    log = p["eventlog"].ColumnarEventLog(segment_rows=64)
    events = p["em"].DeviceEventManagement(
        log, registry=dm, tenant=TENANT, device_interner=eng.packer.devices)
    p["em"].EventPersistenceTriggers(bus, naming, TENANT).attach(events)
    inbound = p["inbound"].InboundProcessingService(
        bus, dm, events=events, engine=eng, tenant=TENANT, naming=naming)
    enrich = p["enrich"].PayloadEnrichment(bus, dm, tenant=TENANT,
                                           naming=naming)
    decoded = naming.event_source_decoded_events(TENANT)
    for value in records:
        bus.publish(decoded, b"k", value)
    inbound.process(bus.consumer(decoded, "drill").poll())
    enrich._process(bus.consumer(naming.inbound_persisted_events(TENANT),
                                 "drill").poll())
    page = p["common"].SearchCriteria(page_size=1000)
    ids = _tokens_for_ids(dm)
    persisted = [_tokenized(_normal(dataclasses.asdict(e)), ids)
                 for e in log.query(TENANT, p["eventlog"].EventFilter(),
                                    page).results]
    enriched = []
    for value in _topic_values(bus, naming.inbound_enriched_events(TENANT)):
        ctx, ev = p["enrich"].unpack_enriched(value)
        enriched.append((_tokenized(dataclasses.asdict(ctx), ids),
                         _tokenized(_normal(dataclasses.asdict(ev)), ids)))
    unreg = _topic_values(bus, naming.inbound_unregistered_device_events(
        TENANT))
    return persisted, enriched, unreg, inbound


def test_inbound_and_enrichment_match_jax(world):
    records = _requests(world["epoch"], jevent)
    ref = _run_inbound(world, "jax", records)
    got = _run_inbound(world, "inline", records)
    persisted, enriched, unreg, inbound = got
    assert persisted == ref[0]
    assert enriched == ref[1]
    assert unreg == ref[2] and len(unreg) == 2
    assert inbound.failed_counter.value == 0
    rule_alerts = [e for e in persisted if e.get("source") == 1]
    assert rule_alerts and len(enriched) == len(persisted)
    assert_dataclass_bits_equal(world["jax"][2].canonical_state(),
                                world["inline"][2].canonical_state(),
                                "after inbound")
