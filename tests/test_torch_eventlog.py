"""The port's event store (sitewhere_tpu_torch/persist/eventlog.py with
event_management.py, datastore.py, runtime/deadletter.py and the registry
store) held against the JAX package's, on the CPU.

The reference's own scenarios run against the port: tests/test_persist.py
TestEventLog and TestTriggers, tests/test_datastore.py's config and manager
tests, and tests/test_deadletter.py's replay targets — the reference test
functions themselves, with the names they import rebound to the port's
classes. The instance-backed reference tests (they need the instance, a
later slice) are replaced by a port drill of the same operator loop:
park -> list -> inspect -> replay -> reingest through the port's inbound
service. Then the two packages against each other: Parquet segments
written by one load in the other (the old layout without id columns
included), and the same packed batch appends to identical columns.
Tolerance: none.
"""

import dataclasses
import inspect
import os
import time
import types

import msgpack
import numpy as np
import pytest
import torch

import sitewhere_tpu.ops.pack as jpack
import sitewhere_tpu.persist as jpersist
import sitewhere_tpu.registry.interning as jinterning
import sitewhere_tpu.runtime.bus as jbus
import test_datastore as ref_datastore
import test_deadletter as ref_deadletter
import test_persist as ref_persist
from sitewhere_tpu.persist import eventlog as jeventlog
from sitewhere_tpu_torch import model as tmodel
from sitewhere_tpu_torch.model import common as tcommon
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.persist import datastore as tdatastore
from sitewhere_tpu_torch.persist import event_management as tem
from sitewhere_tpu_torch.persist import eventlog as teventlog
from sitewhere_tpu_torch.registry import interning as tinterning
from sitewhere_tpu_torch.registry import store as tstore
from sitewhere_tpu_torch.runtime import bus as tbus
from sitewhere_tpu_torch.runtime import deadletter as tdeadletter

PERSIST_NAMES = {
    **{n: getattr(tmodel, n) for n in (
        "AlertLevel", "Area", "Device", "DeviceAssignment", "DeviceType",
        "Zone")},
    **{n: getattr(tcommon, n) for n in (
        "DateRangeCriteria", "Location", "SearchCriteria")},
    **{n: getattr(tevent, n) for n in (
        "DeviceAlert", "DeviceCommandInvocation", "DeviceCommandResponse",
        "DeviceEventBatch", "DeviceEventType", "DeviceLocation",
        "DeviceMeasurement", "DeviceStateChange", "DeviceStreamData")},
    "ColumnarEventLog": teventlog.ColumnarEventLog,
    "EventFilter": teventlog.EventFilter,
    "DeviceEventManagement": tem.DeviceEventManagement,
    "EventIndex": tem.EventIndex,
    "EventPersistenceTriggers": tem.EventPersistenceTriggers,
    "DeviceManagement": tstore.DeviceManagement,
}
PERSIST_SCENARIOS = sorted(
    (cls, name) for cls in ("TestEventLog", "TestTriggers")
    for name in dir(getattr(ref_persist, cls)) if name.startswith("test_"))
DATASTORE_SCENARIOS = sorted(
    (cls, name) for cls in ("TestDatastoreConfig",
                            "TestTenantDatastoreManager")
    for name in dir(getattr(ref_datastore, cls))
    if name.startswith("test_") and "instance" not in name)


def _port_world():
    """tests/test_persist.py's `world` fixture, on the port's classes."""
    dm = tstore.DeviceManagement()
    dtype = dm.create_device_type(tmodel.DeviceType(token="sensor"))
    area = dm.create_area(tmodel.Area(token="area-1"))
    devices, assignments = [], []
    for i in range(4):
        device = dm.create_device(tmodel.Device(token=f"dev-{i}",
                                                device_type_id=dtype.id))
        assignments.append(dm.create_device_assignment(
            tmodel.DeviceAssignment(token=f"as-{i}", device_id=device.id,
                                    area_id=area.id)))
        devices.append(device)
    return dm, devices, assignments


def _call(fn, tmp_path, monkeypatch):
    fixtures = {"world": _port_world, "tmp_data_dir": lambda: str(
        tmp_path / "swtpu-data"), "tmp_path": lambda: tmp_path,
        "monkeypatch": lambda: monkeypatch}
    return fn(**{name: fixtures[name]()
                 for name in inspect.signature(fn).parameters})


def test_every_reference_scenario_is_covered():
    assert len(PERSIST_SCENARIOS) == 19 and len(DATASTORE_SCENARIOS) == 6


@pytest.mark.parametrize("cls,name", PERSIST_SCENARIOS)
def test_persist_scenario_on_the_port(cls, name, monkeypatch, tmp_path):
    for attr, value in PERSIST_NAMES.items():
        monkeypatch.setattr(ref_persist, attr, value)
    # names the scenarios import inside their bodies find the port's
    monkeypatch.setattr(jpack, "EventPacker", tpack.EventPacker)
    monkeypatch.setattr(jinterning, "TokenInterner",
                        tinterning.TokenInterner)
    monkeypatch.setattr(jpersist, "eventlog", teventlog)
    monkeypatch.setattr(jbus, "EventBus", tbus.EventBus)
    monkeypatch.setattr(jbus, "TopicNaming", tbus.TopicNaming)
    _call(getattr(getattr(ref_persist, cls)(), name), tmp_path, monkeypatch)


@pytest.mark.parametrize("cls,name", DATASTORE_SCENARIOS)
def test_datastore_scenario_on_the_port(cls, name, monkeypatch, tmp_path):
    monkeypatch.setattr(ref_datastore, "DeviceMeasurement",
                        tevent.DeviceMeasurement)
    for attr in ("DatastoreConfig", "TenantDatastoreManager"):
        monkeypatch.setattr(ref_datastore, attr, getattr(tdatastore, attr))
    for attr in ("ColumnarEventLog", "EventFilter"):
        monkeypatch.setattr(ref_datastore, attr, getattr(teventlog, attr))
    _call(getattr(getattr(ref_datastore, cls)(), name), tmp_path,
          monkeypatch)


def test_deadletter_replay_targets_on_the_port(monkeypatch):
    monkeypatch.setattr(ref_deadletter, "default_replay_target",
                        tdeadletter.default_replay_target)
    ref_deadletter.test_default_replay_targets(
        types.SimpleNamespace(naming=tbus.TopicNaming()))


def test_deadletter_operator_loop_on_the_port():
    """park -> list -> inspect -> replay -> reingest (the loop of
    tests/test_deadletter.py's instance drill) on the port's bus, dead-letter
    surface and inbound service: a broken processor parks a decoded record,
    the operator provisions the device and replays it through the
    reprocess topic into the port's engine."""
    from sitewhere_tpu_torch.pipeline.engine import PipelineEngine
    from sitewhere_tpu_torch.pipeline.inbound import InboundProcessingService
    from sitewhere_tpu_torch.registry import RegistryTensors

    naming = tbus.TopicNaming()
    bus = tbus.EventBus(partitions=2)
    dm = tstore.DeviceManagement()
    tensors = RegistryTensors(64, 2, 4)
    tensors.attach(dm, "default")
    engine = PipelineEngine(tensors, batch_size=16, measurement_slots=4,
                            name="eventlog-dlq-drill", device="cpu")
    engine.start()
    log = teventlog.ColumnarEventLog()
    events = tem.DeviceEventManagement(log, registry=dm)
    inbound = InboundProcessingService(bus, dm, events=events, engine=engine)
    decoded = naming.event_source_decoded_events("default")

    def broken(_records):
        raise RuntimeError("decoder bug v1")

    host = tbus.ConsumerHost(bus, decoded, group_id="broken-proc",
                             handler=broken, max_retries=1,
                             max_backoff_s=0.05)
    host.start()
    now = int(time.time() * 1000)
    record = msgpack.packb({
        "sourceId": "dl", "deviceToken": "dl-dev",
        "kind": "DeviceEventBatch",
        "request": tcommon._asdict(tevent.DeviceEventBatch(
            device_token="dl-dev", measurements=[tevent.DeviceMeasurement(
                name="temp", value=41.5, event_date=now)])),
        "metadata": {}}, use_bin_type=True)
    bus.publish(decoded, b"dl-dev", record)
    deadline = time.monotonic() + 30
    while host.dead_lettered == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    host.stop()
    assert host.dead_lettered >= 1
    parked = f"{decoded}.dead-letter"
    listed = {t["topic"]: t for t in tdeadletter.list_parked_topics(
        bus, naming)}
    assert listed[parked]["replayBacklog"] >= 1
    assert listed[parked]["replayTarget"] == \
        naming.inbound_reprocess_events("default")
    assert tdeadletter.read_parked_records(bus, parked)[0]["preview"][
        "deviceToken"] == "dl-dev"
    dt = dm.create_device_type(tmodel.DeviceType(token="dl-dt"))
    d = dm.create_device(tmodel.Device(token="dl-dev",
                                       device_type_id=dt.id))
    dm.create_device_assignment(tmodel.DeviceAssignment(token="dl-as",
                                                        device_id=d.id))
    result = tdeadletter.replay_parked_records(bus, naming, parked)
    assert result["replayed"] >= 1 and result["remaining"] == 0
    # the reprocess consumer, driven synchronously
    consumer = bus.consumer(naming.inbound_reprocess_events("default"),
                            "drill")
    inbound.process(consumer.poll())
    state = engine.get_device_state("dl-dev")
    assert state.last_measurements["temp"][1] == 41.5
    assert log.count("default") == 1
    assert tdeadletter.replay_parked_records(
        bus, naming, parked)["replayed"] == 0


# -- the two packages against each other ----------------------------------------

def _event_dicts(results):
    return [dataclasses.asdict(e) for e in results]


def _control_events(ev_mod):
    return [
        ev_mod.DeviceMeasurement(id="m-1", name="temp", value=1.5,
                                 event_date=1000, device_id="dev-0",
                                 alternate_id="alt-1",
                                 metadata={"k": "v"}),
        ev_mod.DeviceLocation(id="l-1", latitude=1.0, longitude=2.0,
                              elevation=3.0, event_date=2000,
                              device_id="dev-1"),
        ev_mod.DeviceAlert(id="a-1", type="zone.violation",
                           level=ev_mod.AlertLevel.CRITICAL,
                           message="out", event_date=3000,
                           device_id="dev-2"),
        ev_mod.DeviceCommandInvocation(id="c-1", command_token="reboot",
                                       parameter_values={"delay": "5"},
                                       event_date=4000),
        ev_mod.DeviceStateChange(id="s-1", attribute="presence",
                                 type="presence", new_state="NOT_PRESENT",
                                 event_date=5000),
        ev_mod.DeviceStreamData(id="d-1", stream_id="s1", data=b"\x01\x02",
                                event_date=6000),
    ]


def _packer(pack_mod, interning_mod):
    interner = interning_mod.TokenInterner(64, "devices")
    for i in range(4):
        interner.intern(f"dev-{i}")
    packer = pack_mod.EventPacker(batch_size=16, device_interner=interner,
                                  epoch_base_ms=1_700_000_000_000)
    packer.measurements.intern("temp")
    packer.alert_types.intern("hot")
    return packer


def _hot_columns():
    rng = np.random.default_rng(3)
    return dict(device_idx=rng.integers(0, 5, 12).astype(np.int32),
                event_type=rng.integers(0, 3, 12).astype(np.int32),
                ts_ms_abs=1_700_000_000_000 + rng.integers(0, 9000, 12),
                mm_idx=np.full(12, 1, np.int32),
                value=rng.normal(size=12).astype(np.float32),
                lat=rng.normal(size=12).astype(np.float32),
                lon=rng.normal(size=12).astype(np.float32),
                alert_type_idx=np.ones(12, np.int32),
                alert_level=rng.integers(0, 4, 12).astype(np.int32))


PACKAGES = {
    "jax": (jeventlog, jpack, jinterning,
            __import__("sitewhere_tpu.model.event", fromlist=["x"])),
    "port": (teventlog, tpack, tinterning, tevent),
}


def _write(pkg, data_dir):
    log_mod, pack_mod, interning_mod, ev_mod = PACKAGES[pkg]
    log = log_mod.ColumnarEventLog(data_dir=data_dir, segment_rows=8)
    packer = _packer(pack_mod, interning_mod)
    log.append_batch("acme", packer.pack_columns(**_hot_columns()), packer,
                     received_ms=123)
    log.append_events("acme", _control_events(ev_mod),
                      device_interner=packer.devices)
    log.flush()
    return log


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_parquet_segments_load_across_packages(writer, reader, tmp_path):
    data = str(tmp_path / "log")
    wrote = _write(writer, data)
    assert [f for f in os.listdir(os.path.join(data, "acme"))
            if f.endswith(".parquet")]
    read = PACKAGES[reader][0].ColumnarEventLog(data_dir=data,
                                                segment_rows=8)
    flt_w, flt_r = (PACKAGES[p][0].EventFilter() for p in (writer, reader))
    page_w, page_r = (
        __import__(f"{'sitewhere_tpu' if p == 'jax' else 'sitewhere_tpu_torch'}"
                   ".model.common", fromlist=["x"]).SearchCriteria(
            page_size=100) for p in (writer, reader))
    assert read.count("acme") == wrote.count("acme") == 18
    assert _event_dicts(read.query("acme", flt_r, page_r).results) == \
        _event_dicts(wrote.query("acme", flt_w, page_w).results)
    names = list(teventlog._COLUMNS)
    got = read.query_columns("acme", flt_r, names)
    want = wrote.query_columns("acme", flt_w, names)
    for name in names:
        assert np.array_equal(np.asarray(got[name]),
                              np.asarray(want[name])), name


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_old_parquet_layout_loads_across_packages(writer, reader, tmp_path):
    """A segment of the layout before the (id_prefix, id_seq) columns,
    written by one package, loads in the other with the same events."""
    import pyarrow.parquet as pq

    data = str(tmp_path / "log")
    _write(writer, data)
    tdir = os.path.join(data, "acme")
    for name in os.listdir(tdir):
        if name.endswith(".parquet"):
            path = os.path.join(tdir, name)
            pq.write_table(pq.read_table(path).drop_columns(
                ["id_prefix", "id_seq"]), path)
    logs = [PACKAGES[p][0].ColumnarEventLog(data_dir=data, segment_rows=8)
            for p in (writer, reader)]
    flts = [PACKAGES[p][0].EventFilter(id="m-1") for p in (writer, reader)]
    got = [log.query("acme", flt) for log, flt in zip(logs, flts)]
    assert got[0].num_results == got[1].num_results
    assert _event_dicts(got[0].results) == _event_dicts(got[1].results)
    assert logs[0].count("acme") == logs[1].count("acme")


def test_append_batch_columns_match_jax():
    """The same packed batch appended by each package: every column equal,
    the bulk ids' sequence relative to the batch's first row (the id prefix
    is random per process and package)."""
    out = {}
    for pkg in ("jax", "port"):
        log_mod, pack_mod, interning_mod, _ = PACKAGES[pkg]
        log = log_mod.ColumnarEventLog(segment_rows=8)
        packer = _packer(pack_mod, interning_mod)
        n = log.append_batch("acme", packer.pack_columns(**_hot_columns()),
                             packer, received_ms=123)
        out[pkg] = (n, log.query_columns("acme", log_mod.EventFilter(),
                                         list(teventlog._COLUMNS)))
    assert out["jax"][0] == out["port"][0] == 12
    for name in teventlog._COLUMNS:
        want, got = (np.asarray(out[p][1][name]) for p in ("jax", "port"))
        if name == "id_prefix":
            assert len(set(got)) == 1 and got[0] == teventlog._ID_PREFIX
            continue
        if name == "id_seq":
            want, got = want - want.min(), got - got.min()
        assert np.array_equal(want, got), name
    assert not torch.is_tensor(out["port"][1]["value"])
