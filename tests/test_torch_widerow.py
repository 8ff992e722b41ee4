"""The port's wide-row event store (sitewhere_tpu_torch/persist/widerow.py)
held against the JAX package's, on the CPU.

First the repair: the port's datastore manager imports
`sitewhere_tpu_torch.persist.widerow` for a tenant whose datastore kind is
"widerow", and that module did not exist; a tenant selecting it by its
metadata now gets a working store, whose events appended through the
port's event management read back. Then the reference's own scenarios
(tests/test_widerow.py, all but the instance-backed one: the instance is a
later slice) with their names rebound to the port's classes, and the two
packages' stores over the same appends: rows, buckets and the columns and
dtypes of `query_columns` equal; ids are random per store and bulk ids
carry a per-process prefix, so ids are compared by their relative order
and the rest by tokens. Tolerance: none.
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest

import sitewhere_tpu.analytics.engine as jengine
import sitewhere_tpu.model as jmodel
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.ops.pack as jpack
import sitewhere_tpu.persist as jpersist
import sitewhere_tpu.persist.datastore as jdatastore
import sitewhere_tpu.persist.eventlog as jeventlog
import sitewhere_tpu.persist.widerow as jwiderow
import sitewhere_tpu.registry as jregistry
import sitewhere_tpu.registry.interning as jinterning
import test_widerow as ref_widerow
from sitewhere_tpu_torch import model as tmodel
from sitewhere_tpu_torch.model import common as tcommon
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.persist import datastore as tdatastore
from sitewhere_tpu_torch.persist import event_management as tem
from sitewhere_tpu_torch.persist import eventlog as teventlog
from sitewhere_tpu_torch.persist import widerow as twiderow
from sitewhere_tpu_torch.registry import interning as tinterning
from sitewhere_tpu_torch.registry import store as tstore
from test_torch_analytics import _CPUEngine

WIDEROW_NAMES = {
    **{n: getattr(tmodel, n) for n in ("Device", "DeviceAssignment",
                                       "DeviceType")},
    **{n: getattr(tcommon, n) for n in ("DateRangeCriteria",
                                        "SearchCriteria")},
    **{n: getattr(tevent, n) for n in (
        "AlertLevel", "AlertSource", "DeviceAlert", "DeviceCommandInvocation",
        "DeviceEventType", "DeviceLocation", "DeviceMeasurement",
        "DeviceStateChange", "DeviceStreamData")},
    "EventFilter": teventlog.EventFilter,
    "WideRowEventStore": twiderow.WideRowEventStore,
    "DeviceManagement": tstore.DeviceManagement,
}
WIDEROW_SCENARIOS = sorted(
    (cls, name) for cls in ("TestRoundTrip", "TestBatchAppend",
                            "TestWideRowLayout", "TestDatastoreWiring",
                            "TestShutdownOrderingGuards")
    for name in dir(getattr(ref_widerow, cls))
    if name.startswith("test_") and "instance" not in name)


def test_every_reference_scenario_is_covered():
    assert len(WIDEROW_SCENARIOS) == 18


@pytest.mark.parametrize("cls,name", WIDEROW_SCENARIOS)
def test_widerow_scenario_on_the_port(cls, name, monkeypatch, tmp_path):
    for attr, value in WIDEROW_NAMES.items():
        monkeypatch.setattr(ref_widerow, attr, value)
    # names the scenarios import inside their bodies find the port's
    monkeypatch.setattr(jpack, "EventPacker", tpack.EventPacker)
    monkeypatch.setattr(jinterning, "TokenInterner",
                        tinterning.TokenInterner)
    monkeypatch.setattr(jengine, "WindowedAnalyticsEngine", _CPUEngine)
    for attr in ("DatastoreConfig", "TenantDatastoreManager"):
        monkeypatch.setattr(jdatastore, attr, getattr(tdatastore, attr))
    monkeypatch.setattr(jeventlog, "ColumnarEventLog",
                        teventlog.ColumnarEventLog)
    monkeypatch.setattr(jpersist, "DeviceEventManagement",
                        tem.DeviceEventManagement)
    monkeypatch.setattr(jpersist, "EventIndex", tem.EventIndex)
    fn = getattr(getattr(ref_widerow, cls)(), name)
    fixtures = {"tmp_path": tmp_path}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


# -- the repair: the datastore manager builds a wide-row tenant store ------------

def _registry():
    dm = tstore.DeviceManagement()
    dtype = dm.create_device_type(tmodel.DeviceType(token="sensor"))
    for i in range(3):
        device = dm.create_device(tmodel.Device(token=f"dev-{i}",
                                                device_type_id=dtype.id))
        dm.create_device_assignment(tmodel.DeviceAssignment(
            token=f"as-{i}", device_id=device.id))
    return dm


def test_tenant_metadata_selecting_widerow_gets_a_working_store(tmp_path):
    default = teventlog.ColumnarEventLog()
    mgr = tdatastore.TenantDatastoreManager(default, base_dir=str(tmp_path))
    tenant = types.SimpleNamespace(token="audit", metadata={
        "datastore.kind": "widerow", "datastore.bucket_ms": "60000"})
    store = mgr.event_log_for(tenant)
    assert isinstance(store, twiderow.WideRowEventStore)
    assert store.bucket_ms == 60_000 and store.db_path.endswith(
        "audit.widerow.db")
    assert mgr.dedicated_tenants() == {"audit": "widerow"}
    mgr.start()
    try:
        dm = _registry()
        events = tem.DeviceEventManagement(store, registry=dm,
                                           tenant="audit")
        for i in range(5):
            events.add_measurements(f"as-{i % 3}", tevent.DeviceMeasurement(
                name="temp", value=float(i), event_date=1000 + i))
        events.add_alerts("as-1", tevent.DeviceAlert(
            type="hot", message="m", level=tevent.AlertLevel.WARNING,
            event_date=2000))
        got = events.list_measurements(tem.EventIndex.ASSIGNMENT, "as-1")
        assert [m.value for m in got.results] == [4.0, 1.0]
        assert got.results[0].device_id == "dev-1"
        assert events.list_alerts(tem.EventIndex.ASSIGNMENT,
                                  "as-1").num_results == 1
        assert store.count("audit") == 6
        assert default.count("audit") == 0
    finally:
        mgr.stop()


# -- both packages' stores over the same appends ----------------------------------

PACKAGES = {
    "jax": (jwiderow, jevent, jpack, jinterning, jeventlog, jregistry),
    "port": (twiderow, tevent, tpack, tinterning, teventlog, tstore),
}
COLUMNS = ["seq", "bucket", "id", "alternate_id", "event_type", "device_idx",
           "device_token", "assignment_token", "customer_id", "area_id",
           "asset_id", "event_date", "mm_idx", "mm_name", "value",
           "latitude", "longitude", "elevation", "alert_source",
           "alert_level", "alert_type", "alert_message", "stream_id",
           "sequence_number", "originating_event_id"]


def _fill(pkg):
    widerow, ev, pack, interning, elog, registry = PACKAGES[pkg]
    store = widerow.WideRowEventStore(bucket_ms=10_000)
    dm = registry.DeviceManagement()
    model = jmodel if pkg == "jax" else tmodel
    dtype = dm.create_device_type(model.DeviceType(token="sensor"))
    for i in range(4):
        device = dm.create_device(model.Device(token=f"dev-{i}",
                                               device_type_id=dtype.id))
        dm.create_device_assignment(model.DeviceAssignment(
            token=f"as-{i}", device_id=device.id, customer_id="cust"))
    interner = interning.TokenInterner(64, "devices")
    for i in range(4):
        interner.intern(f"dev-{i}")
    packer = pack.EventPacker(64, interner, epoch_base_ms=1_000_000)
    packer.measurements.intern("temp")
    packer.alert_types.intern("hot")
    rng = np.random.default_rng(4)
    n = 40
    batch = packer.pack_columns(
        rng.integers(1, 5, n).astype(np.int32),
        rng.choice([0, 1, 2], n).astype(np.int32),
        1_000_000 + rng.integers(0, 60_000, n),
        mm_idx=np.ones(n, np.int32),
        value=rng.normal(size=n).astype(np.float32),
        lat=rng.normal(size=n).astype(np.float32),
        lon=rng.normal(size=n).astype(np.float32),
        alert_type_idx=np.ones(n, np.int32),
        alert_level=rng.integers(0, 4, n).astype(np.int32))
    assert store.append_batch("t", batch, packer, received_ms=5,
                              registry=dm) == n
    store.append_events("t", [
        ev.DeviceMeasurement(name="rpm", value=3.5, device_id="dev-2",
                             event_date=70_000, received_date=70_001),
        ev.DeviceLocation(latitude=1.0, longitude=2.0, device_id="dev-9",
                          event_date=1_050_000, received_date=1),
        ev.DeviceStreamData(device_assignment_id="as-1", stream_id="s",
                            sequence_number=2, data=b"\x01\x02",
                            event_date=80_000, received_date=2),
    ], interner)
    return store, elog, ev


def test_same_appends_give_the_same_rows_as_jax():
    out = {}
    for pkg in ("jax", "port"):
        store, elog, ev = _fill(pkg)
        cols = store.query_columns("t", elog.EventFilter(), COLUMNS)
        measured = store.query_columns(
            "t", elog.EventFilter(event_type=ev.DeviceEventType.MEASUREMENT,
                                  start_date=1_000_000),
            ["device_idx", "device_token", "event_date", "value"])
        listed = store.query("t", elog.EventFilter(device_token="dev-2"))
        out[pkg] = (cols, measured, store.buckets("t"),
                    [dataclasses.asdict(e) for e in listed.results],
                    store.prune("t", before_ms=1_000_000), store.count("t"))
    (jcols, jmeas, jbuckets, jlisted, jpruned, jcount), \
        (tcols, tmeas, tbuckets, tlisted, tpruned, tcount) = \
        out["jax"], out["port"]
    # without ORDER BY sqlite returns rows in the order of the index it
    # picks (here the random event ids): compare in insertion order
    jorder, torder = (np.argsort(c["seq"], kind="stable")
                      for c in (jcols, tcols))
    for name in COLUMNS:
        want = np.asarray(jcols[name])[jorder]
        got = np.asarray(tcols[name])[torder]
        assert got.dtype == want.dtype, name
        if name == "id":
            # hot rows: ev-<per-process prefix>-<seq>; control rows: random
            hot = np.array([i is not None and i.startswith("ev-")
                            for i in want])
            assert np.array_equal(hot, [i.startswith("ev-") for i in got])
            seqs = [np.array([int(i.rsplit("-", 1)[1], 16) for i in a[hot]])
                    for a in (want, got)]
            assert np.array_equal(seqs[0] - seqs[0][0], seqs[1] - seqs[1][0])
            continue
        if want.dtype == np.float32:
            want, got = want.view(np.int32), got.view(np.int32)
        assert np.array_equal(want, got), name
    jorder, torder = (np.lexsort((m["value"], m["event_date"]))
                      for m in (jmeas, tmeas))
    for name in jmeas:
        assert tmeas[name].dtype == jmeas[name].dtype
        assert np.array_equal(tmeas[name][torder], jmeas[name][jorder]), name
    assert tbuckets == jbuckets and tpruned == jpruned and tcount == jcount
    assert len(tlisted) == len(jlisted) > 0
    for t, j in zip(tlisted, jlisted):
        t.pop("id"), j.pop("id")
        assert t == j
