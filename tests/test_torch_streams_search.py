"""The port's device streams and event search (sitewhere_tpu_torch/streams/,
sitewhere_tpu_torch/search/) held against the JAX package's, on the CPU.

The reference's own scenarios (tests/test_streams_search.py, all but the
one that federates through the instance's REST gateway: the instance is a
later slice) run with their names rebound to the port's classes; the
external provider talks to the reference's stub HTTP engine on localhost.
Then both packages over the same appends: stream listings, chunks and
reassembly, and columnar search results, equal up to the random event
ids. Tolerance: none.
"""

import dataclasses
import inspect

import pytest

import sitewhere_tpu.errors as jerrors
import sitewhere_tpu.model as jmodel
import sitewhere_tpu.model.common as jcommon
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.persist.event_management as jem
import sitewhere_tpu.persist.eventlog as jeventlog
import sitewhere_tpu.registry.store as jstore
import sitewhere_tpu.search as jsearch
import sitewhere_tpu.streams as jstreams
import test_streams_search as ref_streams
from sitewhere_tpu_torch import errors as terrors
from sitewhere_tpu_torch import model as tmodel
from sitewhere_tpu_torch import search as tsearch
from sitewhere_tpu_torch import streams as tstreams
from sitewhere_tpu_torch.model import common as tcommon
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.persist import event_management as tem
from sitewhere_tpu_torch.persist import eventlog as teventlog
from sitewhere_tpu_torch.registry import store as tstore

STREAMS_NAMES = {
    "NotFoundError": terrors.NotFoundError,
    "SiteWhereError": terrors.SiteWhereError,
    "SearchCriteria": tcommon.SearchCriteria,
    **{n: getattr(tmodel, n) for n in ("Device", "DeviceAssignment",
                                       "DeviceType")},
    "DeviceEventType": tevent.DeviceEventType,
    "DeviceMeasurement": tevent.DeviceMeasurement,
    "DeviceEventManagement": tem.DeviceEventManagement,
    "ColumnarEventLog": teventlog.ColumnarEventLog,
    "DeviceManagement": tstore.DeviceManagement,
    "SqliteStore": tstore.SqliteStore,
    "ColumnarSearchProvider": tsearch.ColumnarSearchProvider,
    "SearchCriteriaSpec": tsearch.SearchCriteriaSpec,
    "SearchProvidersManager": tsearch.SearchProvidersManager,
    "DeviceStreamManager": tstreams.DeviceStreamManager,
}
STREAMS_SCENARIOS = sorted(
    (cls, name) for cls in ("TestDeviceStreams", "TestEventSearch",
                            "TestExternalSearchProvider")
    for name in dir(getattr(ref_streams, cls))
    if name.startswith("test_") and "rest" not in name)


def test_every_reference_scenario_is_covered():
    assert len(STREAMS_SCENARIOS) == 13


def _world(tmp_path):
    """tests/test_streams_search.py's `world` fixture on the port."""
    registry = tstore.DeviceManagement()
    dtype = registry.create_device_type(tmodel.DeviceType(token="dt"))
    device = registry.create_device(tmodel.Device(token="d1",
                                                  device_type_id=dtype.id))
    registry.create_device_assignment(tmodel.DeviceAssignment(
        token="a1", device_id=device.id))
    log = teventlog.ColumnarEventLog(data_dir=str(tmp_path / "log"),
                                     segment_rows=16)
    events = tem.DeviceEventManagement(log, registry, "t1")
    return registry, log, events, tmp_path


@pytest.mark.parametrize("cls,name", STREAMS_SCENARIOS)
def test_streams_search_scenario_on_the_port(cls, name, monkeypatch,
                                             tmp_path):
    for attr, value in STREAMS_NAMES.items():
        monkeypatch.setattr(ref_streams, attr, value)
    # names the scenarios import inside their bodies find the port's
    monkeypatch.setattr(jsearch, "HttpSearchProvider",
                        tsearch.HttpSearchProvider)
    for attr in ("DeviceAlert", "DeviceMeasurement"):
        monkeypatch.setattr(jevent, attr, getattr(tevent, attr))
    fn = getattr(getattr(ref_streams, cls)(), name)
    stub = None
    try:
        args = {}
        for p in inspect.signature(fn).parameters:
            if p == "world":
                args[p] = _world(tmp_path)
            elif p == "stub":
                stub = args[p] = ref_streams._StubSearchServer()
        fn(**args)
    finally:
        if stub is not None:
            stub.close()


PACKAGES = {
    "jax": (jmodel, jevent, jem, jeventlog, jstore, jsearch, jstreams,
            jcommon, jerrors),
    "port": (tmodel, tevent, tem, teventlog, tstore, tsearch, tstreams,
             tcommon, terrors),
}


def _drive(pkg, tmp_path):
    """One package's streams and search over a fixed sequence of appends;
    everything it reads back, event ids left out."""
    model, ev, em, elog, store, search, streams, common, errors = \
        PACKAGES[pkg]
    registry = store.DeviceManagement()
    dtype = registry.create_device_type(model.DeviceType(token="dt"))
    for i in range(2):
        device = registry.create_device(model.Device(
            token=f"d{i}", device_type_id=dtype.id))
        registry.create_device_assignment(model.DeviceAssignment(
            token=f"a{i}", device_id=device.id))
    log = elog.ColumnarEventLog(segment_rows=8)
    events = em.DeviceEventManagement(log, registry, "t1")
    meta = store.SqliteStore(str(tmp_path / f"{pkg}.db"))
    mgr = streams.DeviceStreamManager(registry, events, store=meta)
    mgr.create_device_stream("a0", "fw", content_type="application/fw")
    mgr.create_device_stream("a0", "log")
    for seq in (3, 0, 2, 1, 0):
        mgr.add_stream_data("a0", "fw", seq, bytes([seq, 7]))
    mgr.add_stream_data("a0", "log", 0, b"line")
    for i in range(12):
        events.add_measurements(f"a{i % 2}", ev.DeviceMeasurement(
            name="rpm" if i % 3 else "temp", value=float(i),
            event_date=1000 + i))
    reopened = streams.DeviceStreamManager(registry, events, store=meta)
    manager = search.SearchProvidersManager()
    manager.register(search.ColumnarSearchProvider(log, "t1"))

    def plain(results, stamped=False):
        """Results without the random ids and the registry's entity ids
        (and the wall-clock dates stamped on chunks sent without one)."""
        out = []
        for e in results.results:
            d = dataclasses.asdict(e)
            for key in ("id", "device_assignment_id", "device_id",
                        "customer_id", "area_id", "asset_id",
                        "received_date") + (("event_date",) if stamped
                                            else ()):
                d.pop(key, None)
            out.append(d)
        return results.num_results, out

    try:
        mgr.create_device_stream("a0", "fw")
        duplicate = None
    except errors.SiteWhereError as err:
        duplicate = (err.http_status, int(err.code))
    return {
        "streams": [(s.token, s.content_type) for s in
                    reopened.list_device_streams("a0").results],
        "fw": reopened.reassemble("a0", "fw"),
        "chunk_0": reopened.get_stream_data("a0", "fw", 0).data,
        "chunks": plain(mgr.list_stream_data(
            "a0", "fw", common.SearchCriteria(page_size=3)), stamped=True),
        "duplicate": duplicate,
        "rpm": plain(manager.search("columnar", search.SearchCriteriaSpec(
            event_type=ev.DeviceEventType.MEASUREMENT,
            measurement_name="rpm", page_size=4))),
        "a1_range": plain(manager.search("columnar",
                                         search.SearchCriteriaSpec(
                                             assignment_token="a1",
                                             start_date=1003,
                                             end_date=1009))),
        "providers": manager.list_providers(),
    }


def test_same_appends_read_back_as_in_jax(tmp_path):
    port, ref = _drive("port", tmp_path), _drive("jax", tmp_path)
    assert port == ref
    assert port["fw"] == bytes([0, 7, 1, 7, 2, 7, 3, 7])
