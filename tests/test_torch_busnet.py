"""The networked bus edge on the port: the reference's tests/test_busnet.py
scenarios run against `sitewhere_tpu_torch.runtime.busnet` (their
subprocesses import the port too), and the wire format held across the
packages: a JAX client publishes to, polls and commits on a port server,
and a port client does the same on a JAX server."""

import pytest

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_busnet")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 9


def _round_trip(client_cls, bus, port, topic):
    """Publish, poll, commit and re-seek through `client_cls`; the records
    land in `bus` (the server's) with their keys' partitions."""
    client = client_cls("127.0.0.1", port)
    try:
        assert client.ping()
        client.publish_batch(topic, [(b"dev-%d" % i, b"v%d" % i)
                                     for i in range(12)])
        client.publish(topic, b"dev-3", b"again")
        records = client.poll(topic, "g", timeout_s=2.0)
        assert sorted(r.value for r in records) == sorted(
            [b"v%d" % i for i in range(12)] + [b"again"])
        parts = {(r.key, r.partition) for r in records}
        assert len({p for k, p in parts if k == b"dev-3"}) == 1
        # nothing committed: a re-seek redelivers everything
        client.seek_committed(topic, "g")
        assert len(client.poll(topic, "g", timeout_s=2.0)) == 13
        client.commit(topic, "g")
        client.seek_committed(topic, "g")
        assert client.poll(topic, "g", timeout_s=0.2) == []
        # the server's bus holds what the client published, in the
        # partitions the server chose for the keys
        stored = sorted(
            (key, pidx, value)
            for pidx, part in enumerate(bus.topic(topic).partitions)
            for _offset, key, value, _ts in part.read(0, 100))
        assert stored == sorted((r.key, r.partition, r.value)
                                for r in records)
    finally:
        client.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("sitewhere_tpu", "sitewhere_tpu_torch"),
    ("sitewhere_tpu_torch", "sitewhere_tpu"),
])
def test_clients_and_servers_of_both_packages_talk(tmp_path, client_pkg,
                                                   server_pkg):
    import importlib

    bus_mod = importlib.import_module(f"{server_pkg}.runtime.bus")
    server_mod = importlib.import_module(f"{server_pkg}.runtime.busnet")
    client_mod = importlib.import_module(f"{client_pkg}.runtime.busnet")
    bus = bus_mod.EventBus(partitions=4, data_dir=str(tmp_path / "bus"))
    srv = server_mod.BusServer(bus)
    srv.start()
    try:
        _round_trip(client_mod.BusClient, bus, srv.port, "x.events")
        # a fenced request from the other package bounces as the
        # structured stale-epoch error
        client = client_mod.BusClient("127.0.0.1", srv.port, retries=0)
        try:
            client.fence("proc:9", 5)
            client.set_epoch("proc:9", 4)
            with pytest.raises(client_mod.StaleEpochBusError):
                client.publish("x.events", b"k", b"zombie")
        finally:
            client.close()
    finally:
        srv.stop()
        bus.close()
