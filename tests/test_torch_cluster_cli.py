"""`python -m sitewhere_tpu_torch serve --cluster-coordinator` as an
operator runs it: the reference's tests/test_cluster.py
`test_cli_cluster_serve_boots_and_stops` on the port, asked for the CPU.

Two processes boot into one gloo world at the coordinator (process 0
hosts it), each with its REST gateway and its bus edge on the ports
`--cluster-peers` names, print the serving banner with their mesh (the
global shards over two hosts, each its own block), fold a record that
entered through the peer on its owner, and both exit 0 on SIGTERM through
the coordinated stop vote. Once with the default shard count (one shard a
process) and once with `--shards 2 --feeders`, which a cluster host boots
without the feeder landing (as the reference's cluster serve does).

The fold: registry gossip is off, so that no boot race stands in the way
(the reference's drills race there); the same devices are provisioned on
both hosts over REST, and once both topologies list both hosts a decoded
record for each host's peer-owned device is published to that host's bus
edge. Inbound forwards it to the owner, whose step loop folds it; the
owner's REST API reads its measurement back.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import zlib

import msgpack
import pytest

from test_torch_multiprocess_pipeline import REPO, _free_port

BOOT_DEADLINE_S = 120
FOLD_DEADLINE_S = 60
DEVICES = 8


def _boot_two(extra, tmp_path):
    coord, bus0, bus1 = _free_port(), _free_port(), _free_port()
    # a small world and one intra-op thread a process: each host's step
    # loop ticks without pause, beside the suite's other workers
    config = tmp_path / "cluster.json"
    config.write_text(json.dumps({
        "pipeline": {
            "max_devices": 256, "batch_size": 64, "max_zones": 4,
            "max_zone_vertices": 4, "measurement_slots": 4,
            "max_tenants": 4},
        "cluster": {"registry_gossip": False}}))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
         "--device", "cpu", "--config", str(config),
         "--cluster-coordinator", f"127.0.0.1:{coord}",
         "--cluster-num-processes", "2",
         "--cluster-process-id", str(pid),
         "--cluster-peers", f"0=127.0.0.1:{bus0},1=127.0.0.1:{bus1}",
         "--bus-port", str(bus0 if pid == 0 else bus1),
         "--port", "0", "--data-dir", str(tmp_path / f"h{pid}"), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path), start_new_session=True)
        for pid in range(2)]
    return procs, (bus0, bus1)


def _client(url):
    from sitewhere_tpu_torch.client import SiteWhereClient

    client = SiteWhereClient(url, timeout=30.0)
    client.authenticate("admin", "password")
    return client


def _fold_forwarded_records(urls, bus_ports, n_shards):
    """Provision DEVICES devices on both hosts, wait until both list both
    hosts, publish one record a host for a device its peer owns, and read
    each back from its owner's device state."""
    from sitewhere_tpu_torch.client.rest import SiteWhereClientError
    from sitewhere_tpu_torch.model.common import _asdict
    from sitewhere_tpu_torch.model.event import (
        DeviceEventBatch, DeviceMeasurement)
    from sitewhere_tpu_torch.runtime.bus import TopicNaming
    from sitewhere_tpu_torch.runtime.busnet import BusClient

    rests = [_client(u) for u in urls]
    tokens = [f"fdev-{i}" for i in range(DEVICES)]
    # the registry places a device on shard crc32(token) % S; a host holds
    # S / 2 of them in order
    owner = {t: (zlib.crc32(t.encode()) % n_shards) // (n_shards // 2)
             for t in tokens}
    assert set(owner.values()) == {0, 1}, owner
    for rest in rests:
        rest.create_device_type({"token": "fdt", "name": "F"})
        for i, token in enumerate(tokens):
            rest.create_device({"token": token, "device_type_token": "fdt"})
            rest.create_assignment({"token": f"fas-{i}",
                                    "device_token": token})
    deadline = time.monotonic() + FOLD_DEADLINE_S
    while True:
        procs = [r.get("/api/instance/topology").get("processes", {})
                 for r in rests]
        if all({"0", "1"} <= set(p) and not any(
                v.get("stale") for v in p.values()) for p in procs):
            break
        assert time.monotonic() < deadline, f"hosts never settled: {procs}"
        time.sleep(0.2)
    instance_id = rests[0].get("/api/instance/topology")["instance_id"]
    topic = TopicNaming(instance=instance_id).event_source_decoded_events(
        "default")
    sent = {}
    now = int(time.time() * 1000)
    for pid in range(2):
        token = next(t for t in tokens if owner[t] != pid)
        value = 60.0 + pid
        batch = DeviceEventBatch(device_token=token, measurements=[
            DeviceMeasurement(name="temp", value=value, event_date=now)])
        client = BusClient("127.0.0.1", bus_ports[pid])
        try:
            client.publish(topic, token.encode(), msgpack.packb({
                "sourceId": "cluster-cli-test", "deviceToken": token,
                "kind": "DeviceEventBatch", "request": _asdict(batch),
                "metadata": {}}, use_bin_type=True))
        finally:
            client.close()
        sent[token] = value
    for token, value in sent.items():
        while True:
            try:
                state = rests[owner[token]].get(f"/api/devicestates/{token}")
                got = state.get("last_measurements", {}).get("temp")
            except SiteWhereClientError as exc:
                assert exc.status == 404, exc
                got = None
            if got is not None and float(got[1]) == value:
                break
            assert time.monotonic() < deadline, (
                f"{token}'s record never folded on host {owner[token]}")
            time.sleep(0.1)


@pytest.mark.parametrize("extra", [
    pytest.param((), id="one-shard-a-host"),
    pytest.param(("--shards", "2", "--feeders"), id="shards-2-feeders"),
])
def test_cluster_serve_boots_two_hosts_and_stops_on_sigterm(extra,
                                                             tmp_path):
    procs, bus_ports = _boot_two(extra, tmp_path)
    banners = [None, None]
    logs = [[], []]

    def read(i):
        # drains the host's output to its end, so that it never blocks
        for line in procs[i].stdout:
            logs[i].append(line)
            if "mesh         :" in line:
                banners[i] = "".join(logs[i])

    readers = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(2)]
    try:
        for r in readers:
            r.start()
        deadline = time.monotonic() + BOOT_DEADLINE_S
        while not all(banners) and time.monotonic() < deadline \
                and all(p.poll() is None for p in procs):
            time.sleep(0.1)
        assert all(banners), ["".join(x)[-3000:] for x in logs]
        urls = []
        for pid, banner in enumerate(banners):
            assert f"cluster host {pid}/2" in banner
            m = re.search(r"mesh         : (\d+) shards over 2 hosts, "
                          r"shards \[([\d, ]+)\]", banner)
            assert m, banner
            assert int(m.group(1)) == 2
            assert m.group(2) == str(pid)
            urls.append(re.search(r"REST gateway : (http://\S+)",
                                  banner).group(1))
        _fold_forwarded_records(urls, bus_ports, 2)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=BOOT_DEADLINE_S) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait(timeout=30)
