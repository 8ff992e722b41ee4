"""The JAX instance and the port's instance (`enable_pipeline=True`, the
port on the CPU) driven by one REST script and one stream of wire payloads,
and their checkpoints carried across, both ways.

The script, over each instance's own REST gateway with the reference's
HTTP client: device types with commands, 24 devices with assignments, an
area with zones, threshold and geofence rules, rule programs, anomaly
models and actuation policies. Then the same seeded wire payloads go
through an `InboundEventSource` with a `WireDecoder` on each instance's
default tenant engine, one payload at a time (every device at most once a
payload, so a device's observations land in the same steps on both
sides). The answers must match:
  - persisted event counts, by type;
  - the alerts, sorted by (assignment, source, level, type, date, message;
    a model alert's message carries its score and is left out);
  - the canonical device state and every stateful group, bit for bit;
  - the per-program, per-model and per-policy counters (command fires);
  - the window grids of GET /api/analytics/windows.
Tolerance: none.

Checkpoints: an instance saves (POST /api/instance/checkpoint), takes one
more payload past the save and stops; the other package's instance boots
on a copy of its data directory, restores, rewinds the inbound cursor to
the checkpoint and replays the gap: its state equals the first instance's
final state bit for bit, and the replayed payload adds no duplicate rows.
"""

import dataclasses
import shutil
import time

import numpy as np
import pytest

from sitewhere_tpu.client import SiteWhereClient
from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireCodec, encode_frame)

from test_torch_pipeline import assert_bits_equal, assert_dataclass_bits_equal
from test_torch_pipeline_stateful import MODELS, POLICIES, PROGRAMS

N_DEVICES = 24
N_PAYLOADS = 6
SIZES = dict(enable_pipeline=True, max_devices=256, max_zones=8,
             max_zone_vertices=8, batch_size=128, measurement_slots=4,
             max_tenants=4, bus_partitions=2)
ZONES = [("z0", (0.0, 0.0), 1.0), ("z1", (2.0, 2.0), 1.5),
         ("z2", (-2.0, 1.0), 1.0), ("z3", (1.0, -2.0), 2.0)]
RULES = [
    {"type": "threshold", "token": "t-hot", "measurement_name": "m1",
     "operator": ">", "threshold": 70.0, "alert_level": "CRITICAL"},
    {"type": "threshold", "token": "t-cold", "measurement_name": "m2",
     "operator": "<", "threshold": 10.0, "alert_level": "ERROR"},
    {"type": "threshold", "token": "t-any", "operator": ">=",
     "threshold": 95.0},
    {"type": "geofence", "token": "g-in", "zone_token": "z0",
     "condition": "inside", "alert_level": "WARNING"},
    {"type": "geofence", "token": "g-out", "zone_token": "z1",
     "condition": "outside"},
]
COMMANDS = ("shutdown", "inspect", "cool", "page")


def _classes(pkg):
    if pkg == "jax":
        from sitewhere_tpu.instance import SiteWhereInstance
        from sitewhere_tpu.sources import InboundEventSource, WireDecoder
        from sitewhere_tpu.web import RestServer
        return SiteWhereInstance, RestServer, InboundEventSource, \
            WireDecoder, {}
    from sitewhere_tpu_torch.instance import SiteWhereInstance
    from sitewhere_tpu_torch.sources import InboundEventSource, WireDecoder
    from sitewhere_tpu_torch.web import RestServer
    return SiteWhereInstance, RestServer, InboundEventSource, WireDecoder, \
        {"device": "cpu"}


class Booted:
    """One package's instance, REST gateway, client and wire source."""

    def __init__(self, pkg, data_dir, epoch_base_ms=None):
        Instance, Rest, Source, Decoder, extra = _classes(pkg)
        self.pkg = pkg
        # one instance id: the checkpointed cursors name its bus topics
        self.instance = Instance(instance_id="parity",
                                 data_dir=str(data_dir), **SIZES, **extra)
        engine = self.instance.pipeline_engine
        if epoch_base_ms is not None:
            engine.packer.epoch_base_ms = epoch_base_ms
        self.instance.start()
        self.rest = Rest(self.instance, port=0)
        self.rest.start()
        self.client = SiteWhereClient(self.rest.base_url)
        self.client.authenticate("admin", "password")
        tenant = self.instance.get_tenant_engine("default")
        self.source = Source("wire", Decoder(), [], tenant.bus,
                             tenant.naming)
        tenant.event_sources.add_source(self.source)
        self.source.start()

    @property
    def engine(self):
        return self.instance.pipeline_engine

    def feed(self, payload, timeout_s=60.0):
        """One payload; returns once the inbound consumer committed it."""
        self.source.on_encoded_event_received(payload)
        deadline = time.time() + timeout_s
        while self.instance._ingest_backlog() > 0:
            assert time.time() < deadline, f"{self.pkg}: ingest stalled"
            time.sleep(0.01)

    def stop(self):
        self.rest.stop()
        self.instance.stop()


def provision(client):
    for dtype in ("sensor", "tracker"):
        client.create_device_type({"token": dtype, "name": dtype})
    for command in COMMANDS:      # command tokens are tenant-wide
        client.create_device_command("sensor", {"token": command,
                                                "name": command})
    client.create_area({"token": "yard", "name": "Yard"})
    for token, (lat, lon), r in ZONES:
        client.create_zone("yard", {"token": token, "name": token, "bounds": [
            {"latitude": lat - r, "longitude": lon - r},
            {"latitude": lat - r, "longitude": lon + r},
            {"latitude": lat + r, "longitude": lon + r},
            {"latitude": lat + r, "longitude": lon - r}]})
    for i in range(N_DEVICES):
        client.create_device({"token": f"d{i}", "device_type_token":
                              "tracker" if i % 3 == 0 else "sensor"})
        client.create_assignment({"token": f"a{i}", "device_token": f"d{i}"})
    for rule in RULES:
        client.post("/api/rules", dict(rule))
    for spec in PROGRAMS[:4]:
        client.post("/api/tenants/default/ruleprograms", dict(spec))
    for spec in MODELS:
        client.post("/api/tenants/default/models", dict(spec))
    for spec in POLICIES[:3]:
        client.post("/api/tenants/default/actuations", dict(spec))


def payloads(base_ms, seed=7, n=N_PAYLOADS):
    """Seeded wire payloads: every device once a payload, in the 60/30/10
    measurement/location/alert mix, readings around the rules' bounds."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        frames = []
        for i in rng.permutation(N_DEVICES):
            token, ts = f"d{i}", base_ms + 1000 * k + int(i)
            roll = rng.random()
            if roll < 0.6:
                frames.append(encode_frame(
                    MessageType.MEASUREMENT, WireCodec.encode_measurement(
                        token, ts, f"m{1 + int(rng.integers(0, 3))}",
                        float(rng.normal(50.0, 30.0)))))
            elif roll < 0.9:
                frames.append(encode_frame(
                    MessageType.LOCATION, WireCodec.encode_location(
                        token, ts, float(rng.uniform(-3.5, 3.5)),
                        float(rng.uniform(-3.5, 3.5)))))
            else:
                frames.append(encode_frame(
                    MessageType.ALERT, WireCodec.encode_alert(
                        token, ts, "device.fault", 2, "fault")))
        out.append(b"".join(frames))
    return out


def observe(booted):
    """Everything the comparison reads from one instance."""
    inst, client = booted.instance, booted.client
    inst.event_log.flush()
    events = {}
    alerts = []
    for i in range(N_DEVICES):
        listed = client.get(f"/api/assignments/a{i}/events",
                            pageSize=10_000)
        for ev in listed["results"]:
            kind = ev.get("event_type")
            events[kind] = events.get(kind, 0) + 1
            if kind in (3, "ALERT", "Alert") or "level" in ev:
                model = str(ev.get("type", "")).startswith("anomaly")
                alerts.append((f"a{i}", str(ev.get("source")),
                               str(ev.get("level")), ev.get("type"),
                               ev.get("event_date"),
                               None if model else ev.get("message")))
    engine = booted.engine
    windows = client.get("/api/analytics/windows", window_ms=1000,
                         start_ms=BASE_MS - 1000,
                         end_ms=BASE_MS + 1000 * (N_PAYLOADS + 2),
                         keys=256)
    windows["serving"].pop("total_ms")      # wall time
    return {
        "events": events, "alerts": sorted(alerts, key=repr),
        "counters": (engine.rule_program_counters(),
                     engine.anomaly_model_counters(),
                     engine.actuation_policy_counters()),
        "windows": windows,
        "state": engine.canonical_state(),
        "groups": (engine.canonical_rule_state(),
                   engine.canonical_model_state(),
                   engine.canonical_actuation_state()),
    }


def assert_same(ref, got):
    assert got["events"] == ref["events"]
    assert got["alerts"] == ref["alerts"]
    assert got["counters"] == ref["counters"]
    assert got["windows"] == ref["windows"]
    assert_dataclass_bits_equal(ref["state"], got["state"], "state")
    for name, r, g in zip(("rule", "model", "actuation"), ref["groups"],
                          got["groups"]):
        if dataclasses.is_dataclass(r):
            assert_dataclass_bits_equal(r, g, name)
        else:
            assert_bits_equal(r, g, name)


BASE_MS = int(time.time() * 1000) - 60_000


@pytest.fixture(autouse=True)
def _disarm_replay_barriers():
    """A restore arms each package's process-global replay barrier with
    the rows above the checkpoint; the replay consumes only its input
    events (ROADMAP C), so a budget can outlive the test: disarm both."""
    from sitewhere_tpu.runtime import recovery as jrecovery
    from sitewhere_tpu_torch.runtime import recovery as trecovery

    yield
    jrecovery.GLOBAL_REPLAY_BARRIER.disarm()
    trecovery.GLOBAL_REPLAY_BARRIER.disarm()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both instances provisioned and fed N_PAYLOADS - 1 payloads, then a
    checkpoint each, then the last payload (past the checkpoint)."""
    root = tmp_path_factory.mktemp("instance-parity")
    jax_side = Booted("jax", root / "jax")
    port_side = Booted("port", root / "port",
                       epoch_base_ms=jax_side.engine.packer.epoch_base_ms)
    sides = (jax_side, port_side)
    for side in sides:
        provision(side.client)
        # build the params now: a rule's alert type is interned when the
        # params are built, a device alert's when it is packed, so which
        # comes first (and so the interner indices in the state) would
        # depend on whether another thread built them before the first step
        side.engine._ensure_params()
    stream = payloads(BASE_MS)
    for payload in stream[:-1]:
        for side in sides:
            side.feed(payload)
    saved = {}
    for side in sides:
        side.client.post("/api/instance/checkpoint")
        saved[side.pkg] = observe(side)
    for side in sides:
        side.feed(stream[-1])
    final = {side.pkg: observe(side) for side in sides}
    for side in sides:
        side.stop()
    return {"root": root, "saved": saved, "final": final,
            "epoch_base_ms": jax_side.engine.packer.epoch_base_ms,
            "last": stream[-1]}


def test_port_instance_answers_like_the_jax_instance(worlds):
    ref, got = worlds["final"]["jax"], worlds["final"]["port"]
    assert_same(ref, got)
    assert sum(ref["events"].values()) > N_DEVICES * N_PAYLOADS
    assert ref["alerts"] and any(ref["counters"][i] for i in range(3))
    fired = [c for family in ref["counters"] for c in family.values()]
    assert any(c.get("fires", 0) for c in fired)


def test_checkpoints_agree_at_the_save(worlds):
    assert_same(worlds["saved"]["jax"], worlds["saved"]["port"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_restores_across_packages_and_replays_the_gap(
        worlds, writer, reader, tmp_path):
    """`reader` boots on a copy of `writer`'s data directory: the restore
    rewinds the inbound cursor to the checkpoint, the last payload replays
    from the bus, and the state equals `writer`'s final state; the
    replay's rows were already durable and are not persisted again."""
    data = tmp_path / "data"
    shutil.copytree(worlds["root"] / writer, data)
    side = Booted(reader, data, epoch_base_ms=worlds["epoch_base_ms"])
    try:
        manager = side.instance.checkpoint_manager
        assert manager.last_restore_offsets, "nothing restored"
        deadline = time.time() + 60
        while side.instance._ingest_backlog() > 0:
            assert time.time() < deadline
            time.sleep(0.01)
        got = observe(side)
    finally:
        side.stop()
    ref = worlds["final"][writer]
    assert got["events"] == ref["events"]
    assert got["alerts"] == ref["alerts"]
    assert_dataclass_bits_equal(ref["state"], got["state"], "state")
    for name, r, g in zip(("rule", "model", "actuation"), ref["groups"],
                          got["groups"]):
        assert_dataclass_bits_equal(r, g, name)
