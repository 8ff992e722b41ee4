"""The feeder fleet's landing on the port: the reference's
tests/test_feeders.py scenarios run on `sitewhere_tpu_torch.feeders` (the
engines on the CPU), the sharded landing (TestEndToEndSharded) included,
and the packages held against each other: a JAX worker landing on a port
service, a port worker landing on a JAX service and a port worker on a
port service, each against an inline jitted JAX engine fed the same
frames, for one engine and for a sharded one. Tolerance: none (f32
compared as bit patterns).
"""

import dataclasses
import time

import numpy as np
import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(globals(), "test_feeders", replacements=[
    ("    engine = PipelineEngine(tensors, batch_size=batch_size)",
     '    engine = PipelineEngine(tensors, batch_size=batch_size, '
     'device="cpu")'),
    # the port's batches are dataclasses of tensors, not JAX pytrees
    ('''    import jax.tree_util as jtu

    assert len(a) == len(b)
    for b1, b2 in zip(a, b):
        for l1, l2 in zip(jtu.tree_leaves(b1), jtu.tree_leaves(b2)):''',
     '''    fields = dataclasses.fields

    assert len(a) == len(b)
    for b1, b2 in zip(a, b):
        for l1, l2 in ((getattr(b1, f.name), getattr(b2, f.name))
                       for f in fields(b1)):'''),
])


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 17


class TestEndToEndSharded(TestEndToEndSharded):  # noqa: F811
    """The reference's sharded landing scenarios (inherited, run as
    written) and the packages held against each other on it."""

    def test_sharded_service_hello_equals_jax(self, tmp_path):
        """The port's service takes its sharded engine, and its hello
        describes the sharded landing as the JAX service's does over a JAX
        sharded engine of the same world."""
        import test_feeders as jtf

        hellos = []
        for world, loopback in ((jtf._world_sharded, jtf._Loopback),
                                (_world_sharded, _Loopback)):
            lb = loopback(world(), tmp_path / f"h{len(hellos)}")
            try:
                hellos.append(lb.service._op_hello({}))
            finally:
                lb.close()
        want, got = hellos
        assert got["engine"] == "sharded" and got["n_shards"] == 4
        assert {k: v for k, v in got.items() if k != "topic"} == \
            {k: v for k, v in want.items() if k != "topic"}

    def test_cross_package_sharded_landings_equal_inline(self, tmp_path):
        """A port worker lands on a JAX sharded service and a JAX worker
        on the port's: both landing engines' canonical state equals an
        inline JAX sharded engine fed the same frames, bit for bit."""
        import test_feeders as jtf

        frames = jtf._stream(128, seed=9)
        inline = jtf._world_sharded()
        for batch in jfast.FastWireIngest(inline.packer).ingest(
                jtf._wire(frames)).batches:
            inline.submit(batch)
        inline.drain_pending()
        want = _state(inline, "jax")
        for worker_mod, world, loopback, side in (
                (tfeeders, jtf._world_sharded, jtf._Loopback, "jax"),
                (jfeeders, _world_sharded, _Loopback, "port")):
            remote = world()
            lb = loopback(remote, tmp_path / side)
            try:
                lb.publish(frames)
                w = worker_mod.FeederWorker("127.0.0.1", lb.server.port,
                                            "w0", epoch=1)
                assert _drain(w) == 128
                w.stop()
                remote.drain_pending()
            finally:
                lb.close()
            got = _state(remote, side)
            assert sorted(got) == sorted(want)
            for name in want:
                assert_bits_equal(want[name], got[name], f"{side} {name}")


# -- the packages held against each other -------------------------------------

import sitewhere_tpu.feeders as jfeeders  # noqa: E402
import sitewhere_tpu.runtime.bus as jbus  # noqa: E402
import sitewhere_tpu.runtime.busnet as jbusnet  # noqa: E402
import sitewhere_tpu.sources.fastlane as jfast  # noqa: E402
import sitewhere_tpu_torch.feeders as tfeeders  # noqa: E402
import sitewhere_tpu_torch.runtime.bus as tbus  # noqa: E402
import sitewhere_tpu_torch.runtime.busnet as tbusnet  # noqa: E402
from sitewhere_tpu_torch import convert  # noqa: E402
from test_torch_ingest import _build  # noqa: E402
from test_torch_pipeline import assert_bits_equal  # noqa: E402

SIDES = {"jax": (jbus, jbusnet, jfeeders),
         "port": (tbus, tbusnet, tfeeders)}


def _frames(epoch, n=520, seed=11):
    """Hot wire frames, one a bus record (and a REGISTER frame now and
    then, which feeders drop as the inline lane does): registered,
    unassigned and unknown devices, empty and new measurement names,
    alert types, locations inside and outside the rules' zones."""
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 97 == 50:
            out.append(encode_frame(MessageType.REGISTER,
                                    WireCodec.encode_register(
                                        f"new-{i}", "sensor",
                                        area_token="area-1")))
        r = rng.random()
        token = (f"ghost-{i}" if r < 0.04 else "dev-unassigned"
                 if r < 0.07 else f"dev-{int(rng.integers(2, 60))}")
        ts = epoch + int(rng.integers(0, 900))
        kind = rng.choice(3, p=[0.6, 0.3, 0.1])
        if kind == 0:
            out.append(encode_frame(
                MessageType.MEASUREMENT, WireCodec.encode_measurement(
                    token, ts, str(rng.choice(["m1", "m2", "", "m-new"])),
                    float(rng.choice([rng.uniform(0, 100), 95.0])))))
        elif kind == 1:
            out.append(encode_frame(
                MessageType.LOCATION, WireCodec.encode_location(
                    token, ts, float(rng.uniform(-5, 15)),
                    float(rng.uniform(-5, 15)), float(rng.uniform(0, 9)))))
        else:
            out.append(encode_frame(
                MessageType.ALERT, WireCodec.encode_alert(
                    token, ts, str(rng.choice(["door", "", "smoke"])),
                    int(rng.integers(0, 4)), "from device")))
    return out


def _lanes(outputs):
    return {name: np.array(getattr(outputs, name)) for name in (
        "processed", "valid", "unregistered", "threshold_fired",
        "threshold_first_rule", "geofence_fired", "geofence_first_rule")}


def _state(engine, side):
    state = engine.canonical_state()
    return (dataclasses.asdict(state) if side == "jax"
            else convert.state_to_numpy(state))


@pytest.mark.parametrize("worker_side,service_side", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_landing_equals_an_inline_jax_engine(worker_side, service_side):
    """Frames published on the landing host's bus, packed by a worker of
    one package and landed on a service of the other: the steps' outputs,
    the landing engine's canonical state and its interned measurement
    names equal an inline jitted JAX engine's on the same frames."""
    epoch = int(time.time() * 1000) - 5000
    _, _, ref = _build("jax", f"feeder-ref-{worker_side}-{service_side}",
                       epoch)
    _, _, land = _build(service_side,
                        f"feeder-land-{worker_side}-{service_side}", epoch)
    frames = _frames(epoch)
    res = jfast.FastWireIngest(ref.packer).ingest(b"".join(frames))
    want = [_lanes(ref.submit(batch)) for batch in res.batches]
    assert len(want) > 3

    bus_mod, busnet_mod, feeders_mod = SIDES[service_side]
    got = []
    bus = bus_mod.EventBus(partitions=1)
    server = busnet_mod.BusServer(bus)
    server.start()
    feeders_mod.FeederService(
        land, server, "frames",
        on_outputs=lambda eng, outs, rec: got.append(_lanes(outs)))
    worker = SIDES[worker_side][2].FeederWorker(
        "127.0.0.1", server.port, "w0", epoch=1)
    try:
        for i, frame in enumerate(frames):
            bus.publish("frames", b"k%d" % i, frame)
        shipped = sum(worker.run_once(timeout_s=0.05) for _ in range(6))
        assert shipped == res.n_events
    finally:
        worker.stop()
        server.stop()
        bus.close()
    assert len(got) == len(want)
    for step, (w, g) in enumerate(zip(want, got)):
        for name in w:
            assert_bits_equal(w[name], g[name], f"step {step} {name}")
    ref_state, land_state = _state(ref, "jax"), _state(land, service_side)
    assert sorted(ref_state) == sorted(land_state)
    for name in ref_state:
        assert_bits_equal(ref_state[name], land_state[name], name)
    assert land.packer.measurements.snapshot() == \
        ref.packer.measurements.snapshot()
    assert land.packer.alert_types.snapshot() == \
        ref.packer.alert_types.snapshot()
