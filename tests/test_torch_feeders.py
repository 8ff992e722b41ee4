"""The feeder fleet's single-engine landing on the port: the reference's
tests/test_feeders.py scenarios run on `sitewhere_tpu_torch.feeders` (the
engines on the CPU), and the packages held against each other: a JAX
worker landing on a port service, a port worker landing on a JAX service
and a port worker on a port service, each against an inline jitted JAX
engine fed the same frames. Tolerance: none (f32 compared as bit
patterns).

DIVERGES (the port's behaviour, asserted instead):
  TestEndToEndSharded: a sharded engine lands with the feeders' sharded
    landing (ROADMAP A6e); the port's service refuses the port's own
    sharded engine, and its worker refuses a hello from one (the
    route-layout pack), both naming A6e.
"""

import dataclasses
import time

import numpy as np
import pytest

from test_torch_scenarios import load_reference

DIVERGES = {"TestEndToEndSharded"}

REFERENCE_TESTS = load_reference(globals(), "test_feeders", replacements=[
    # the port's interner is sequential (one shard class) and its engine
    # runs where it is told
    ('''                              max_zone_vertices=4,
                              shard_classes=shard_classes)''',
     '''                              max_zone_vertices=4)
'''),
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
], diverges=DIVERGES)


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 17


class TestEndToEndSharded:
    def test_sharded_engine_is_refused_naming_a6(self, tmp_path):
        """The port's own sharded engine, a PipelineEngine subclass, is
        refused by name: its blobs must not land down the single-engine
        path."""
        from sitewhere_tpu_torch.parallel import (
            ShardedPipelineEngine, make_mesh)
        from sitewhere_tpu_torch.registry.tensors import RegistryTensors

        engine = ShardedPipelineEngine(
            RegistryTensors(max_devices=64, max_zones=4, max_zone_vertices=4,
                            shard_classes=4),
            mesh=make_mesh(4, device="cpu"), per_shard_batch=16,
            name="torch-feeder-sharded")
        lb_bus = EventBus(partitions=1)
        server = BusServer(lb_bus)
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP A6e"):
                FeederService(engine, server, "frames")
            # nothing was mounted on the edge
            assert "feeder_hello" not in server._server.op_handlers
        finally:
            server._server.server_close()
            lb_bus.close()

    def test_sharded_hello_is_refused_naming_a6(self, tmp_path):
        """What a JAX sharded landing host says in its hello: its engine
        kind and its shard-congruent device interning."""
        engine = _world_single()
        lb = _Loopback(engine, tmp_path)
        hello = FeederService._op_hello(lb.service, {})
        try:
            for sharded in ({"engine": "sharded", "dev_shard_classes": 4,
                             "n_shards": 4, "per_shard_batch": 16},
                            {"dev_shard_classes": 4}):
                lb.server.register_op(
                    "feeder_hello", lambda req, s=sharded: {**hello, **s})
                w = lb.worker()
                with pytest.raises(NotImplementedError,
                                   match="ROADMAP A6e"):
                    w.connect()
                w.client.close()
        finally:
            lb.close()


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
