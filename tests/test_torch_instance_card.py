"""The port's instance on the card (`cuda` marker; skips without CUDA): a
small instance boots on the GPU, one wire payload goes through an event
source, and the step it takes launches both hand kernels of the instance
path (the geofence kernel and the rule-program kernel), each counted once
per replay of the captured step.

JAX-free, so it runs on the card with `python -m pytest --noconftest -m
cuda tests/test_torch_instance_card.py`.
"""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_instance_on_the_card_launches_both_kernels(card, tmp_path):
    from sitewhere_tpu_torch.instance import SiteWhereInstance
    from sitewhere_tpu_torch.model import (
        Area, Device, DeviceAssignment, DeviceType, Location, Zone)
    from sitewhere_tpu_torch.pipeline.engine import GeofenceRule
    from sitewhere_tpu_torch.pipeline.graph import STEP_KERNELS
    from sitewhere_tpu_torch.sources import InboundEventSource, WireDecoder
    from sitewhere_tpu_torch.transport.wire import (
        MessageType, WireCodec, encode_frame)

    inst = SiteWhereInstance(instance_id="card-test",
                             data_dir=str(tmp_path), enable_pipeline=True,
                             max_devices=1024, max_zones=8,
                             max_zone_vertices=8, batch_size=256,
                             measurement_slots=4, max_tenants=4,
                             device=card)
    inst.start()
    try:
        tenant = inst.get_tenant_engine("default")
        dm = tenant.registry
        dtype = dm.create_device_type(DeviceType(token="sensor"))
        area = dm.create_area(Area(token="yard"))
        dm.create_zone(Zone(token="z0", area_id=area.id, bounds=[
            Location(latitude=0.0, longitude=0.0),
            Location(latitude=0.0, longitude=2.0),
            Location(latitude=2.0, longitude=2.0),
            Location(latitude=2.0, longitude=0.0)]))
        for i in range(32):
            d = dm.create_device(Device(token=f"d{i}",
                                        device_type_id=dtype.id))
            dm.create_device_assignment(DeviceAssignment(
                token=f"a{i}", device_id=d.id))
        engine = inst.pipeline_engine
        engine.add_geofence_rule(GeofenceRule(token="g", zone_token="z0",
                                              condition="inside"))
        inst.install_rule_program("default", {
            "token": "hot", "alert_level": "WARNING",
            "when": {"pred": "value", "measurement": "m1", "op": ">",
                     "value": 50.0}})
        source = InboundEventSource("wire", WireDecoder(), [], tenant.bus,
                                    tenant.naming)
        tenant.event_sources.add_source(source)
        source.start()
        rng = np.random.default_rng(3)
        now = int(time.time() * 1000)
        frames = []
        for i in range(32):
            frames.append(encode_frame(MessageType.MEASUREMENT,
                                       WireCodec.encode_measurement(
                                           f"d{i}", now + i, "m1",
                                           float(rng.uniform(0, 100)))))
            frames.append(encode_frame(MessageType.LOCATION,
                                       WireCodec.encode_location(
                                           f"d{i}", now + i,
                                           float(rng.uniform(-1, 3)),
                                           float(rng.uniform(-1, 3)))))
        for wrapper in STEP_KERNELS.values():
            wrapper.launches = 0
        engine.graph_kernel_launches.clear()
        source.on_encoded_event_received(b"".join(frames))
        deadline = time.time() + 120
        while engine.batches_processed == 0 or inst._ingest_backlog() > 0:
            assert time.time() < deadline, "payload not ingested"
            time.sleep(0.01)
        launched = {name: w.launches + engine.graph_kernel_launches.get(
            name, 0) for name, w in STEP_KERNELS.items()}
        assert launched["points_in_zones"] >= 1, launched
        assert launched["eval_rule_programs"] >= 1, launched
        assert engine.graph_captures == len(engine._graphs) >= 1
        assert inst.topology()["device"]["type"] == "cuda"
    finally:
        inst.stop()
