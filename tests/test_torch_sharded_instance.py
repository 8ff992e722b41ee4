"""The instance over the sharded engine on the port.

The reference's tests/test_instance_sharded.py, run on the port
(`SiteWhereInstance(shards=8)` on the CPU: REST provisioning, ingest
through the decoded-events topic into the sharded step, a persisted rule
alert, a device's state read through the shard layout), and `python -m
sitewhere_tpu_torch serve --shards 8 --device cpu` as a user runs it:
boots, answers REST, takes events over its bus edge into the sharded step
and reads a device's state back (chip_smoke.py's `serve_sharded_drive`,
which phase 12 runs on the card).

DIVERGES (the port's behaviour, asserted instead; no reference test
checks it): the instance's planner mesh provider (`_serving_mesh`). The
reference hands the planner the sharded engine's mesh, so large window
queries take the mesh route; the port's analytics engine serves no mesh
until sharded analytics (ROADMAP A6c), so the provider answers None and
every query keeps the host route (`test_the_planner_gets_no_mesh`).
"""

import chip_smoke
from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_instance_sharded")


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 3


def test_the_planner_gets_no_mesh(sharded_instance):
    assert sharded_instance._serving_mesh() is None
    assert sharded_instance.registry_tensors.devices.shard_classes == 8


def test_serve_shards_8_boots_ingests_and_reads_state():
    # a smaller registry and per-shard batch than the default
    # configuration's keep the CPU steps light beside the rest of the suite
    out = chip_smoke.serve_sharded_drive("cpu", shards=8, env_extra={
        "SWTPU_PIPELINE__MAX_DEVICES": "4096",
        "SWTPU_PIPELINE__BATCH_SIZE": "256"})
    assert out["shards"] == 8
    assert out["ingested"] == out["events"] > 0
    assert out["state_value"] == out["last_value"]
