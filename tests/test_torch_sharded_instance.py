"""The instance over the sharded engine on the port.

The reference's tests/test_instance_sharded.py, run on the port
(`SiteWhereInstance(shards=8)` on the CPU: REST provisioning, ingest
through the decoded-events topic into the sharded step, a persisted rule
alert, a device's state read through the shard layout), and `python -m
sitewhere_tpu_torch serve --shards 8 --device cpu` as a user runs it:
boots, answers REST, takes events over its bus edge into the sharded step
and reads a device's state back (chip_smoke.py's `serve_sharded_drive`,
which phase 12 runs on the card).

The instance's planner mesh provider (`_serving_mesh`) answers the
sharded engine's mesh, as the reference's does, so a large window query
takes the mesh route: `test_the_planner_gets_no_mesh` (the name of the
divergence it replaced) holds that query's report against the JAX
package's sharded replay of the same columns, bit for bit.
"""

import chip_smoke
from sitewhere_tpu_torch.serving.planner import DEFAULT_MESH_ROW_THRESHOLD
from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_instance_sharded")


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 3


def test_the_planner_gets_no_mesh(sharded_instance):
    """The planner gets the sharded engine's mesh: a window query over
    the instance's log is routed "mesh" and counted, and its report
    equals the JAX engine's over a JAX 8-device mesh and the same
    appends, bit for bit."""
    import sitewhere_tpu.analytics.engine as jengine
    import sitewhere_tpu.model.event as jevent
    import sitewhere_tpu.persist.eventlog as jeventlog
    from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
    from sitewhere_tpu_torch.model import event as tevent
    from sitewhere_tpu_torch.serving.planner import WindowQuery
    from test_torch_analytics import assert_reports_equal

    inst = sharded_instance
    mesh = inst._serving_mesh()
    assert mesh is inst.pipeline_engine.mesh and mesh.n_shards == 8
    assert inst.registry_tensors.devices.shard_classes == 8
    rows = [(f"mdev-{i % 11}", 1_700_000_000_000 + 911 * i,
             1.37 ** (i % 31) - 9.5) for i in range(333)]

    def events(ev):
        return [ev.DeviceMeasurement(name="temp", value=v, device_id=tok,
                                     event_date=d) for tok, d, v in rows]

    inst.event_log.append_events("mesh-t", events(tevent))
    jax_log = jeventlog.ColumnarEventLog()
    jax_log.append_events("mesh-t", events(jevent))
    routed = inst.serving.report()["mesh_routed_total"]
    inst.analytics_planner.mesh_row_threshold = 1
    try:
        out = inst.serving.query(WindowQuery(tenant="mesh-t",
                                             window_ms=10_000), timeout=60.0)
    finally:
        inst.analytics_planner.mesh_row_threshold = \
            DEFAULT_MESH_ROW_THRESHOLD
    assert out["plan"].route == "mesh"
    assert inst.serving.report()["mesh_routed_total"] == routed + 1
    want = jengine.WindowedAnalyticsEngine(jax_log).measurement_windows(
        "mesh-t", window_ms=10_000, mesh=jax_mesh(8))
    assert_reports_equal(out["report"], want)


def test_serve_shards_8_boots_ingests_and_reads_state():
    # a smaller registry and per-shard batch than the default
    # configuration's keep the CPU steps light beside the rest of the suite;
    # one intra-op thread keeps the server's many small ops from
    # oversubscribing the cores the suite's other workers use
    out = chip_smoke.serve_sharded_drive("cpu", shards=8, env_extra={
        "SWTPU_PIPELINE__MAX_DEVICES": "4096",
        "SWTPU_PIPELINE__BATCH_SIZE": "256", "OMP_NUM_THREADS": "1"},
        feeders=True)
    assert out["shards"] == 8
    assert out["ingested"] == out["events"] > 0
    assert out["state_value"] == out["last_value"]
    # `--feeders`: a `serve --feeder` process landed a frame a device, and
    # the window query took the mesh route with the CPU's answer
    assert out["feeder_landed"] == out["events"]
    assert out["window_route"] == "mesh"
    assert out["window_keys"] == out["events"]
