"""The reference's two-host telemetry fan-in drill
(tests/test_cluster_telemetry.py) on the port: `serve --cluster-peers`
processes with their engines on the CPU (`--device cpu`). Slow, as the
reference marks it."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_cluster_telemetry",
                                 replacements=[
    ('''            [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
             "--config",''',
     '''            [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
             "--device", "cpu", "--config",'''),
])


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 1
