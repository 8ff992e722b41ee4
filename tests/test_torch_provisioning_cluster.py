"""The reference's three-host control-plane drill
(tests/test_provisioning_cluster.py) on the port: three supervised
`python -m sitewhere_tpu_torch serve --cluster-peers ... --supervise`
processes, each with its engine on the CPU (`--device cpu`). Slow, as the
reference marks it."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_provisioning_cluster",
                                 replacements=[
    ('''            [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
             "--supervise",''',
     '''            [sys.executable, "-u", "-m", "sitewhere_tpu_torch", "serve",
             "--device", "cpu", "--supervise",'''),
])


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 1
