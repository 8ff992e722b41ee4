"""The REST gateway on the port (sitewhere_tpu_torch/web/): every scenario of
the reference's tests/test_web.py, run against the port's instance and
`RestServer` on the CPU through the reference's HTTP client."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_web")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 30
