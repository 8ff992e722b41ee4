"""The port's the configuration model (runtime/config_model.py): every scenario of the reference's
tests/test_config_model.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_config_model")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 13
