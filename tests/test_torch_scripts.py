"""The port's the versioned script manager (runtime/scripts.py): every scenario of the reference's
tests/test_scripts.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_scripts")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 17
