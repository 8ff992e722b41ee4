"""The port's outbound connectors and rule processors (connectors/, rules/processor.py): every scenario of the reference's
tests/test_connectors.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_connectors")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 10
