"""The reference's tests/test_supervisor.py scenarios on the port: the gang-
restart supervisor (`runtime/supervisor.py`)."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_supervisor")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 3
