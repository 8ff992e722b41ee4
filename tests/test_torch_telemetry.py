"""The reference's tests/test_telemetry.py scenarios on the port: opt-in usage
telemetry (`runtime/telemetry.py`)."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_telemetry")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 3
