"""The port's batch operations and schedules (batch/, schedule/): every scenario of the reference's
tests/test_batch_schedule.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_batch_schedule")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 10
