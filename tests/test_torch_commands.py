"""The port's command routing, encoding, delivery and registration (commands/, registration/): every scenario of the reference's
tests/test_commands.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_commands")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 27
