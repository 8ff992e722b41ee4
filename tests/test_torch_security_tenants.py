"""The port's tenants, users, JWT tokens and tenant engines (multitenant/, security/): every scenario of the reference's
tests/test_security_tenants.py, run on the port's classes on the CPU."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_security_tenants")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 14
