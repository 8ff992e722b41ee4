"""The reference's tests/test_tenant_replication.py scenarios on the port:
tenant, user and authority provisioning (`multitenant/replication.py`
ProvisioningReplicator) between port instances on the CPU, and the REST
gateway's replication fields through the port's client."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_tenant_replication")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 18
