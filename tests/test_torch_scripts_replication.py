"""The reference's tests/test_scripts_replication.py scenarios on the port:
script, scripted-rule, rule-program, anomaly-model and actuation-policy
replication through the port's gossip, durable restarts and checkpoints."""

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_scripts_replication")


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 17
