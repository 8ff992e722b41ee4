"""The port's instance checkpoint manager (persist/checkpoint.py
InstanceCheckpointManager): every scenario of the reference's
tests/test_instance_checkpoint.py, run on the port's classes on the CPU."""

import pytest

from test_torch_scenarios import load_reference

REFERENCE_TESTS = load_reference(globals(), "test_instance_checkpoint")


@pytest.fixture(autouse=True)
def _disarm_replay_barrier():
    """A boot restore arms the port's process-global replay barrier; its
    budget can outlive the scenario (ROADMAP C): disarm it after each."""
    from sitewhere_tpu_torch.runtime.recovery import GLOBAL_REPLAY_BARRIER

    yield
    GLOBAL_REPLAY_BARRIER.disarm()


def test_every_reference_scenario_runs():
    assert len(REFERENCE_TESTS) == 3
