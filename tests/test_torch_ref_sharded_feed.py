"""The reference's tests/test_feed.py TestShardedPipelinedSubmitter, run on
the port: the sharded pipelined feeder against sequential submit, overflow
requeue order under concurrent stagers, drain backpressure, and the
single-controller refusal. The port's engines run on the CPU (`make_mesh`
builds CPU shards).
"""

import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(globals(), "test_feed",
                                 only={"TestShardedPipelinedSubmitter"})


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 4
