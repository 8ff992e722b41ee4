"""The reference's tests/test_staging_ring.py TestShardedDifferential, run
on the port: the sharded engine's staging ring at depth 3 against depth 1,
on the host route, the device route and the overflow requeue (drain blobs
bypass the ring). The port's engines run on the CPU (`make_mesh` builds
CPU shards), where the pooled host buffers stay off, as the reference
turns them off on its cpu backend.
"""

import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(globals(), "test_staging_ring",
                                 only={"TestShardedDifferential"})


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 3
