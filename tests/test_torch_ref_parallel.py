"""The reference's tests/test_parallel.py, run on the port's sharded path:
TestShardRouter, TestShardedEngine, TestRouteBlob and TestElasticCheckpoint
(the routing algebra, the sharded step against the single engine, the
blob router against the column router, and canonical state across
topologies through the checkpointer). `make_mesh` builds its shards on the
CPU and the single engine runs there.

DIVERGES (the port's behaviour, asserted instead):
  TestRouteBlob.test_native_and_fallback_agree: the reference switches its
    native library off (`native.available`) to reach the numpy router; the
    port's library is never optional, so its numpy router is the plain
    version `route_blob_plain`, held to the native one on the same blob.
"""

import numpy as np
import pytest

from test_torch_scenarios import CPUPipelineEngine, cpu_meshes, load_reference

DIVERGES = {"TestRouteBlob.test_native_and_fallback_agree"}

REFERENCE_TESTS = load_reference(
    globals(), "test_parallel",
    replacements=[(
        "        from sitewhere_tpu_torch.pipeline.engine import PipelineEngine\n",
        "        from test_torch_scenarios import CPUPipelineEngine as "
        "PipelineEngine\n")],
    only={"TestShardRouter", "TestShardedEngine", "TestRouteBlob",
          "TestElasticCheckpoint"},
    diverges=DIVERGES)
PipelineEngine = CPUPipelineEngine


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 23


def test_native_router_and_its_plain_version_agree():
    from sitewhere_tpu_torch.ops.pack import batch_to_blob

    batch = TestRouteBlob()._flat_batch(n=1000, n_dev=23, seed=9)
    router = ShardRouter(n_shards=8, per_shard_batch=16)
    blob = batch_to_blob(batch)
    nat_out, nat_over = router.route_blob(blob)
    py_out, py_over = router.route_blob_plain(blob)
    np.testing.assert_array_equal(nat_out, py_out)
    np.testing.assert_array_equal(nat_over, py_over)
