"""The reference's tests/test_alert_lanes.py TestDifferentialSharded, run on
the port: the sharded engine's per-shard alert lanes (shard-major decode,
per-shard compaction and overflow, one lane fetch a materialize) against
the mask-scan oracle (`materialize_alerts_maskscan`, the port's copy of
the reference's) over the flattened per-row outputs. The port's engines
run on the CPU (`make_mesh` builds CPU shards); the port's batches are
dataclasses of arrays, flattened field by field where the reference maps a
JAX pytree.
"""

import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(
    globals(), "test_alert_lanes",
    replacements=[(
        "        flat_batch = jax.tree_util.tree_map(flat, batch)\n",
        "        flat_batch = batch.replace(**{f: flat(getattr(batch, f)) "
        "for f in batch.__dataclass_fields__})\n")],
    only={"TestDifferentialSharded"})


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 4
