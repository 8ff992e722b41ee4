"""The reference's tests/test_device_route.py, run on the port.

The on-device route (ops/route.py) against the host arena router, the
host fit guard, and a device-routed engine against a host-routed oracle
engine (mixed traffic, skew fallback, overflow requeue, the pipelined
feeder), with the port's classes: `make_mesh` builds its shards on the
CPU. The route program takes the flat blob as it is (numpy), where the
reference first places it on its mesh with `jax.device_put`.
"""

import pytest

from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(globals(), "test_device_route",
                                 replacements=[
    ("jax.device_put(flat, self._flat_sharding(mesh))", "flat"),
])


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 16
