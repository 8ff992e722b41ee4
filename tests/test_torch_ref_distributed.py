"""The reference's tests/test_distributed.py, run on the port's sharded
analytics (sitewhere_tpu_torch/parallel/distributed.py): both combines
against the single-device grid (within the reference's tolerance where it
gives one, bit for bit where it asks for bits), padding, the empty and
all-invalid replays, the sentinel edges, a bad combine, the bootstrap
helpers (single-process here: `initialize` answers False and every shard
is this process's), and the replay engine over a mesh. `make_mesh` builds
its shards on the CPU, and `windowed_stats` and the engine run there.
"""

import functools

import pytest

from sitewhere_tpu_torch.analytics import windows as twindows
from test_torch_scenarios import cpu_meshes, load_reference

REFERENCE_TESTS = load_reference(globals(), "test_distributed", replacements=[
    ("    from sitewhere_tpu_torch.analytics.engine import "
     "WindowedAnalyticsEngine\n",
     "    from test_torch_analytics import _CPUEngine as "
     "WindowedAnalyticsEngine\n")])
windowed_stats = functools.partial(twindows.windowed_stats, device="cpu")


@pytest.fixture(autouse=True)
def _cpu_meshes(monkeypatch):
    cpu_meshes(monkeypatch)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 10
