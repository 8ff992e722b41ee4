"""The mesh query and the instance over card blocks, on the CPU.

`sharded_windowed_stats` over a mesh of K = 2 and 4 CPU blocks (each block
folds its own shards' rows, the partial grids meet on the first block in
shard order, the combine runs there) held against the JAX call over 8
virtual devices under both combines, on rows around the shard boundaries
carrying denormals, -0.0, infinities and NaNs of both signs, and on the
one-shard-a-row cases that pin the combine orders; then the replay engine
over such a mesh with its grids brought back to its own device.

Then the instance over two blocks: the reference's
tests/test_instance_sharded.py (REST provisioning, ingest through the
decoded-events topic into the sharded step, a persisted rule alert, a
device's state read through the shard layout), run on the port with
`make_mesh` giving two CPU blocks, and the planner's mesh query against
the JAX engine's over 8 devices. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import sitewhere_tpu.analytics.engine as jengine
from sitewhere_tpu.parallel.distributed import (
    sharded_windowed_stats as jax_sharded)
from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
from sitewhere_tpu_torch.parallel import distributed as tdist
from sitewhere_tpu_torch.parallel import mesh as tmesh
from test_torch_analytics import (
    _CPUEngine, assert_reports_equal, assert_stats_bits_equal)
from test_torch_distributed import _f32, _one_row_a_shard, _rows, _twin_logs
from test_torch_scenarios import load_reference

# the reference's instance tests, loaded first: they are the module's
# only tests so far
REFERENCE_TESTS = load_reference(globals(), "test_instance_sharded")

S = 8
_make_mesh = tmesh.make_mesh


def blocks(K):
    return _make_mesh(S, devices=("cpu",) * K)


def _both(rows, K, W, n_cards, combine, timings=None):
    kw = dict(window_ms=1, num_keys=K, n_windows=W, combine=combine)
    want = jax_sharded(*rows, mesh=jax_mesh(S), **kw)
    got = tdist.sharded_windowed_stats(*rows, mesh=blocks(n_cards),
                                       timings=timings, **kw)
    return got, want


@pytest.mark.parametrize("combine", ["psum", "ring"])
@pytest.mark.parametrize("n_cards", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 8, 9, 1001])
def test_mesh_query_over_blocks_bit_equal_to_jax(n_cards, combine, n):
    for K, W, special in ((1, 1, 0.0), (3, 2, 0.3), (5, 4, 0.8)):
        rows = _rows(n, K, W, seed=700 * n_cards + n + K, special=special)
        timings = {}
        got, want = _both(rows, K, W, n_cards, combine, timings)
        assert_stats_bits_equal(got, want,
                                f"K={n_cards} n={n} keys={K} {combine}")
        assert len(timings["fold_s_by_card"]) == n_cards


@pytest.mark.parametrize("combine", ["psum", "ring"])
@pytest.mark.parametrize("n_cards", [2, 4])
def test_adversarial_rows_over_blocks(n_cards, combine):
    """Lone denormal rows a shard, the order-pinning values (the
    sequential psum and shard 0's ring chain round apart from other
    orders) and NaN / signed-zero payloads: the reference's bits over the
    blocks."""
    for n in (8, 16):
        rows = (np.zeros(n, np.int32), np.zeros(n, np.int32),
                np.full(n, _f32(0x000116C2)[0]), np.ones(n, bool))
        got, want = _both(rows, 1, 1, n_cards, combine)
        assert_stats_bits_equal(got, want, f"denormal n={n}")
    for vals in ([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24, 0.0,
                  0.0, 0.0],
                 [1.0, 2.0 ** -24, 2.0 ** -24, 0.0, 0.0, 0.0, 0.0, -1.0]):
        got, want = _both(_one_row_a_shard(np.array(vals, np.float32)),
                          1, 1, n_cards, combine)
        assert_stats_bits_equal(got, want, f"order {vals}")
    picks = _f32(0x7FC00000, 0x7F800001, 0xFFC00002, 0x80000000, 0x0,
                 0x3F800000)
    rng = np.random.default_rng(n_cards)
    for trial in range(12):
        n = 8 * (1 + trial % 3)
        rows = (rng.integers(0, 2, n).astype(np.int32),
                np.zeros(n, np.int32), picks[rng.integers(0, 6, n)],
                rng.random(n) > 0.2)
        got, want = _both(rows, 2, 1, n_cards, combine)
        assert_stats_bits_equal(got, want, f"trial {trial}")


@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_analytics_engine_over_blocks(combine):
    """The replay engine over two blocks: its report equals the JAX
    engine's over 8 devices, and the grids come back on its device."""
    logs = _twin_logs()
    want = jengine.WindowedAnalyticsEngine(logs["jax"]).measurement_windows(
        "t1", window_ms=60_000, mesh=jax_mesh(S), combine=combine,
        with_type_histogram=True)
    got = _CPUEngine(logs["port"]).measurement_windows(
        "t1", window_ms=60_000, mesh=blocks(2), combine=combine,
        with_type_histogram=True)
    assert_reports_equal(got, want)
    assert got.stats.count.device == torch.device("cpu")


# -- the instance over two blocks ----------------------------------------------

def two_blocks(n_shards=None, device="cuda", devices=None):
    """`make_mesh` with every mesh of an even shard count in two CPU
    blocks."""
    n = 1 if n_shards is None else int(n_shards)
    if devices is None and n % 2 == 0:
        return _make_mesh(n, devices=("cpu", "cpu"))
    return _make_mesh(n, device="cpu", devices=devices)


@pytest.fixture(scope="module", autouse=True)
def _two_block_meshes():
    """Module-wide, so the reference's module-scoped instance is built on
    two blocks too."""
    import sitewhere_tpu_torch.parallel as parallel

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(parallel, "make_mesh", two_blocks)
        patch.setattr(tmesh, "make_mesh", two_blocks)
        yield


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 3


def test_the_instance_runs_on_two_blocks_and_takes_their_mesh(
        sharded_instance):
    """The instance's engine holds two blocks of four shards; its planner
    takes that mesh, and a window query over the instance's log, routed
    "mesh", equals the JAX engine's over 8 devices, bit for bit."""
    import sitewhere_tpu.model.event as jevent
    import sitewhere_tpu.persist.eventlog as jeventlog
    from sitewhere_tpu_torch.model import event as tevent
    from sitewhere_tpu_torch.serving.planner import (
        DEFAULT_MESH_ROW_THRESHOLD, WindowQuery)

    inst = sharded_instance
    engine = inst.pipeline_engine
    assert engine.n_cards == 2 and engine.shards_per_card == 4
    mesh = inst._serving_mesh()
    assert mesh is engine.mesh
    topo = inst.topology()["mesh"]
    assert [c["shards"] for c in topo["cards"]] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
    rows = [(f"mdev-{i % 11}", 1_700_000_000_000 + 911 * i,
             1.37 ** (i % 31) - 9.5) for i in range(333)]

    def events(ev):
        return [ev.DeviceMeasurement(name="temp", value=v, device_id=tok,
                                     event_date=d) for tok, d, v in rows]

    inst.event_log.append_events("mesh-t", events(tevent))
    jax_log = jeventlog.ColumnarEventLog()
    jax_log.append_events("mesh-t", events(jevent))
    inst.analytics_planner.mesh_row_threshold = 1
    try:
        out = inst.serving.query(WindowQuery(tenant="mesh-t",
                                             window_ms=10_000), timeout=60.0)
    finally:
        inst.analytics_planner.mesh_row_threshold = \
            DEFAULT_MESH_ROW_THRESHOLD
    assert out["plan"].route == "mesh"
    want = jengine.WindowedAnalyticsEngine(jax_log).measurement_windows(
        "mesh-t", window_ms=10_000, mesh=jax_mesh(S))
    assert_reports_equal(out["report"], want)
