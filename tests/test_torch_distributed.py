"""The port's window-sharded analytics held against the JAX package's, bit
for bit, on the CPU (the JAX side over the 8 virtual devices of
tests/conftest.py).

`sharded_windowed_stats` at S = 1, 2, 4 and 8 shards under both combines,
at row counts around the shard boundaries (0, 1, S, S + 1, 1001), on
non-integer values spanning decades and on rows carrying denormals, -0.0,
infinities and quiet and signalling NaNs of both signs: every count and
every f32 cell as a bit pattern. Two cases pin the combine orders the
reference follows (`psum` the sequential sum in shard order, not a
pairwise tree; `ring` shard 0's chain l0, l_{S-1}, ..., l1), on values
where the orders give different bits. Then the replay engine over a mesh,
the port's against the JAX engine's, and the engine's own refusal of a
mesh on another device. Tolerance: none.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import sitewhere_tpu.analytics.engine as jengine
import sitewhere_tpu.model.event as jevent
import sitewhere_tpu.persist.eventlog as jeventlog
from sitewhere_tpu.parallel.distributed import (
    sharded_windowed_stats as jax_sharded)
from sitewhere_tpu.parallel.mesh import make_mesh as jax_mesh
from sitewhere_tpu_torch.model import event as tevent
from sitewhere_tpu_torch.parallel import distributed as tdist
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.persist import eventlog as teventlog
from test_torch_analytics import _CPUEngine, assert_reports_equal, \
    assert_stats_bits_equal


def _f32(*bits):
    return np.array(bits, np.uint32).view(np.float32)


# denormals, signed zeros, infinities, NaNs (quiet, signalling, negative)
SPECIAL = np.concatenate([
    np.array([0.0, -0.0, np.inf, -np.inf], np.float32),
    _f32(0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800005, 0x7FC00011,
         0x000116C2, 0x800116C2, 0x00800000, 0x80800001)])


def _rows(n, K, W, seed, special=0.0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, n).astype(np.int32)
    ts = rng.integers(-1, W + 1, n).astype(np.int32)   # some out of range
    value = (rng.standard_normal(n) *
             10.0 ** rng.integers(-5, 6, n)).astype(np.float32)
    hit = rng.random(n) < special
    value[hit] = SPECIAL[rng.integers(0, len(SPECIAL), int(hit.sum()))]
    valid = rng.random(n) > 0.1
    return keys, ts, value, valid


def _both(rows, K, W, S, combine):
    kw = dict(window_ms=1, num_keys=K, n_windows=W, combine=combine)
    want = jax_sharded(*rows, mesh=jax_mesh(S), **kw)
    got = tdist.sharded_windowed_stats(
        *rows, mesh=make_mesh(S, device="cpu"), **kw)
    return got, want


@pytest.mark.parametrize("combine", ["psum", "ring"])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("n_of", ["0", "1", "S", "S+1", "1001"])
def test_sharded_stats_bit_equal_to_jax(S, combine, n_of):
    n = {"0": 0, "1": 1, "S": S, "S+1": S + 1, "1001": 1001}[n_of]
    for K, W, special in ((1, 1, 0.0), (3, 2, 0.3), (5, 4, 0.8)):
        rows = _rows(n, K, W, seed=1000 * S + n + K, special=special)
        got, want = _both(rows, K, W, S, combine)
        assert_stats_bits_equal(got, want, f"S={S} n={n} K={K} {combine}")


@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_lone_denormal_rows_flush_across_shards(combine):
    """One or two rows of a denormal per shard: the collective flushes
    them to +0.0 in every grid, though one device keeps a lone row."""
    for n in (8, 16):
        rows = (np.zeros(n, np.int32), np.zeros(n, np.int32),
                np.full(n, _f32(0x000116C2)[0]), np.ones(n, bool))
        got, want = _both(rows, 1, 1, 8, combine)
        assert_stats_bits_equal(got, want, f"n={n}")
        for grid in (got.sum, got.mean, got.min, got.max):
            assert int(grid.view(torch.int32)) == 0


def _one_row_a_shard(values):
    S = len(values)
    return (np.zeros(S, np.int32), np.zeros(S, np.int32),
            np.asarray(values, np.float32), np.ones(S, bool))


def test_psum_is_the_sequential_sum_in_shard_order():
    """Values whose sequential sum ((l0 + l1) + l2) + ... and pairwise
    tree ((l0 + l1) + (l2 + l3)) + ... round apart: the port gives the
    sequential sum's bits, as the reference's collective does."""
    vals = np.array([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24,
                     2.0 ** -24, 0.0, 0.0, 0.0], np.float32)
    seq = np.float32(0.0)
    for v in vals:
        seq = np.float32(seq + v)
    pairs = vals.copy()
    while len(pairs) > 1:
        pairs = (pairs[0::2] + pairs[1::2]).astype(np.float32)
    assert seq.view(np.int32) != pairs[0].view(np.int32)
    got, want = _both(_one_row_a_shard(vals), 1, 1, 8, "psum")
    assert_stats_bits_equal(got, want)
    assert int(got.sum.view(torch.int32)) == int(seq.view(np.int32))


def test_ring_is_shard_zeros_chain():
    """The ring returns shard 0's chain ((l0 + l7) + l6) + ... + l1, not
    the sequential sum in shard order: values where the two differ."""
    vals = np.array([1.0, 2.0 ** -24, 2.0 ** -24, 0.0, 0.0, 0.0, 0.0,
                     -1.0], np.float32)
    chain = vals[0]
    for v in vals[:0:-1]:
        chain = np.float32(chain + v)
    seq = np.float32(0.0)
    for v in vals:
        seq = np.float32(seq + v)
    assert chain.view(np.int32) != seq.view(np.int32)
    got, want = _both(_one_row_a_shard(vals), 1, 1, 8, "ring")
    assert_stats_bits_equal(got, want)
    assert int(got.sum.view(torch.int32)) == int(chain.view(np.int32))


@pytest.mark.parametrize("combine", ["psum", "ring"])
@pytest.mark.parametrize("per_shard", [1, 3])
def test_nan_and_signed_zero_payloads_through_the_combine(combine,
                                                          per_shard):
    """A quiet NaN, a signalling NaN (0x7F800001), a negative NaN and -0.0
    beside +0.0, at one and at several rows a shard, in every position:
    the combine's NaN and signed-zero picks are the reference's."""
    picks = _f32(0x7FC00000, 0x7F800001, 0xFFC00002, 0x80000000, 0x0,
                 0x3F800000)
    rng = np.random.default_rng(per_shard)
    for trial in range(24):
        n = 8 * per_shard
        value = picks[rng.integers(0, len(picks), n)]
        rows = (rng.integers(0, 2, n).astype(np.int32),
                np.zeros(n, np.int32), value, rng.random(n) > 0.2)
        got, want = _both(rows, 2, 1, 8, combine)
        assert_stats_bits_equal(got, want, f"trial {trial}")


def test_bad_combine_is_rejected_before_any_work():
    with pytest.raises(ValueError, match="gossip"):
        tdist.sharded_windowed_stats(
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.float32), np.ones(1, bool), window_ms=1,
            num_keys=1, n_windows=1, mesh=make_mesh(2, device="cpu"),
            combine="gossip")


def _twin_logs(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000
    rows = [(f"dev-{int(rng.integers(0, 40))}",
             t0 + int(rng.integers(0, 900_000)),
             float(rng.standard_normal() * 10.0 ** rng.integers(-3, 4)))
            for _ in range(n)]
    logs = {}
    for side, ev, elog in (("jax", jevent, jeventlog),
                           ("port", tevent, teventlog)):
        log = elog.ColumnarEventLog()
        log.append_events("t1", [ev.DeviceMeasurement(
            name="temp", value=v, event_date=d) for _, d, v in rows],
            [tok for tok, _, _ in rows])
        logs[side] = log
    return logs


@pytest.mark.parametrize("combine", ["psum", "ring"])
def test_analytics_engine_mesh_replay(combine):
    """The replay engine over an 8-shard mesh: the port's report (keys,
    tokens, windows, every grid's bits) equals the JAX engine's over its
    8-device mesh, with the type histogram too."""
    logs = _twin_logs()
    want = jengine.WindowedAnalyticsEngine(logs["jax"]).measurement_windows(
        "t1", window_ms=60_000, mesh=jax_mesh(8), combine=combine,
        with_type_histogram=True)
    got = _CPUEngine(logs["port"]).measurement_windows(
        "t1", window_ms=60_000, mesh=make_mesh(8, device="cpu"),
        combine=combine, with_type_histogram=True)
    assert_reports_equal(got, want)
    assert set(got.timings) >= {"scan", "compact", "h2d", "device", "d2h"}


def test_a_mesh_on_another_device_is_refused():
    logs = _twin_logs(n=50)
    mesh = make_mesh(2, device="meta")
    with pytest.raises(ValueError, match="engine's device"):
        _CPUEngine(logs["port"]).measurement_windows("t1", mesh=mesh)


def test_sharded_replays_on_one_device_run_one_at_a_time(monkeypatch):
    """Eight threads replay over one mesh at once (as the serving
    executor's workers do): the replays never overlap on the device, each
    holding S partial grids, and each result is the lone call's bits."""
    rows = _rows(3000, 16, 8, seed=5)
    kw = dict(window_ms=1, num_keys=16, n_windows=8,
              mesh=make_mesh(8, device="cpu"))
    want = tdist.sharded_windowed_stats(*rows, **kw)
    inner = tdist._sharded_stats
    active, peak, lock = [0], [0], threading.Lock()

    def counted(*args, **kwargs):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            time.sleep(0.01)   # room for another thread to overlap
            return inner(*args, **kwargs)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(tdist, "_sharded_stats", counted)
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(
            lambda _: tdist.sharded_windowed_stats(*rows, **kw), range(8)))
    assert peak[0] == 1
    for out in got:
        assert_stats_bits_equal(out, want, "concurrent replay")


def test_live_mesh_is_none_however_many_cards(monkeypatch):
    """A process that joined no cluster and has no CUDA device has no
    live mesh, whatever card count is reported: the planner's default
    mesh is None, so a single-engine instance on the CPU keeps its large
    queries on its own device's host route. (With two or more cards the
    live mesh spans them: tests/test_torch_multicard.py's card case; a
    mesh spans processes once they joined one world,
    tests/test_torch_multiprocess_stats.py.)"""
    from sitewhere_tpu_torch.instance import SiteWhereInstance

    inst = SiteWhereInstance(
        instance_id="one-engine", device="cpu", enable_pipeline=True,
        max_devices=64, max_zones=4, max_zone_vertices=4, batch_size=16,
        measurement_slots=4, max_tenants=4)
    for count in (2, 8):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert tdist.live_mesh() is None
        assert inst._serving_mesh() is None
