"""The read side on the card: the window ops, the replay engine's report,
the cache's delta fold and the mesh route, on each device, the card's
results held against the CPU's.

Every case runs on the CPU and, marked `cuda`, on the card (skipped
elsewhere) — run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_serving_card.py`.
This file imports no JAX (the CPU results are held against the JAX package
by tests/test_torch_analytics.py and tests/test_torch_serving.py).
Tolerance: none between devices (the sums fold in row order on both: the
plain version on the CPU, the kernel of csrc/segsum.cu on the card); the
reference's rtol=1e-6, atol=1e-6 between a cached (merged) grid and a
monolithic rescan.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    adversarial_window_rows, assert_matches_oracle, stats_mismatches)
from sitewhere_tpu_torch.analytics import (
    WindowedAnalyticsEngine, event_type_histogram, windowed_stats)
from sitewhere_tpu_torch.model.event import DeviceMeasurement
from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
from sitewhere_tpu_torch.serving import (
    QueryExecutor, QueryPlanner, WindowGridCache, WindowQuery)

T0 = 1_700_000_000_000
WINDOW_MS = 60_000
SPAN_MS = 10 * WINDOW_MS
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_grids_bits_equal(a, b):
    bad = stats_mismatches(a, b)
    assert not any(bad.values()), bad


class _Interner:
    def __init__(self):
        self._map = {}

    def lookup(self, token):
        return self._map.setdefault(token, len(self._map) + 1)


def _append(log, interner, rng, n, flush=True):
    log.append_events("t1", [DeviceMeasurement(
        name="temp", value=float(rng.normal(0, 30)),
        device_id=f"dev-{int(rng.integers(0, 40))}",
        event_date=T0 + int(rng.integers(0, SPAN_MS))) for _ in range(n)],
        interner)
    if flush:
        log.flush_tenant("t1")


def _row_order_sums_numpy(values, offsets):
    """The sum grid's semantics one add at a time: each segment from +0.0
    in row order, each partial sum rounded to f32 and flushed."""
    out = np.zeros(len(offsets) - 1, np.float32)
    for s in range(len(out)):
        acc = np.float32(0.0)
        for x in values[offsets[s]:offsets[s + 1]]:
            with np.errstate(invalid="ignore"):   # inf + -inf is NaN
                acc = np.float32(acc + x)
            if abs(acc) < np.finfo(np.float32).tiny:
                acc = np.copysign(np.float32(0.0), acc)
        out[s] = acc
    return out


@pytest.mark.parametrize("device", DEVICES)
def test_segment_row_sum_is_the_row_order_fold(device):
    """ops/segsum.py on each device (the plain version on the CPU, the
    kernel on the card) against one add at a time: empty segments, one
    row, around the kernel's 32-value load batch, a 5000-row segment,
    sums that cancel through denormals, and infinities."""
    from sitewhere_tpu_torch.ops import segsum

    dev = _device(device)
    rng = np.random.default_rng(5)
    sizes = [0, 1, 2, 31, 32, 33, 64, 65, 5000, 0, 7, 40, 3]
    parts = [rng.normal(0, 100, n).astype(np.float32) for n in sizes]
    parts[11] = (rng.choice([-1.0, 1.0], 40) * rng.uniform(1.0, 1.3, 40)
                 * 1.1754944e-38).astype(np.float32)
    parts[12] = np.array([np.inf, 1.0, -np.inf], np.float32)
    values = np.concatenate(parts)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    want = _row_order_sums_numpy(values, offsets)
    launches = segsum.segment_row_sum.launches
    got = segsum.segment_row_sum(torch.from_numpy(values).to(dev),
                                 torch.from_numpy(offsets).to(dev)).cpu()
    assert segsum.segment_row_sum.launches - launches == \
        (1 if dev.type == "cuda" else 0)
    got = got.numpy()
    nan = np.isnan(want)
    assert nan[12] and np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("hot_rows", [0, 20_000])
def test_window_ops_on_the_card_equal_the_cpu(hot_rows):
    dev = _device("cuda")
    keys, ts, value, valid = adversarial_window_rows(
        11, 50_000, 256, 32, 100, hot_rows=hot_rows)
    args = dict(window_ms=100, num_keys=256, n_windows=32)
    _assert_grids_bits_equal(
        windowed_stats(keys, ts, value, valid, device=dev, **args),
        windowed_stats(keys, ts, value, valid, device="cpu", **args))
    hist = dict(window_ms=100, n_types=8, n_windows=32)
    np.testing.assert_array_equal(
        event_type_histogram(keys, ts, valid, device=dev, **hist).cpu(),
        event_type_histogram(keys, ts, valid, device="cpu", **hist))


@pytest.mark.parametrize("device", DEVICES)
def test_report_accessors_work_on_each_device(device):
    dev = _device(device)
    rng = np.random.default_rng(3)
    log, interner = ColumnarEventLog(), _Interner()
    for _ in range(3):
        _append(log, interner, rng, 300)
    got = WindowedAnalyticsEngine(log, device=dev).measurement_windows(
        "t1", window_ms=WINDOW_MS, with_type_histogram=True)
    ref = WindowedAnalyticsEngine(log, device="cpu").measurement_windows(
        "t1", window_ms=WINDOW_MS, with_type_histogram=True)
    assert got.stats.count.device.type == "cpu"   # one copy to the host
    _assert_grids_bits_equal(got.stats, ref.stats)
    np.testing.assert_array_equal(got.type_counts, ref.type_counts)
    assert got.totals() == ref.totals() and got.totals()["events"] == 900
    # a report whose grids stay on the device answers the same
    on_dev = type(got)(got.t0_ms, got.window_ms, got.n_windows, got.key_ids,
                       got.key_tokens, got.stats.to(dev))
    assert on_dev.totals() == ref.totals()
    for row in (0, got.num_keys - 1):
        for name, series in on_dev.series(row).items():
            np.testing.assert_array_equal(_bits(series),
                                          _bits(ref.series(row)[name]))


@pytest.mark.parametrize("device", DEVICES)
def test_cache_delta_fold_on_each_device(device):
    dev = _device(device)
    rng = np.random.default_rng(5)
    log, interner = ColumnarEventLog(), _Interner()
    for _ in range(3):
        _append(log, interner, rng, 200)
    results = {}
    for d in (dev, torch.device("cpu")):
        ex = QueryExecutor(WindowedAnalyticsEngine(log, device=d),
                           QueryPlanner(log), WindowGridCache(), workers=2)
        results[d.type] = ex
    query = WindowQuery(tenant="t1", start_ms=T0, end_ms=T0 + SPAN_MS)
    monolithic = WindowedAnalyticsEngine(log, device=dev)
    try:
        steps = []
        for step in ("cold", "warm", "delta"):
            if step == "delta":
                _append(log, interner, rng, 150)
                _append(log, interner, rng, 23, flush=False)
            outs = {k: ex.query(query, timeout=60.0)
                    for k, ex in results.items()}
            got = outs[dev.type]
            steps.append((got["span"]["route"], got["info"]["cache_hit"],
                          got["info"]["delta_rows"]))
            _assert_grids_bits_equal(got["report"].stats,
                                     outs["cpu"]["report"].stats)
            assert_matches_oracle(got["report"],
                                  monolithic.measurement_windows(
                                      "t1", window_ms=WINDOW_MS, start_ms=T0,
                                      end_ms=T0 + SPAN_MS), step)
        assert steps == [("cache", False, 600), ("cache", True, 0),
                         ("cache", True, 173)]
    finally:
        for ex in results.values():
            ex.stop()


@pytest.mark.parametrize("device", DEVICES)
def test_mesh_route_raises_on_each_device(device):
    """The mesh route on each device (the name is the refusal's this test
    replaced): an explicit 8-shard mesh and the planner's mesh through the
    executor give the same bits, under each combine; counts, min and max
    equal the host route's, sums and means within the reference's
    rtol=1e-5, atol=1e-5; on the card, every bit equal to the CPU's."""
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    dev = _device(device)
    log, interner = ColumnarEventLog(), _Interner()
    _append(log, interner, np.random.default_rng(1), 500)
    engine = WindowedAnalyticsEngine(log, device=dev)
    cpu_engine = WindowedAnalyticsEngine(log, device="cpu")
    host = engine.measurement_windows("t1")
    mesh = make_mesh(8, device=dev)
    ex = QueryExecutor(engine, QueryPlanner(
        log, mesh_provider=lambda: mesh, mesh_row_threshold=1), workers=1)
    try:
        for combine in ("psum", "ring"):
            got = engine.measurement_windows("t1", mesh=mesh,
                                             combine=combine)
            served = ex.query(WindowQuery(tenant="t1", combine=combine),
                              timeout=30.0)
            assert served["span"]["route"] == "mesh"
            bad = stats_mismatches(got.stats, served["report"].stats)
            assert not any(bad.values()), (combine, bad)
            a, b = got.stats.to("cpu"), host.stats.to("cpu")
            for f in ("count", "min", "max"):
                assert torch.equal(getattr(a, f).view(torch.int32),
                                   getattr(b, f).view(torch.int32)), f
            for f in ("sum", "mean"):
                np.testing.assert_allclose(
                    getattr(a, f).numpy(), getattr(b, f).numpy(),
                    rtol=1e-5, atol=1e-5, equal_nan=True)
            want = cpu_engine.measurement_windows(
                "t1", mesh=make_mesh(8, device="cpu"), combine=combine)
            bad = stats_mismatches(got.stats, want.stats)
            assert not any(bad.values()), (combine, bad)
    finally:
        ex.stop()
