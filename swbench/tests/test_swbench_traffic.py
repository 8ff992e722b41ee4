"""The generator: the same seed gives the same pool, and each reuse of
the pool moves its events forward in time."""

import numpy as np

from swbench.tests.conftest import tiny_spec


def _pool(seed):
    from swbench.traffic import make_pool

    spec = tiny_spec("fleet-100k.closed")
    return make_pool(spec["traffic"], spec["config"], seed), spec


def test_same_seed_same_pool():
    a, _ = _pool(2 ** 31 + 12345)
    b, _ = _pool(2 ** 31 + 12345)
    c, _ = _pool(2 ** 31 + 12346)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert any(not np.array_equal(x["dev"], z["dev"]) for x, z in zip(a, c))


def test_pool_follows_the_mix():
    pool, spec = _pool(7)
    et = np.concatenate([p["et"] for p in pool])
    share = np.bincount(et, minlength=3) / et.size
    np.testing.assert_allclose(share, [0.6, 0.3, 0.1], atol=0.06)
    for p in pool:
        assert p["dev"].min() >= 1
        assert p["dev"].max() <= spec["config"]["registered_devices"]
        assert not p["lat"][p["et"] != 1].any()
        assert not p["value"][p["et"] != 0].any()


def test_time_shift_moves_events_forward():
    from swbench.traffic import (
        batch_for_step, pool_span_ms, port_batches, step_source)

    pool, spec = _pool(11)
    tr = spec["traffic"]
    P = tr["pool"]
    batches = port_batches(pool)
    assert step_source(P + 1, tr) == (1, pool_span_ms(tr))
    first = batch_for_step(1, tr, pool, batches).ts.numpy()
    again = batch_for_step(P + 1, tr, pool, batches).ts.numpy()
    np.testing.assert_array_equal(again - first, pool_span_ms(tr))
    # every reuse dates all its events after every earlier one
    span = max(p["ts"].max() for p in pool) - min(p["ts"].min() for p in pool)
    assert span < pool_span_ms(tr)
    last = batch_for_step(P - 1, tr, pool, batches).ts.numpy().max()
    assert batch_for_step(P, tr, pool, batches).ts.numpy().min() > last
