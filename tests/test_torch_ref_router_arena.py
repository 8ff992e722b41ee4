"""The reference's tests/test_router_arena.py, run on the port's router.

DIVERGES (the port's behaviour, asserted instead):
  TestRouterMicroBench: a host-timing assertion (the arena router >= 3x
    faster than the pre-arena one, medians of 7 runs). It measures the
    machine running the suite as much as the router: the JAX copy failed
    in a full run under 6 xdist workers (ROADMAP queue C). chip_smoke.py
    phase 12 (d) times the port's router at this shape on the card's
    host instead; here the port's router is held to the pre-arena oracle
    at the acceptance shape, untimed.
"""

import numpy as np

from test_torch_scenarios import load_reference

DIVERGES = {"TestRouterMicroBench"}

REFERENCE_TESTS = load_reference(globals(), "test_router_arena",
                                 diverges=DIVERGES)


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 8


class TestRouterMicroBench:
    def test_acceptance_shape_matches_the_pre_arena_router(self):
        """n=65536 flat rows, S=8, B=8192: the same routed columns and
        overflow as the pre-arena implementation (the micro-bench's two
        sides), with no clock in the assertion."""
        rng = np.random.default_rng(0)
        n, S, B = 65536, 8, 8192
        batch = _random_batch(rng, n, 1_000_000, p_valid=1.0)
        got = ShardRouter(S, B).route_columns(batch)
        want = _reference_route_columns(ShardRouter(S, B), batch)
        for name in _I32_COLS + _F32_COLS + ("valid",):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.batch, name)),
                np.asarray(getattr(want.batch, name)), err_msg=name)
        assert got.overflow_count == want.overflow_count
