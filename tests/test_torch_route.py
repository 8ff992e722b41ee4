"""The port's routers held against the JAX package's on the CPU.

Same seeded numpy inputs through both packages, no tolerance (everything
is int32 bits): `bucket_ranks`, the on-device route (`device_route_chunk`
through `build_device_route_program`, against the JAX shard_map program on
the virtual CPU mesh), the host router's `route_blob` (native and its
numpy plain version) and `route_columns`, at S in {1, 2, 4, 8}, on all
three wire layouts, with invalid rows, lane overflow and device indices
past any capacity (inside the wire field). Kept slots of the device
route's scatters are unique (asserted on the plain ranks).
"""

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.ops import pack as tpack
from sitewhere_tpu_torch.ops.route import (
    build_device_route_program, host_fits_device_route, route_lane_capacity)
from sitewhere_tpu_torch.ops.segments import bucket_ranks
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.parallel.router import ShardRouter

LAYOUTS = {"full": 5, "compact": 4, "packed": 3}


def flat_batch(S, B, layout, seed, n=None, p_valid=0.85, oob=True,
               skew=False):
    """A flat batch of n (default S*B) rows in `layout`, as numpy columns
    (a JAX EventBatch) and CPU tensors (the port's)."""
    from sitewhere_tpu.ops.pack import EventBatch as JBatch

    rng = np.random.default_rng(seed)
    n = S * B if n is None else n
    dev = rng.integers(0, 4 * S * B, n).astype(np.int32)
    if oob:
        dev[rng.random(n) < 0.05] = rng.integers(2 ** 21, 2 ** 22 - 1)
    if skew:
        dev[: n // 2] = 3 * S + 1
    et = (rng.choice([0, 2], n) if layout == "packed"
          else rng.choice([0, 1, 2], n)).astype(np.int32)
    is_meas, is_loc, is_alert = et == 0, et == 1, et == 2
    ts = rng.integers(-30_000, 30_000, n).astype(np.int32) \
        if layout == "packed" else rng.integers(-2 ** 30, 2 ** 30, n)
    cols = dict(
        device_idx=dev, tenant_idx=np.zeros(n, np.int32), event_type=et,
        ts=np.asarray(ts, np.int32),
        mm_idx=np.where(is_meas, rng.integers(0, 9, n), 0).astype(np.int32),
        value=np.where(is_meas, rng.uniform(-9, 9, n), 0).astype(np.float32),
        lat=np.where(is_loc, rng.uniform(-90, 90, n), 0).astype(np.float32),
        lon=np.where(is_loc, rng.uniform(-180, 180, n), 0).astype(np.float32),
        elevation=(np.where(is_loc, rng.uniform(1, 9, n), 0)
                   .astype(np.float32) if layout == "full"
                   else np.zeros(n, np.float32)),
        alert_type_idx=np.where(is_alert, rng.integers(0, 9, n),
                                0).astype(np.int32),
        alert_level=rng.integers(0, 5, n).astype(np.int32),
        valid=rng.random(n) < p_valid)
    jb = JBatch(**cols)
    tb = tpack.EventBatch(**{k: torch.from_numpy(v.copy())
                             for k, v in cols.items()})
    return jb, tb


def jax_blob(jb, layout):
    from sitewhere_tpu.ops.pack import batch_to_blob

    blob = batch_to_blob(jb)
    assert blob.shape[0] == LAYOUTS[layout]
    return blob


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_ranks_bit_equal(seed):
    import jax.numpy as jnp
    from sitewhere_tpu.ops.segments import bucket_ranks as j_bucket_ranks

    rng = np.random.default_rng(seed)
    for n, k in ((1, 1), (37, 3), (512, 9), (2048, 2)):
        keys = rng.integers(0, k, n).astype(np.int32)
        want = np.asarray(j_bucket_ranks(jnp.asarray(keys)))
        got = bucket_ranks(torch.from_numpy(keys))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # (key, rank) pairs are unique: the route's kept slots are too
        pairs = keys.astype(np.int64) * n + got.numpy()
        assert len(np.unique(pairs)) == n


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_device_route_bit_equal_to_jax(S, layout):
    """The port's route against the JAX shard_map program: the routed blob
    and each shard's drop count, on a batch that fits the lanes and on one
    that overflows them (skew), invalid rows and far devices included."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sitewhere_tpu.ops.route import \
        build_device_route_program as j_build
    from sitewhere_tpu.parallel import make_mesh as j_make_mesh
    from sitewhere_tpu.parallel.mesh import SHARD_AXIS

    B = 16
    mesh = j_make_mesh(S)
    j_prog = j_build(mesh, S, B)
    t_prog = build_device_route_program(make_mesh(S, device="cpu"), S, B)
    for seed, skew in ((S, False), (S + 50, True)):
        jb, _ = flat_batch(S, B, layout, seed, skew=skew)
        blob = jax_blob(jb, layout)
        want, wdrop = j_prog(jax.device_put(
            blob, NamedSharding(mesh, P(None, SHARD_AXIS))))
        got, gdrop = t_prog(blob)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gdrop.numpy(), np.asarray(wdrop))
        if skew and S > 1:
            assert int(gdrop.sum()) > 0
        if not skew and host_fits_device_route(
                np.asarray(jb.device_idx) & (2 ** 22 - 1), jb.valid, S, B,
                route_lane_capacity(B, S)):
            # what fits the lanes routes as the host router does
            expect, over = ShardRouter(S, B).route_blob(blob)
            assert len(over) == 0
            np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_host_router_bit_equal_to_jax(S, layout):
    """route_blob (native and plain), route_batch and route_columns against
    the JAX router: blobs, overflow rows and routed columns, with and
    without capacity overflow."""
    from sitewhere_tpu.parallel.router import ShardRouter as JRouter

    B = 16
    for seed, n in ((S + 7, S * B - 3), (S + 70, 3 * S * B // 2)):
        jb, tb = flat_batch(S, B, layout, seed, n=n)
        blob = jax_blob(jb, layout)
        jr, tr = JRouter(S, B), ShardRouter(S, B)
        want, wover = jr.route_blob(blob)
        for got, gover in (tr.route_blob(blob), tr.route_blob_plain(blob)):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(gover, wover)
        want_b, wover_b = jr.route_batch(jb)
        got_b, gover_b = tr.route_batch(tb)
        # the fused pack + route leaves the payload rows of a shard's
        # unused tail as it found them (both packages): heads compare
        # whole, payload rows where the head is valid
        np.testing.assert_array_equal(got_b[:, 0], want_b[:, 0])
        used = ((want_b[:, 0] >> 28) & 1).astype(bool)
        for r in range(1, want_b.shape[1]):
            np.testing.assert_array_equal(got_b[:, r][used],
                                          want_b[:, r][used])
        np.testing.assert_array_equal(gover_b, wover_b)
        jcols, tcols = jr.route_columns(jb), tr.route_columns(tb)
        for name in tpack.EventBatch.__dataclass_fields__:
            np.testing.assert_array_equal(
                np.asarray(getattr(tcols.batch, name)),
                np.asarray(getattr(jcols.batch, name)), err_msg=name)
        assert tcols.overflow_count == jcols.overflow_count
        if jcols.overflow is not None:
            for name in tpack.EventBatch.__dataclass_fields__:
                np.testing.assert_array_equal(
                    np.asarray(getattr(tcols.overflow, name)),
                    np.asarray(getattr(jcols.overflow, name)))


def test_host_guard_and_lane_capacity_match():
    from sitewhere_tpu.ops import route as jroute

    for S in (1, 2, 4, 8):
        for B in (1, 16, 100, 8192):
            assert route_lane_capacity(B, S) == \
                jroute.route_lane_capacity(B, S)
    for seed in range(6):
        jb, _ = flat_batch(4, 16, "compact", seed, skew=bool(seed % 2))
        for S, B, C in ((4, 16, 8), (4, 16, 4), (2, 32, 20)):
            assert host_fits_device_route(jb.device_idx, jb.valid, S, B, C) \
                == jroute.host_fits_device_route(jb.device_idx, jb.valid, S,
                                                 B, C)


def test_packed_blob_needs_eleven_lanes_a_shard():
    """A packed blob's ts base rides 11 lanes of each shard's row 0."""
    jb, _ = flat_batch(2, 8, "packed", 3)
    blob = jax_blob(jb, "packed")
    with pytest.raises(ValueError, match="per-shard width"):
        ShardRouter(2, 8).route_blob(blob)
    with pytest.raises(ValueError, match="per-shard width"):
        ShardRouter(2, 8).route_blob_plain(blob)
