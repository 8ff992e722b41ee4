"""The CUDA geofence kernel's exact y-rejection, held on the CPU.

The kernel (sitewhere_tpu_torch/csrc/geofence.cu) skips every (point, zone)
pair whose py lies outside the zone's y-range, and a zone whose y-range
misses all the points of a warp; `zone_reject_mask` in ops/geofence.py is
the per-pair predicate in plain torch. Here, on random
worlds, the adversarial fixture and 20 seeded worlds whose
coordinates mix normal values, +-0.0, denormals, +-inf and NaN:
  - no rejected pair has an edge that straddles the point's ray (counted
    independently, in numpy, with the reference's denormal flush);
  - no rejected pair is inside per the plain version;
  - the plain version equals the JAX package's XLA scan, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import adversarial_world, geofence_bound_ms, random_world
from sitewhere_tpu.ops import geofence as jgeo
from sitewhere_tpu_torch.ops.geofence import (
    points_in_zones, zone_reject_mask)

FLT_MIN = np.float32(1.1754943508222875e-38)
_jit_xla_pip = jax.jit(jgeo.points_in_zones)


def _flush(a):
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < FLT_MIN, np.copysign(np.float32(0), a), a)


def _any_straddle(lat, verts):
    """bool [B, Z]: some edge of the zone straddles the point's ray."""
    py = _flush(lat)[:, None, None]                       # [B, 1, 1]
    above = _flush(verts)[None, :, :, 0] > py             # [B, Z, V]
    return (above != np.roll(above, -1, axis=2)).any(axis=2)


def _mixed_world(seed):
    """Coordinates drawn from normal values, +-0.0, denormals, +-inf and
    NaN; the first two zones are clean polygons with points at their
    centres, on their y-bounds and a ulp beside them, so that both
    rejection and containment occur."""
    rng = np.random.default_rng(1000 + seed)
    B, Z, V = int(rng.integers(20, 80)), int(rng.integers(4, 14)), \
        int(rng.integers(3, 9))
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, np.inf,
                        -np.inf, np.nan], np.float32)

    def draw(shape, p_special):
        normal = rng.normal(0, 5, shape).astype(np.float32)
        pick = rng.choice(special, shape)
        return np.where(rng.random(shape) < p_special, pick, normal)

    verts = draw((Z, V, 2), 0.15)
    lat, lon, verts[:2] = random_world(seed, 2, 2, V, box=(-8.0, 8.0),
                                       radius=(1.0, 4.0))
    lat, lon = np.append(lat, draw(B, 0.2)), np.append(lon, draw(B, 0.2))
    for z in (0, 1):
        for y0 in (verts[z, :, 0].min(), verts[z, :, 0].max()):
            for y in (np.nextafter(y0, np.float32(-np.inf)), y0,
                      np.nextafter(y0, np.float32(np.inf))):
                lat = np.append(lat, y)
                lon = np.append(lon, verts[z, :, 1].mean(dtype=np.float32))
        lat = np.append(lat, verts[z, :, 0].mean(dtype=np.float32))
        lon = np.append(lon, verts[z, :, 1].mean(dtype=np.float32))
    return lat.astype(np.float32), lon.astype(np.float32), verts


def _world(name):
    if name == "adversarial":
        return adversarial_world()
    if name.startswith("random"):      # chip_smoke's worlds, small
        seed = int(name[-1])
        return random_world(seed, 300, 40, 9, box=(-5.0, 15.0),
                            radius=(0.5, 3.0 + 20 * (seed == 2)))
    return _mixed_world(int(name[len("mixed"):]))


WORLDS = ["random0", "random1", "random2", "adversarial"] + \
    [f"mixed{i}" for i in range(20)]


@pytest.mark.parametrize("world", WORLDS)
def test_rejected_pairs_have_no_straddle_and_are_outside(world):
    lat, lon, verts = _world(world)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (lat, lon, verts)]
    reject = zone_reject_mask(*args).numpy()
    inside = points_in_zones(*args).numpy()
    assert reject.shape == inside.shape == (lat.shape[0], verts.shape[0])
    straddle = _any_straddle(lat, verts)
    assert not (reject & straddle).any(), np.argwhere(reject & straddle)[:5]
    assert not (reject & inside).any(), np.argwhere(reject & inside)[:5]
    # the predicate does fire, and some kept pair is inside
    assert reject.any() and inside.any()
    ref = np.asarray(_jit_xla_pip(jnp.asarray(lat), jnp.asarray(lon),
                                  jnp.asarray(verts)))
    np.testing.assert_array_equal(inside, ref)


def test_reject_rules_for_nan_inf_and_signed_zero():
    """The cases the kernel's source note argues, one at a time."""
    nan, inf = np.nan, np.inf
    verts = np.array([
        [(0, 0), (4, 1), (2, 3)],            # plain, y in [0, 4]
        [(nan, 0), (4, 1), (2, 3)],          # NaN y: never rejected
        [(0, 0), (4, nan), (2, 3)],          # NaN x: never rejected
        [(-0.0, 0), (4, 1), (2, 3)],         # ymin is -0.0
        [(-inf, 0), (inf, 1), (2, 3)],       # infinite y-range
        [(3, 0), (3, 1), (3, 2)],            # flat: always rejected
    ], np.float32)
    lat = np.array([-1, 0, 0.0, 2, 4, np.nextafter(np.float32(4), 0), inf,
                    -inf, nan, 1e-45, -1e-45], np.float32)
    lon = np.zeros_like(lat)
    got = zone_reject_mask(*map(torch.from_numpy, (lat, lon, verts)))
    want = np.array([
        # plain   NaN y  NaN x  -0.0   inf    flat
        [True,  False, False, True,  False, True],   # -1
        [False, False, False, False, False, True],   # 0
        [False, False, False, False, False, True],   # +0.0
        [False, False, False, False, False, True],   # 2
        [True,  False, False, True,  False, True],   # 4 (= ymax)
        [False, False, False, False, False, True],   # 4 - ulp
        [True,  False, False, True,  True,  True],   # +inf
        [True,  False, False, True,  False, True],   # -inf
        [False, False, False, False, False, False],  # NaN
        [False, False, False, False, False, True],   # denormal: +0
        [False, False, False, False, False, True],   # denormal: -0
    ])
    np.testing.assert_array_equal(got.numpy(), want)
    inside = points_in_zones(*map(torch.from_numpy, (lat, lon, verts)))
    assert not (got & inside).any()


def test_bound_counts_the_pairs_in_range():
    """chip_smoke's bound: bytes 8B + 16VZ + BZ at 3.35 TB/s against
    2BZ + 8V*P_in operations at 67 TFLOP/s; the dense bound counts 8 ops
    for every edge test."""
    B, Z, V = 131072, 256, 16
    ms, by, dense = geofence_bound_ms(B, Z, V, p_in=0)
    assert by == "bytes"
    assert ms == pytest.approx((8 * B + 16 * V * Z + B * Z) / 3.35e12 * 1e3)
    assert dense == pytest.approx(8 * B * Z * V / 67e12 * 1e3)
    ms, by, _ = geofence_bound_ms(B, Z, V, p_in=B * Z)
    assert by == "operations"
    assert ms == pytest.approx((2 * B * Z + 8 * V * B * Z) / 67e12 * 1e3)
