"""The hand-written CUDA geofence kernel against its plain torch version, on
the card. Needs a CUDA device and nvcc: marked `cuda`, skipped elsewhere.
Run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_kernel.py`
(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
need not have).

Shapes include zone counts that force the kernel to walk its zones in
chunks (Z*V beyond its shared-memory budget: Z=2000 and Z=1001 at V=16,
Z=300 at V=40, Z=70 at V=330), rows not aligned to 16 bytes (odd Z), V
of 17 to 32 (V=20, V=32: 32 vertex y's in registers, not 16), V=40 (two
straddle-mask chunks from shared memory), V=330, the largest V staged in
shared memory, and V=331 and V=512, zones too large for it, read from
global memory (in chunks at Z=2000), zones without vertices, zones as wide
as the points' box (y-rejection almost never fires) and zones with NaN and
infinite vertices.

The arithmetic the kernel must reproduce is held against the JAX package on
the CPU by tests/test_torch_ops.py (plain version == XLA scan == Pallas
interpret); here the kernel must be bit-equal to the plain version on the
same CUDA tensors.
"""

import numpy as np
import pytest
import torch

from chip_smoke import WIDE_RADIUS, adversarial_world, random_world
from sitewhere_tpu_torch.ops.geofence import points_in_zones
from sitewhere_tpu_torch.ops.geofence_kernel import (
    launch_plan, points_in_zones_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _both(lat, lon, verts, dev):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (lat, lon, verts)]
    before = points_in_zones_kernel.launches
    got = points_in_zones_kernel(*args)
    torch.cuda.synchronize()
    assert points_in_zones_kernel.launches == before + 1
    return points_in_zones(*args).cpu().numpy(), got.cpu().numpy()


@pytest.mark.parametrize("shape", [(97, 5, 7), (3, 1, 4), (1000, 33, 40),
                                   (4099, 130, 16), (500, 50, 20),
                                   (2053, 300, 40), (4099, 2000, 16),
                                   (1031, 1001, 16), (3001, 256, 32),
                                   (2053, 70, 330), (1031, 40, 331),
                                   (4099, 300, 512), (1031, 2000, 331)])
def test_kernel_matches_plain_random(cuda, shape):
    B, Z, V = shape
    ref, got = _both(*random_world(B + Z + V, B, Z, V), cuda)
    assert got.dtype == np.bool_ and got.shape == (B, Z)
    np.testing.assert_array_equal(got, ref)


def test_kernel_matches_plain_wide_zones(cuda):
    lat, lon, verts = random_world(7, 4099, 256, 16, box=(-5.0, 15.0),
                                   radius=WIDE_RADIUS)
    ref, got = _both(lat, lon, verts, cuda)
    np.testing.assert_array_equal(got, ref)
    assert ref.mean() > 0.5


def test_kernel_matches_plain_nan_and_inf_vertices(cuda):
    lat, lon, verts = random_world(8, 2999, 200, 16, box=(-5.0, 15.0),
                                   radius=(0.5, 6.0))
    z = np.arange(200)
    verts[z % 5 == 0, 1, 0] = np.nan        # a NaN y vertex
    verts[z % 5 == 1, 2, 1] = np.nan        # a NaN x vertex
    verts[z % 5 == 2, 0, 0] = np.inf        # a +inf y vertex
    verts[z % 5 == 3, 3, 1] = -np.inf       # a -inf x vertex
    lat[::97], lon[1::89] = np.nan, np.nan
    ref, got = _both(lat, lon, verts, cuda)
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


def test_kernel_matches_plain_zero_vertices(cuda):
    rng = np.random.default_rng(9)
    lat, lon = rng.normal(size=(2, 70)).astype(np.float32)
    ref, got = _both(lat, lon, np.zeros((3, 0, 2), np.float32), cuda)
    assert got.shape == (70, 3) and not got.any()
    np.testing.assert_array_equal(got, ref)


def test_kernel_matches_plain_adversarial(cuda):
    ref, got = _both(*adversarial_world(), cuda)
    np.testing.assert_array_equal(got, ref)


def test_launch_plan_chunks_large_zone_tables(cuda):
    """The chunked shapes above do walk their zones in chunks, the large-V
    shapes take the zone table path they are there for, and the main
    path's table fits one chunk."""
    def plan(B, Z, V):
        return launch_plan(B, Z, V, cuda.index or 0)
    assert plan(4099, 2000, 16)["zones_per_chunk"] < 2000
    assert plan(2053, 300, 40)["zones_per_chunk"] < 300
    assert plan(2053, 70, 330)["zones_per_chunk"] < 70
    assert plan(2053, 70, 330)["zone_table"] == "shared"
    assert plan(2053, 300, 40)["zone_table"] == "shared"
    assert plan(3001, 256, 32)["zone_table"] == "registers"
    for B, Z, V in ((1031, 40, 331), (4099, 300, 512)):
        assert plan(B, Z, V)["zone_table"] == "global"
    assert plan(1031, 2000, 331)["zones_per_chunk"] < 2000
    main = plan(131072, 256, 16)
    assert main["zone_table"] == "registers"
    assert main["zones_per_chunk"] >= 256 and main["blocks_per_sm"] >= 1
    assert main["grid"] >= 1


def test_kernel_rejects_bad_inputs(cuda):
    lat = torch.zeros(4, device=cuda)
    verts = torch.zeros((2, 3, 2), device=cuda)
    with pytest.raises(TypeError):
        points_in_zones_kernel(lat.double(), lat.double(), verts)
    with pytest.raises(ValueError):
        points_in_zones_kernel(lat, lat, verts[:, :, :1])
    with pytest.raises(ValueError):
        points_in_zones_kernel(lat, lat.cpu(), verts)
