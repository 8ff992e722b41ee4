"""The hand-written CUDA geofence kernel against its plain torch version, on
the card. Needs a CUDA device and nvcc: marked `cuda`, skipped elsewhere.
Run on the card with `python -m pytest -m cuda tests/test_torch_kernel.py`.

The arithmetic the kernel must reproduce is held against the JAX package on
the CPU by tests/test_torch_ops.py (plain version == XLA scan == Pallas
interpret); here the kernel must be bit-equal to the plain version on the
same CUDA tensors.
"""

import numpy as np
import pytest
import torch

from chip_smoke import adversarial_world, random_world
from sitewhere_tpu_torch.ops.geofence import points_in_zones
from sitewhere_tpu_torch.ops.geofence_kernel import points_in_zones_kernel

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
                                   (4099, 130, 16)])
def test_kernel_matches_plain_random(cuda, shape):
    B, Z, V = shape
    ref, got = _both(*random_world(B + Z + V, B, Z, V), cuda)
    assert got.dtype == np.bool_ and got.shape == (B, Z)
    np.testing.assert_array_equal(got, ref)


def test_kernel_matches_plain_adversarial(cuda):
    ref, got = _both(*adversarial_world(), cuda)
    np.testing.assert_array_equal(got, ref)


def test_kernel_rejects_bad_inputs(cuda):
    lat = torch.zeros(4, device=cuda)
    verts = torch.zeros((2, 3, 2), device=cuda)
    with pytest.raises(TypeError):
        points_in_zones_kernel(lat.double(), lat.double(), verts)
    with pytest.raises(ValueError):
        points_in_zones_kernel(lat, lat, verts[:, :, :1])
    with pytest.raises(ValueError):
        points_in_zones_kernel(lat, lat.cpu(), verts)
