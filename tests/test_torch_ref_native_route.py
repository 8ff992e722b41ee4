"""The route cases of the reference's tests/test_native.py
(TestNativePackUnpack), run on the port's native host library.

DIVERGES (the port's behaviour, asserted instead):
  TestNativePackUnpack.test_pack_unpack_parity,
  TestNativePackUnpack.test_routed_unpack_parity: the reference switches
    its native library off (`native.available`) to reach its numpy
    pack / unpack; the port's library is never optional, so the native
    route's routed blob is held to the plain versions instead (the numpy
    router `route_blob_plain`, and `blob_to_batch` on a CPU tensor shard
    by shard) and to the JAX package's unpack of the same blob. The flat
    pack's parity is tests/test_torch_native.py's.
"""

import numpy as np
import torch

from test_torch_scenarios import load_reference

DIVERGES = {"TestNativePackUnpack.test_pack_unpack_parity",
            "TestNativePackUnpack.test_routed_unpack_parity"}

REFERENCE_TESTS = load_reference(
    globals(), "test_native",
    # the port's native library is never optional: nothing to skip on
    replacements=[('reason=f"native lib: {nat.build_error()}")',
                   'reason="")'),
                  ("pytest.mark.skipif(not nat.available(),",
                   "pytest.mark.skipif(False,")],
    only={"TestNativePackUnpack"}, diverges=DIVERGES)

FIELDS = ("device_idx", "event_type", "ts", "mm_idx", "value", "lat", "lon",
          "elevation", "alert_type_idx", "alert_level", "valid")


def test_every_reference_test_runs():
    assert len(REFERENCE_TESTS) == 3


def test_routed_unpack_parity():
    from sitewhere_tpu.ops.pack import blob_to_batch_np as j_unpack
    from sitewhere_tpu_torch.ops.pack import (
        batch_to_blob, blob_to_batch, blob_to_batch_np)
    from sitewhere_tpu_torch.parallel.router import ShardRouter

    b = TestNativePackUnpack()._batch(n=500, seed=5)
    b = b.replace(device_idx=(np.asarray(b.device_idx) % 64))
    router = ShardRouter(n_shards=4, per_shard_batch=160)
    routed, over = router.route_blob(batch_to_blob(b))
    plain, plain_over = router.route_blob_plain(batch_to_blob(b))
    np.testing.assert_array_equal(routed, plain)
    np.testing.assert_array_equal(over, plain_over)
    nat = blob_to_batch_np(routed)
    ref = j_unpack(routed)
    shards = [blob_to_batch(torch.from_numpy(routed[s]))
              for s in range(routed.shape[0])]
    for name in FIELDS:
        got = np.asarray(getattr(nat, name))
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got, np.stack([getattr(s, name).numpy() for s in shards]),
            err_msg=name)
