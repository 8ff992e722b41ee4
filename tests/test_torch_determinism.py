"""The port's CPU anomaly scores do not depend on the process or on torch's
thread count.

torch.tanh and torch.exp on the CPU gave other last bits in about one
process in five or ten, on the same input at the same thread count (found
in chip_smoke's stateful world at 3000 devices, B=2048, first step: ~70 of
2048 scores, up to 4.9e-4 apart). `eval_anomaly_models` now takes tanh and
exp on the CPU from ops/numerics.py (`tanh_f32`, `exp_f32`: IEEE basic
operations in f64, rounded once). Pinned two ways:
  - that input, cut to test size (1000 devices, 16 zones, B=512, the first
    batch of seed SEED+500), runs in fresh processes at 1 and 8 threads:
    the scores and every state group carry the same bits;
  - the stage runs with torch.tanh / torch.exp made to raise on the CPU,
    and `tanh_f32` / `exp_f32` are the correctly rounded functions on a
    seeded sweep (f64 reference, rounded once).
The score tolerance tests against the JAX package stay as they are.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sitewhere_tpu_torch.ops.numerics import exp_f32, tanh_f32

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import hashlib, sys
import torch
torch.set_num_threads(int(sys.argv[1]))
import chip_smoke as cs
eng = cs.build_stateful_world(torch.device("cpu"), 1_700_000_000_000,
                              max_devices=1024, n_registered=1000,
                              n_zones=16, batch=512)
batch = cs.synthetic_batch(eng.packer, 1000, 512, cs.SEED + 500,
                           mm_slots=(1, 2))
out = eng.submit(batch)
digest = hashlib.sha256(out.model_score.numpy().tobytes())
for group in (eng.canonical_model_state(), eng.canonical_rule_state()):
    for name in group.__dataclass_fields__:
        digest.update(getattr(group, name).numpy().tobytes())
print(int((out.model_score != 0).sum()), digest.hexdigest())
"""


def _scores_in_a_fresh_process(threads):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "OMP_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE, str(threads)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    scored, digest = out.stdout.split()
    return int(scored), digest


def test_scores_carry_the_same_bits_in_every_process_and_thread_count():
    runs = [_scores_in_a_fresh_process(n) for n in (1, 8, 8)]
    assert runs[0][0] > 0                       # the models scored rows
    assert runs[1] == runs[0] and runs[2] == runs[0]


def test_the_stage_takes_no_library_tanh_or_exp_on_the_cpu(monkeypatch):
    import chip_smoke as cs

    eng = cs.build_stateful_world(torch.device("cpu"), 1_700_000_000_000,
                                  max_devices=256, n_registered=200,
                                  n_zones=8, batch=128)
    batch = cs.synthetic_batch(eng.packer, 200, 128, cs.SEED + 500,
                               mm_slots=(1, 2))

    def refuse(*args, **kwargs):
        raise AssertionError("library tanh/exp reached on the CPU")

    monkeypatch.setattr(torch, "tanh", refuse)
    monkeypatch.setattr(torch, "exp", refuse)
    out = eng.submit(batch)
    assert bool((out.model_score != 0).any())


def test_tanh_and_exp_are_correctly_rounded():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.standard_normal(100_000) * 4, rng.standard_normal(2000) * 1e-5,
        rng.uniform(-110, 100, 2000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 20.0, -20.0,
         88.72, 88.73, -103.9, -87.3]]).astype(np.float32)
    t = torch.from_numpy(x)
    with np.errstate(over="ignore"):
        for fn, ref in ((tanh_f32, np.tanh), (exp_f32, np.exp)):
            want = ref(x.astype(np.float64)).astype(np.float32)
            got = fn(t).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), fn.__name__)
