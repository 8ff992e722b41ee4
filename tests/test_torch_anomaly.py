"""The port's anomaly-model stage held against the JAX package's, on the CPU.

MLP and autoencoder models over value, EWMA and rate features run through
the jitted JAX `eval_anomaly_models` and the port's over several steps of
seeded inputs (NaN and denormal readings included), with an epoch reset:
every slab lane, the generation, the counters and the fire outputs must be
bit-equal; scores agree within the reference's own tolerance (rtol=1e-4,
atol=1e-5, tests/test_anomaly_models.py), since `tanh` and `exp` differ in
the last bits between libraries.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ml import compiler as jcomp
from sitewhere_tpu.ops import anomaly as janomaly
from sitewhere_tpu_torch.ml import compiler as tcomp
from sitewhere_tpu_torch.ops import anomaly as tanomaly
from sitewhere_tpu_torch.ops import segments as tseg
from sitewhere_tpu_torch.ops import stateful as tstateful
from sitewhere_tpu_torch.tree import to_device

from test_torch_stateful import bits_equal, make_batch, step_inputs

B, D, M = 256, 48, 4
P, F, L, H = 8, 4, 2, 8
RTOL, ATOL = 1e-4, 1e-5
MEASUREMENTS = {"temp": 1, "hum": 2, "m3": 3}

# the reference's fixture models (tests/test_anomaly_models.py) plus
# multi-layer models over every feature kind
MODELS = [
    {"token": "m-hot", "kind": "mlp", "threshold": 0.5,
     "alert_level": "WARNING", "alert_type": "anomaly.hot",
     "features": [{"feature": "value", "measurement": "temp",
                   "mean": 50.0, "std": 10.0}],
     "layers": [{"weights": [[1.0]], "bias": [0.0]}],
     "output": {"weights": [10.0], "bias": 0.0}},
    {"token": "m-ewma", "kind": "mlp", "threshold": 0.6,
     "alert_level": "ERROR", "alert_type": "anomaly.ewma",
     "features": [{"feature": "ewma", "measurement": "temp",
                   "alpha": 0.5, "mean": 60.0, "std": 20.0}],
     "layers": [{"weights": [[2.0]], "bias": [0.5]}],
     "output": {"weights": [3.0], "bias": -0.5}},
    {"token": "m-rate", "kind": "autoencoder", "threshold": 0.5,
     "alert_level": "CRITICAL", "alert_type": "anomaly.rate",
     "features": [{"feature": "rate", "measurement": "temp",
                   "mean": 0.0, "std": 10.0}],
     "layers": [{"weights": [[0.5]], "bias": [0.0]}]},
    {"token": "m-2feat", "kind": "mlp", "threshold": 0.55,
     "alert_level": "INFO", "alert_type": "anomaly.two",
     "device_type_token": "t",
     "features": [{"feature": "value", "measurement": "temp",
                   "mean": 50.0, "std": 20.0},
                  {"feature": "ewma", "measurement": "hum",
                   "alpha": 0.3, "mean": 30.0, "std": 20.0}],
     "layers": [{"weights": [[0.6, -0.4], [0.3, 0.8]],
                 "bias": [0.1, -0.2]}],
     "output": {"weights": [1.5, -1.0], "bias": 0.2}},
    {"token": "ae-value-rate", "kind": "autoencoder", "threshold": 0.8,
     "alert_level": "WARNING",
     "features": [{"feature": "value", "measurement": "hum",
                   "mean": 50.0, "std": 30.0},
                  {"feature": "rate", "measurement": "hum",
                   "mean": 0.0, "std": 40.0}],
     "layers": [{"weights": [[0.7, 0.2], [-0.3, 0.9], [0.5, 0.5]],
                 "bias": [0.0, 0.1, -0.1]},
                {"weights": [[0.9, -0.2, 0.3], [0.1, 0.8, -0.4]],
                 "bias": [0.05, -0.05]}]},
    {"token": "mlp-3feat", "kind": "mlp", "threshold": 0.7,
     "alert_level": "CRITICAL", "tenant_token": "t1",
     "features": [{"feature": "value", "measurement": "m3",
                   "mean": 50.0, "std": 25.0},
                  {"feature": "ewma", "measurement": "temp", "alpha": 0.2,
                   "mean": 50.0, "std": 25.0},
                  {"feature": "rate", "measurement": "temp",
                   "mean": 0.0, "std": 50.0}],
     "layers": [{"weights": [[1.2, -0.5, 0.3], [0.4, 0.9, -1.1],
                             [-0.7, 0.2, 0.6], [0.3, 0.3, 0.3]],
                 "bias": [0.1, 0.0, -0.1, 0.2]},
                {"weights": [[1.0, -1.0, 0.5, 0.2],
                             [0.3, 0.6, -0.2, 0.9]],
                 "bias": [0.0, 0.1]}],
     "output": {"weights": [2.5, -1.5], "bias": 0.3}},
]


def compile_tables(comp, epochs):
    table = comp.empty_model_table(P, F, L, H)
    for slot, (spec, epoch) in enumerate(zip(MODELS, epochs)):
        comp.compile_model_into(
            table, slot, dict(spec), epoch,
            intern_measurement=MEASUREMENTS.__getitem__,
            intern_alert_type=lambda name: len(name),
            lookup_tenant=lambda t: {"t1": 1, "t2": 2}.get(t, 0),
            lookup_device_type=lambda t: {"t": 2}.get(t, 0),
            measurement_slots=M)
    return table


def both_tables(epochs):
    jt, tt = compile_tables(jcomp, epochs), compile_tables(tcomp, epochs)
    for f in dataclasses.fields(jt):
        bits_equal(getattr(jt, f.name), getattr(tt, f.name), f.name)
    return jax.tree_util.tree_map(jnp.asarray, jt), to_device(tt, "cpu")


STEPS = 6


def epochs_at(step):
    """Models 1 and 4 are re-installed (epoch bump) at step 3."""
    base = list(range(1, len(MODELS) + 1))
    return [e + 50 if i in (1, 4) and step >= 3 else e
            for i, e in enumerate(base)]


def trace_inputs(seed=77):
    """Per step: (device rows of the NaN readings, the eval keywords over
    the device-sorted batch)."""
    rng = np.random.default_rng(seed)
    for step in range(STEPS):
        cols = make_batch(rng, step)
        lm, lmts, tenant, dtype = step_inputs(rng, step, cols)
        tb = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in cols.items()})
        obs_mm, _, _, attach = tstateful.observations_of_batch(tb, M, D)
        order, _ = tseg.batch_device_order(tb.device_idx)
        sdev = tb.device_idx[order]
        idx = sdev.long()
        yield np.isnan(lm).any(axis=1)[idx.numpy()], {
            "dev": sdev, "attach": attach[order], "obs_row": obs_mm[idx],
            "lm_row": torch.from_numpy(lm)[idx],
            "lmts_row": torch.from_numpy(lmts)[idx],
            "tenant_row": torch.from_numpy(tenant)[idx],
            "dtype_row": torch.from_numpy(dtype)[idx]}


def test_eval_anomaly_models_bit_equal_with_epoch_reset():
    jitted_eval = jax.jit(janomaly.eval_anomaly_models)
    jstate = janomaly.init_model_state(D, P, F)
    tstate = tanomaly.init_model_state(D, P, F, device="cpu")
    n_fired = n_scored = n_nan = 0
    for step, (nan_rows, kw) in enumerate(trace_inputs()):
        jt, tt = both_tables(epochs_at(step))
        jstate, jout = jitted_eval(
            jt, jstate, **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
        tstate, tout = tanomaly.eval_anomaly_models(tt, tstate, **kw)
        for name in ("slab", "gen", "fire_count", "eval_count"):
            bits_equal(getattr(jstate, name), getattr(tstate, name),
                       f"step {step} {name}")
        for name in ("fired", "first_model", "alert_level"):
            bits_equal(jout[name], tout[name], f"step {step} {name}")
        np.testing.assert_allclose(tout["score"].numpy(),
                                   np.asarray(jout["score"]),
                                   rtol=RTOL, atol=ATOL)
        n_fired += int(tout["fired"].sum())
        n_scored += int((tout["score"] != 0).sum())
        n_nan += int((nan_rows & kw["attach"].numpy()).sum())
    assert n_fired > 0 and n_scored > 0 and n_nan > 0
    gen = tstate.slab[:, :, 4 * F + 1]
    assert (gen[:, 1] == 52).any() and (gen[:, 0] == 1).any()


@pytest.mark.parametrize("model", range(len(MODELS)))
def test_trace_scores_clear_of_thresholds(model):
    """Each model alone over the same trace (its state and scores are the
    same as beside the others): every score it gives sits farther from its
    threshold than the score tolerance, so the bit-equal fires above do not
    hinge on the last bits of tanh and exp. The one exception is a score
    exactly AT the threshold: m-hot's sigmoid(0) = 0.5 for a reading of
    exactly 50.0, which every library computes exactly (exp(0) = 1)."""
    state = tanomaly.init_model_state(D, P, F, device="cpu")
    gaps = []
    for step, (_, kw) in enumerate(trace_inputs()):
        _, tt = both_tables(epochs_at(step))
        tt.active[torch.arange(P) != model] = False
        state, out = tanomaly.eval_anomaly_models(tt, state, **kw)
        score = out["score"][out["score"] != 0]
        exact = (score == 0.5) & (model == 0)
        gaps.append(torch.where(
            exact, 1.0, (score - tt.threshold[model]).abs()
            - (ATOL + RTOL * score.abs())))
    gaps = torch.cat(gaps)
    assert gaps.numel() > 0 and bool((gaps > 0).all())
