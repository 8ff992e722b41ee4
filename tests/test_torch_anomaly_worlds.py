"""The port's anomaly stage on adversarial worlds, against the jitted JAX
`eval_anomaly_models` on the CPU.

Seeded worlds carry NaN payloads (quiet and signalling, both signs, in
both operand orders of every f32 op of the feature advance), ±0.0, ±inf,
denormals, and planted operands whose EWMA decay product, rate quotient
or feature scaling is exactly a value in [FLT_MIN(1 - 2^-24),
FLT_MIN(1 - 2^-25)): XLA's CPU code flushes such a result to a signed
zero (tininess after rounding), while rounding with gradual underflow
gives FLT_MIN. Each world runs a few steps with the state carried. Every
slab lane, the generation, the counters and the fire outputs must be
bit-equal; scores keep the reference's tolerance (rtol=1e-4, atol=1e-5).
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ml import compiler as jcomp
from sitewhere_tpu.ops import anomaly as janomaly
from sitewhere_tpu_torch.ml import compiler as tcomp
from sitewhere_tpu_torch.ops import anomaly as tanomaly
from sitewhere_tpu_torch.tree import to_device

from test_torch_stateful import bits_equal

D = B = 64
P, F, L, H, M = 4, 3, 2, 4, 4
STEPS = 4
RTOL, ATOL = 1e-4, 1e-5
NEG = -(2 ** 31)
FLT_MIN = Fraction(2) ** -126
# exact results here are flushed by XLA's CPU code, kept as FLT_MIN by
# rounding with gradual underflow
TRAP_LO = FLT_MIN * (1 - Fraction(2) ** -24)
TRAP_HI = FLT_MIN * (1 - Fraction(2) ** -25)

QNAN_POS, QNAN_NEG = 0x7FC00005, 0xFFC00002
SNAN_POS, SNAN_NEG = 0x7F800001, 0xFF800007
# 2^-125 (1 - 2^-24): half of it is exactly FLT_MIN (1 - 2^-24)
BELOW_2FLT_MIN = 0x00FFFFFF
SPECIALS = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001,
            0x807FFFFF, 0x00800000, 0x80800000, QNAN_POS, QNAN_NEG,
            SNAN_POS, SNAN_NEG, BELOW_2FLT_MIN]


def f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


def _in_trap(exact):
    return TRAP_LO <= abs(exact) < TRAP_HI


def _rate_trap():
    """(diff, dt): diff * 1000 rounds to a normal X whose quotient X / dt is
    exactly in the trap window."""
    for dt in range(2, 4096):
        target = (TRAP_LO + TRAP_HI) / 2 * dt
        x0 = np.float32(float(target))
        for x in (x0, np.nextafter(x0, np.float32(0)),
                  np.nextafter(x0, np.float32(1))):
            if not _in_trap(Fraction(float(x)) / dt):
                continue
            d0 = np.float32(float(Fraction(float(x)) / 1000))
            for d in (d0, np.nextafter(d0, np.float32(0)),
                      np.nextafter(d0, np.float32(1))):
                if np.float32(d * np.float32(1000.0)) == x:
                    return d, dt
    raise AssertionError("no rate trap found")


RATE_DIFF, RATE_DT = _rate_trap()

# every model reads three features; model 0's constants are planted
# (value, ewma alpha 0.5, rate; mean 0, scale 0.5 on each), the others'
# come from the adversarial constant pools
SPECS = [
    {"token": f"m{p}", "kind": "mlp" if p % 2 == 0 else "autoencoder",
     "threshold": 0.5 + 0.05 * p, "alert_level": "WARNING",
     "features": [{"feature": kind, "measurement": f"s{1 + (p + f) % 3}",
                   "alpha": 0.5, "mean": 0.0, "std": 2.0}
                  for f, kind in enumerate(("value", "ewma", "rate"))],
     "layers": [{"weights": [[0.9, -0.4, 0.3], [0.2, 0.7, -0.5],
                             [0.6, 0.1, 0.8]], "bias": [0.1, -0.2, 0.05]},
                {"weights": [[1.0, -0.6, 0.4], [-0.3, 0.5, 0.9],
                             [0.2, -0.8, 0.6]], "bias": [0.0, 0.1, -0.1]}],
     "output": {"weights": [2.0, -1.5, 1.0], "bias": 0.25}}
    for p in range(P)]
SLOTS = {"s1": 1, "s2": 2, "s3": 3}
ALPHAS = [0.5, 0.25, 0.999999940395, 1.0, 0.0, -0.0] + [
    float(f32(b)) for b in (0x00000001, 0x00800000, QNAN_POS, SNAN_NEG)]
MEANS = [0.0, -0.0, 1.0, -3.5, np.inf] + [
    float(f32(b)) for b in (0x00000003, 0x80800000, QNAN_NEG, SNAN_POS)]
SCALES = [0.5, 2.0, 1.0, 0.0, -0.0, 1e30, np.inf] + [
    float(f32(b)) for b in (0x00000002, 0x3F7FFFFF, SNAN_NEG)]


def make_table(comp, rng):
    table = comp.empty_model_table(P, F, L, H)
    for slot, spec in enumerate(SPECS):
        comp.compile_model_into(
            table, slot, dict(spec), slot + 1,
            intern_measurement=SLOTS.__getitem__,
            intern_alert_type=lambda name: 1,
            lookup_tenant=lambda t: 0, lookup_device_type=lambda t: 0,
            measurement_slots=M)
    for name, pool in (("feat_alpha", ALPHAS), ("feat_mean", MEANS),
                       ("feat_scale", SCALES)):
        col = getattr(table, name)
        col[1:] = np.asarray(pool, np.float32)[
            rng.integers(0, len(pool), col[1:].shape)]
    return table


def world(seed):
    """The initial slab and STEPS steps of per-row inputs. Rows are devices
    0..B-1 (one row each; a few rows are not attach rows). Recipes by
    device d % 8 plant, on model 0: 0 the EWMA decay trap, 1 the rate
    quotient trap, 2 the scaling trap, 3 / 4 a quiet and a signalling NaN
    as the difference's operands in both orders; 5-7 draw every lane from
    the special values and normal numbers."""
    rng = np.random.default_rng(seed)
    slab = np.zeros((D, P, 4 * F + 2), np.int32)
    slab[:, :, 2 * F:3 * F] = NEG
    value = np.where(rng.random((D, P, F)) < 0.5,
                     rng.choice(SPECIALS, (D, P, F)),
                     f32(0).view(np.uint32)).astype(np.uint32)
    normal = rng.normal(0, 4, (D, P, F)).astype(np.float32).view(np.uint32)
    value = np.where(rng.random((D, P, F)) < 0.3, normal, value)
    slab[:, :, 0:F] = value.view(np.int32)
    slab[:, :, F:2 * F] = rng.choice(SPECIALS, (D, P, F)).astype(
        np.uint32).view(np.int32)
    slab[:, :, 2 * F:3 * F] = rng.integers(-5000, 0, (D, P, F))
    slab[:, :, 3 * F:4 * F] = rng.integers(0, 3, (D, P, F))
    slab[:, :, 4 * F] = rng.integers(0, 2, (D, P))
    slab[:, :, 4 * F + 1] = np.arange(1, P + 1)[None, :]
    slab[::9, 1, 4 * F + 1] = 0             # stale rows read as fresh
    steps = []
    for step in range(STEPS):
        t0 = 1000 * step
        lm = rng.normal(0, 4, (B, M)).astype(np.float32)
        special = rng.random((B, M)) < 0.5
        lm[special] = f32(rng.choice(SPECIALS, special.sum()))
        lmts = (t0 + rng.integers(0, 50, (B, M))).astype(np.int32)
        lmts[rng.random((B, M)) < 0.1] = NEG
        obs = rng.random((B, M)) < 0.85
        attach = rng.random(B) < 0.9
        steps.append({"lm": lm, "lmts": lmts, "obs": obs, "attach": attach})
    # model 0: feature 0 (value) reads slot 1, 1 (ewma) slot 2, 2 (rate) slot 3
    first = steps[0]
    for d in range(B):
        recipe = d % 8
        if recipe not in (0, 1, 2, 3, 4):
            continue
        first["attach"][d] = True
        first["obs"][d, 1:4] = True
        first["lmts"][d, 1:4] = 7
        slab[d, 0, 4 * F + 1] = 1
        slab[d, 0, 3 * F:4 * F] = 1
        if recipe == 0:       # (1 - 0.5) * sv == FLT_MIN (1 - 2^-24)
            slab[d, 0, 1] = BELOW_2FLT_MIN
            first["lm"][d, 2] = f32(0x80000000 if d % 16 else 0)
        elif recipe == 1:     # diff * 1000 / dt in the trap
            slab[d, 0, 2] = 0
            slab[d, 0, 2 * F + 2] = first["lmts"][d, 3] - RATE_DT
            first["lm"][d, 3] = -RATE_DIFF if d % 16 else RATE_DIFF
        elif recipe == 2:     # (x - 0) * 0.5 in the trap
            first["lm"][d, 1] = f32(BELOW_2FLT_MIN)
        else:                 # NaN operands of v - sv, both orders
            qn, sn = (QNAN_NEG, SNAN_POS) if d % 16 < 8 else (QNAN_POS,
                                                              SNAN_NEG)
            v, sv = (qn, sn) if recipe == 3 else (sn, qn)
            first["lm"][d, 3] = f32(v)
            slab[d, 0, 2] = np.uint32(sv).view(np.int32)
            first["lm"][d, 2] = f32(v)
            slab[d, 0, 1] = np.uint32(sv).view(np.int32)
    return slab, steps


def _jax_state(slab):
    z = np.zeros(P, np.int32)
    return janomaly.ModelStateTensors(
        slab=jnp.asarray(slab), gen=jnp.asarray(np.arange(1, P + 1,
                                                          dtype=np.int32)),
        fire_count=jnp.asarray(z), eval_count=jnp.asarray(z))


def _port_state(slab):
    z = torch.zeros(P, dtype=torch.int32)
    return tanomaly.ModelStateTensors(
        slab=torch.from_numpy(slab.copy()),
        gen=torch.arange(1, P + 1, dtype=torch.int32),
        fire_count=z, eval_count=z.clone())


def _kw(s):
    return {"dev": np.arange(B, dtype=np.int32), "attach": s["attach"],
            "obs_row": s["obs"], "lm_row": s["lm"], "lmts_row": s["lmts"],
            "tenant_row": np.ones(B, np.int32),
            "dtype_row": np.ones(B, np.int32)}


WORLDS = [11, 12, 13]


@pytest.fixture(scope="module")
def jitted_eval():
    return jax.jit(janomaly.eval_anomaly_models)


def _run(seed, jitted_eval):
    rng = np.random.default_rng(seed + 1000)
    jt_np = make_table(jcomp, rng)
    tt_np = make_table(tcomp, np.random.default_rng(seed + 1000))
    for f in dataclasses.fields(jt_np):
        bits_equal(getattr(jt_np, f.name), getattr(tt_np, f.name), f.name)
    jt = jax.tree_util.tree_map(jnp.asarray, jt_np)
    tt = to_device(tt_np, "cpu")
    slab, steps = world(seed)
    jstate, tstate = _jax_state(slab), _port_state(slab)
    trace = []
    for step, s in enumerate(steps):
        kw = _kw(s)
        jstate, jout = jitted_eval(
            jt, jstate, **{k: jnp.asarray(v) for k, v in kw.items()})
        tstate, tout = tanomaly.eval_anomaly_models(
            tt, tstate, **{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in kw.items()})
        # the port's slab advances in place: keep this step's copy
        trace.append((step, jstate, jout, dataclasses.replace(
            tstate, slab=tstate.slab.clone()), tout))
    return tt_np, slab, steps, trace


@pytest.mark.parametrize("seed", WORLDS)
def test_adversarial_worlds_bit_equal_to_jitted_jax(seed, jitted_eval):
    _, _, _, trace = _run(seed, jitted_eval)
    for step, jstate, jout, tstate, tout in trace:
        for name in ("slab", "gen", "fire_count", "eval_count"):
            bits_equal(getattr(jstate, name), getattr(tstate, name),
                       f"step {step} {name}")
        for name in ("fired", "first_model", "alert_level"):
            bits_equal(jout[name], tout[name], f"step {step} {name}")
        np.testing.assert_allclose(tout["score"].numpy(),
                                   np.asarray(jout["score"]),
                                   rtol=RTOL, atol=ATOL)


def test_worlds_plant_every_trap(jitted_eval):
    """The worlds reach what they are for, counted on the inputs of their
    first step: the three trap windows, NaN operand pairs in both orders,
    and across the run fires, scored ticks and NaN features."""
    hits = dict.fromkeys(("decay", "rate", "scale", "qnan_first",
                          "snan_first", "nan_alpha_and_v", "fired",
                          "scored"), 0)
    for seed in WORLDS:
        tt, slab, steps, trace = _run(seed, jitted_eval)
        lm, obs = steps[0]["lm"], steps[0]["obs"]
        for d in range(B):
            sv = slab[d, 0, :F].view(np.float32)
            if obs[d, 2] and slab[d, 0, 3 * F + 1] > 0 and np.isfinite(sv[1]):
                hits["decay"] += _in_trap(
                    (1 - Fraction(float(tt.feat_alpha[0, 1])))
                    * Fraction(float(sv[1])))
            dt = int(steps[0]["lmts"][d, 3]) - int(slab[d, 0, 2 * F + 2])
            if np.isfinite(lm[d, 3]) and np.isfinite(sv[2]) and dt > 0:
                x = np.float32(np.float32(lm[d, 3] - sv[2])
                               * np.float32(1000.0))
                hits["rate"] += bool(np.isfinite(x)) and _in_trap(
                    Fraction(float(x)) / dt)
            if np.isfinite(lm[d, 1]):
                hits["scale"] += _in_trap(Fraction(float(lm[d, 1]))
                                          * Fraction(float(
                                              tt.feat_scale[0, 0])))
            vb = np.float32(lm[d, 3]).view(np.uint32)
            sb = sv[2].view(np.uint32)
            if np.isnan(lm[d, 3]) and np.isnan(sv[2]):
                quiet_v = bool(vb & 0x00400000)
                hits["qnan_first" if quiet_v else "snan_first"] += \
                    bool(sb & 0x00400000) != quiet_v
        for p in range(1, P):       # the EWMA's fma with two NaN operands
            m = 1 + (p + 1) % 3
            if np.isnan(tt.feat_alpha[p, 1]):
                hits["nan_alpha_and_v"] += int(
                    (np.isnan(lm[:, m]) & obs[:, m]).sum())
        for _, _, _, tstate, tout in trace:
            hits["fired"] += int(tout["fired"].sum())
            hits["scored"] += int((tout["score"] != 0).sum())
    assert all(hits.values()), hits


def test_rate_trap_is_a_trap():
    """The planted rate operands: diff * 1000 is a normal f32 whose exact
    quotient by dt lies in the window where XLA flushes."""
    x = np.float32(RATE_DIFF * np.float32(1000.0))
    assert abs(float(x)) >= 2.0 ** -126
    assert _in_trap(Fraction(float(x)) / RATE_DT)
