"""The port's rule-program stage held against the JAX package's, on the CPU.

Seeded numpy inputs go through the jitted JAX functions and the port's:
  - `fma_f32` against XLA's jitted `a*b + c` (which its CPU backend
    contracts into a fused multiply-add), specials and denormals included;
  - `eval_rule_programs` over several steps with programs that use every
    ProgramOp, with an epoch bump: slab bits, generation, counters and the
    per-row outputs must be equal;
  - `observations_of_batch` and `batch_device_order`.
Tolerance: none (f32 compared as int32 bit patterns).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import segments as jseg
from sitewhere_tpu.ops import stateful as jstateful
from sitewhere_tpu.rules import compiler as jcomp
from sitewhere_tpu_torch.ops import segments as tseg
from sitewhere_tpu_torch.ops import stateful as tstateful
from sitewhere_tpu_torch.ops.numerics import flush_denormals, fma_f32
from sitewhere_tpu_torch.rules import compiler as tcomp
from sitewhere_tpu_torch.tree import to_device

B, D, M = 256, 48, 4
P, N, S = 12, 16, 8
NEG = -(2 ** 31)
MEASUREMENTS = {"temp": 1, "hum": 2, "m3": 3}


def bits_equal(ref, got, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} != {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}"
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


# every ProgramOp, nested combinators and the reference's fixture programs
# (tests/test_rule_programs.py)
PROGRAMS = [
    {"token": "p-composite", "alert_level": "CRITICAL",
     "alert_type": "prog.composite",
     "when": {"all": [
         {"pred": "value", "measurement": "temp", "op": ">", "value": 90.0},
         {"pred": "value", "measurement": "hum", "op": "<", "value": 20.0}]}},
    {"token": "p-debounce", "alert_level": "WARNING",
     "when": {"debounce": {"pred": "value", "measurement": "temp",
                           "op": ">", "value": 50.0}, "count": 3}},
    {"token": "p-duration", "alert_level": "ERROR",
     "when": {"for_duration": {"pred": "value", "measurement": "temp",
                               "op": ">", "value": 70.0}, "ms": 2500}},
    {"token": "p-hyst", "alert_level": "INFO",
     "when": {"hysteresis": {
         "arm": {"pred": "value", "measurement": "temp", "op": ">",
                 "value": 80.0},
         "disarm": {"pred": "value", "measurement": "temp", "op": "<",
                    "value": 60.0}}}},
    {"token": "p-rate", "alert_level": "WARNING",
     "when": {"pred": "rate", "measurement": "temp", "op": ">",
              "value": 5.0}},
    {"token": "p-ewma", "alert_level": "WARNING",
     "when": {"pred": "ewma", "measurement": "temp", "op": ">",
              "value": 55.0, "alpha": 0.3}},
    {"token": "p-any-not", "alert_level": "ERROR",
     "when": {"any": [
         {"not": {"pred": "value", "measurement": "m3", "op": ">=",
                  "value": 10.0}},
         {"pred": "ewma", "measurement": "hum", "op": "<", "value": 30.0,
          "alpha": 0.7},
         {"pred": "rate", "measurement": "hum", "op": "<", "value": -20.0}]}},
    {"token": "p-nested", "alert_level": "CRITICAL",
     "tenant_token": "t2",
     "when": {"debounce": {"all": [
         {"for_duration": {"pred": "ewma", "measurement": "m3", "op": "!=",
                           "value": 0.0, "alpha": 0.05}, "ms": 40},
         {"not": {"pred": "value", "measurement": "temp", "op": "==",
                  "value": 50.0}}]}, "count": 2}},
    {"token": "p-typed", "device_type_token": "tracker",
     "when": {"pred": "rate", "measurement": "m3", "op": "<=",
              "value": 0.0}},
    {"token": "p-ghost", "tenant_token": "no-such-tenant",
     "when": {"pred": "value", "measurement": "temp", "op": ">",
              "value": 0.0}},
]


def compile_tables(comp, specs, epochs):
    table = comp.empty_program_table(P, N)
    for slot, (spec, epoch) in enumerate(zip(specs, epochs)):
        comp.compile_program_into(
            table, slot, dict(spec), epoch,
            intern_measurement=MEASUREMENTS.__getitem__,
            intern_alert_type=lambda name: len(name),
            lookup_tenant=lambda t: {"t1": 1, "t2": 2}.get(t, 0),
            lookup_device_type=lambda t: {"tracker": 2}.get(t, 0),
            measurement_slots=M, max_state_slots=S)
    return table


def both_tables(epochs):
    jt = compile_tables(jcomp, PROGRAMS, epochs)
    tt = compile_tables(tcomp, PROGRAMS, epochs)
    for f in dataclasses.fields(jt):
        bits_equal(getattr(jt, f.name), getattr(tt, f.name), f.name)
    return jax.tree_util.tree_map(jnp.asarray, jt), to_device(tt, "cpu")


def test_compiled_tables_equal_and_use_every_op():
    jt, tt = both_tables(list(range(1, len(PROGRAMS) + 1)))
    used = set(np.unique(tt.opcode.numpy()).tolist())
    assert used == set(range(10)), used      # NOP .. HYSTERESIS
    assert int((tt.opcode != 0).any(dim=0).nonzero().max()) + 1 <= N


def make_batch(rng, step):
    """Validated-batch columns: measurements on slots 0..4 (0 and 4 are
    untracked), locations, invalid rows; few timestamps per device."""
    dev = rng.integers(0, D, B).astype(np.int32)
    et = rng.choice([0, 0, 0, 0, 1, 2], B).astype(np.int32)
    return {
        "device_idx": dev,
        "valid": rng.random(B) < 0.9,
        "event_type": et,
        "mm_idx": np.where(et == 0, rng.choice([0, 1, 2, 3, 3, 4], B),
                           0).astype(np.int32),
        "ts": (step * 1000 + rng.integers(0, 20, B) * 10).astype(np.int32),
    }


def special_values(rng, shape):
    vals = rng.uniform(0, 100, shape).astype(np.float32)
    u = rng.random(shape)
    vals[u < 0.05] = np.nan
    vals[(u >= 0.05) & (u < 0.08)] = np.float32(1e-45)
    vals[(u >= 0.08) & (u < 0.11)] = 50.0
    vals[(u >= 0.11) & (u < 0.14)] = 0.0
    vals[(u >= 0.14) & (u < 0.16)] = -0.0
    vals[(u >= 0.16) & (u < 0.18)] = np.float32(-3e-39)
    return vals


def step_inputs(rng, step, cols):
    """Per-device post-fold measurement state and registry columns."""
    lm = special_values(rng, (D, M))
    lmts = (step * 1000 + rng.integers(-30, 30, (D, M)) * 10).astype(np.int32)
    lmts[rng.random((D, M)) < 0.1] = NEG
    tenant = rng.integers(0, 3, D).astype(np.int32)
    dtype = rng.integers(0, 3, D).astype(np.int32)
    return lm, lmts, tenant, dtype


@pytest.fixture(scope="module")
def jitted():
    return {
        "eval": jax.jit(jstateful.eval_rule_programs,
                        static_argnames=("node_limit",)),
        "obs": jax.jit(lambda cols: jstateful.observations_of_batch(
            types.SimpleNamespace(**cols), M, D)),
        "order": jax.jit(jseg.batch_device_order),
    }


def test_observations_and_device_order_equal(jitted):
    rng = np.random.default_rng(11)
    for step in range(3):
        cols = make_batch(rng, step)
        tb = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in cols.items()})
        ref = jitted["obs"]({k: jnp.asarray(v) for k, v in cols.items()})
        got = tstateful.observations_of_batch(tb, M, D)
        for name, r, g in zip(("obs_mm", "touched", "now_d", "attach"),
                              ref, got):
            bits_equal(r, g, name)
        assert got[3].sum() == got[1].sum() > 0    # one attach per device
        jorder, jinv = jitted["order"](jnp.asarray(cols["device_idx"]))
        order, inv = tseg.batch_device_order(torch.from_numpy(
            cols["device_idx"]))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def run_trace(jitted, steps, epochs_at, node_limit):
    """Both evaluators over `steps` steps from fresh state; the table's
    epochs per step come from `epochs_at(step)`. Asserts bit-equality of
    state and outputs after every step; returns the port's final state."""
    rng = np.random.default_rng(1234)
    jstate = jstateful.init_rule_state(D, P, S)
    tstate = tstateful.init_rule_state(D, P, S, device="cpu")
    totals = {"fired": 0, "suppressed": 0}
    for step in range(steps):
        jt, tt = both_tables(epochs_at(step))
        cols = make_batch(rng, step)
        lm, lmts, tenant, dtype = step_inputs(rng, step, cols)
        tb = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in cols.items()})
        obs_mm, _, now_d, attach = tstateful.observations_of_batch(tb, M, D)
        order, _ = tseg.batch_device_order(tb.device_idx)
        sdev = tb.device_idx[order]
        idx = sdev.long()
        kw = {"dev": sdev, "attach": attach[order], "obs_row": obs_mm[idx],
              "now_row": now_d[idx],
              "lm_row": torch.from_numpy(lm)[idx],
              "lmts_row": torch.from_numpy(lmts)[idx],
              "tenant_row": torch.from_numpy(tenant)[idx],
              "dtype_row": torch.from_numpy(dtype)[idx]}
        jstate, jout = jitted["eval"](
            jt, jstate, node_limit=node_limit,
            **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
        tstate, tout = tstateful.eval_rule_programs(
            tt, tstate, node_limit=node_limit, **kw)
        for name in ("slab", "gen", "fire_count", "suppress_count"):
            bits_equal(getattr(jstate, name), getattr(tstate, name),
                       f"step {step} {name}")
        for name in ("fired", "first_rule", "alert_level"):
            bits_equal(jout[name], tout[name], f"step {step} {name}")
        totals["fired"] += int(tout["fired"].sum())
        totals["suppressed"] += int(tstate.suppress_count.sum())
    return tstate, totals


@pytest.mark.parametrize("node_limit", [0, 9])
def test_eval_rule_programs_bit_equal_with_epoch_bump(jitted, node_limit):
    """Five steps; at step 3 programs 1, 5 and 7 are re-installed (epoch
    bump): their slab rows read as fresh and their counters restart."""
    base = list(range(1, len(PROGRAMS) + 1))
    bumped = [e + 100 if i in (1, 5, 7) else e for i, e in enumerate(base)]
    state, totals = run_trace(jitted, 5,
                              lambda s: bumped if s >= 3 else base,
                              node_limit)
    assert totals["fired"] > 0 and totals["suppressed"] > 0
    gen = state.slab[:, :, 4 * S + 1]
    assert (gen[:, 1] == 102).any() and (gen[:, 0] == 1).any()


def test_fma_f32_matches_xla_contraction():
    """`a*b + c` under jax.jit on the CPU rounds once; fma_f32 gives the
    same bits on seeded values with heavy cancellation, wide exponents,
    +-inf, NaN and denormals."""
    rng = np.random.default_rng(99)
    n = 1 << 16

    def wide():
        e = rng.integers(-60, 60, n).astype(np.float64)
        return (rng.uniform(-1, 1, n) * 2.0 ** e).astype(np.float32)

    a, b = wide(), wide()
    c = (-(a.astype(np.float64) * b)
         * (1 + rng.uniform(-1e-6, 1e-6, n))).astype(np.float32)
    c[::3] = wide()[::3]
    special = np.array([np.inf, -np.inf, np.nan, 1e-45, -1e-45, 0.0, -0.0,
                        1e-39, -5e-39, 3e38, -3e38, 1.2e-38], np.float32)
    k = len(special)
    a[:k], b[k:2 * k], c[2 * k:3 * k] = special, special, special
    a[3 * k:4 * k], b[3 * k:4 * k], c[3 * k:4 * k] = special, special, special
    ref = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c)))
    bits_equal(ref, got, "fma_f32")


def test_op_by_op_ewma_differs_from_reference():
    """Pins why the EWMA needs `fma_f32`: op-by-op f32 rounding of
    `alpha*v + (1-alpha)*sv` gives other bits than the JAX package's
    jitted update in more than a tenth of 4096 seeded cases (593 of them
    with this seed), and the fused form gives the same bits in all."""
    n, alpha = 4096, np.float32(0.3)
    rng = np.random.default_rng(5)
    v = rng.uniform(0, 100, n).astype(np.float32)
    sv = rng.uniform(0, 100, n).astype(np.float32)
    ref = np.asarray(jax.jit(lambda al, x, s: al * x + (1.0 - al) * s)(
        np.full(n, alpha), v, sv))
    ta = torch.full((n,), float(alpha))
    tv, tsv = torch.from_numpy(v), torch.from_numpy(sv)
    op_by_op = (ta * tv + (1.0 - ta) * tsv).numpy()
    differ = int((op_by_op.view(np.int32) != ref.view(np.int32)).sum())
    assert differ > n // 10, differ
    fused = fma_f32(ta, tv, flush_denormals(flush_denormals(1.0 - ta) * tsv))
    bits_equal(ref, fused, "fused ewma")
