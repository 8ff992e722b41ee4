"""The port's actuation stage held against the JAX package's, on the CPU.

Compiled policy tables and synthesized per-family fire bits go through the
jitted JAX `eval_actuation_policies` and the port's: the command lanes, the
debounce slab and the counters must be bit-equal, over sequential steps
that exercise every matching dimension, lane overflow, debounce and the
epoch reset; `decode_command_lanes` must decode the same fields.
Tolerance: none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.actuation import compiler as jcomp
from sitewhere_tpu.ops import actuate as jact
from sitewhere_tpu_torch.actuation import compiler as tcomp
from sitewhere_tpu_torch.ops import actuate as tact
from sitewhere_tpu_torch.tree import to_device

from test_torch_stateful import bits_equal

FAMILIES = (("thr", "first_rule"), ("geo", "first_rule"),
            ("prog", "first_rule"), ("model", "first_model"))


def tables(specs, epochs=None):
    out = []
    for comp in (jcomp, tcomp):
        table = comp.empty_policy_table(max(len(specs), 2))
        commands = {}
        for slot, spec in enumerate(specs):
            comp.compile_policy_into(
                table, slot, dict(spec), epochs[slot] if epochs else slot + 1,
                intern_command=lambda t: commands.setdefault(
                    t, len(commands) + 1),
                lookup_tenant=lambda t: {"acme": 1, "beta": 2}.get(t, 0))
        out.append(table)
    jt, tt = out
    for f in dataclasses.fields(jt):
        bits_equal(getattr(jt, f.name), getattr(tt, f.name), f.name)
    return jax.tree_util.tree_map(jnp.asarray, jt), to_device(tt, "cpu")


def family_dicts(B, rng=None, **per_kind):
    """Per-family (fired, slot, level) [B] columns: given lists, seeded
    random ones (`rng`), or all off."""
    out = {}
    for name, key in FAMILIES:
        if name in per_kind:
            fired, slot, level = per_kind[name]
        elif rng is not None:
            fired = rng.random(B) < 0.5
            slot = rng.integers(0, 5, B)
            level = np.where(fired, rng.integers(0, 4, B), -1)
        else:
            fired, slot, level = [False] * B, [-1] * B, [-1] * B
        out[name] = {"fired": np.asarray(fired, bool),
                     key: np.asarray(slot, np.int32),
                     "alert_level": np.asarray(level, np.int32)}
    return out


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(jact.eval_actuation_policies, static_argnames=("capacity",))


class Pair:
    """A JAX and a port actuation state advanced side by side."""

    def __init__(self, jitted, D, P):
        self.jitted = jitted
        self.j = jact.init_actuation_state(D, P)
        self.t = tact.init_actuation_state(D, P, device="cpu")

    def step(self, jt, tt, fams, dev, ts, tenant, capacity):
        cols = {"dev": np.asarray(dev, np.int32),
                "ts": np.asarray(ts, np.int32),
                "tenant_row": np.asarray(tenant, np.int32)}
        self.j, jl = self.jitted(
            jt, self.j, capacity=capacity,
            **{k: jnp.asarray(v) for k, v in cols.items()},
            **{n: {k: jnp.asarray(v) for k, v in d.items()}
               for n, d in fams.items()})
        self.t, tl = tact.eval_actuation_policies(
            tt, self.t, capacity=capacity,
            **{k: torch.from_numpy(v) for k, v in cols.items()},
            **{n: {k: torch.from_numpy(v) for k, v in d.items()}
               for n, d in fams.items()})
        bits_equal(jl, tl, "command lanes")
        for name in ("slab", "gen", "fire_count", "debounce_count"):
            bits_equal(getattr(self.j, name), getattr(self.t, name), name)
        jd = jact.decode_command_lanes(np.asarray(jl))
        td = tact.decode_command_lanes(tl.numpy())
        for f in dataclasses.fields(jd):
            bits_equal(getattr(jd, f.name), getattr(td, f.name), f.name)
        return td


MIXED = [
    {"token": "any", "command": "c0"},
    {"token": "thr-only", "source": "threshold", "command": "c1",
     "min_level": "ERROR"},
    {"token": "slot3", "source": "model", "match_slot": 3, "command": "c2",
     "min_level": "INFO"},
    {"token": "acme", "tenant_token": "acme", "command": "c3",
     "min_level": "INFO"},
    {"token": "deb", "command": "c4", "debounce_ms": 500,
     "min_level": "INFO", "params": [7, -1]},
    {"token": "off", "command": "c5", "active": False},
    {"token": "prog2", "source": "program", "match_slot": 2,
     "command": "c6", "min_level": "WARNING"},
    {"token": "geo", "source": "geofence", "command": "c7",
     "debounce_ms": 250, "min_level": "INFO"},
]


def test_mixed_sources_across_steps_with_epoch_bump(jitted):
    """Every matching dimension over four steps (debounce against carried
    state), rows of out-of-range devices (dropped), and an epoch bump of two
    policies at step 2 (their debounce records read as never-fired)."""
    B, D = 64, 10
    rng = np.random.default_rng(7)
    pair = Pair(jitted, D, len(MIXED))
    totals = np.zeros(3, np.int64)
    for step in range(4):
        epochs = [e + (40 if i in (4, 7) and step >= 2 else 0)
                  for i, e in enumerate(range(1, len(MIXED) + 1))]
        jt, tt = tables(MIXED, epochs)
        dev = rng.integers(0, D, B)
        dev[:3] = [D, D + 5, 2 ** 22 - 1]
        dec = pair.step(jt, tt, family_dicts(B, rng), dev,
                        step * 300 + rng.integers(0, 200, B),
                        rng.integers(0, 3, B), capacity=32)
        totals += (dec.fired, dec.debounced, dec.dropped)
    assert totals[0] > 0 and totals[1] > 0 and totals[2] > 0


def test_storm_overflow_counts_dropped(jitted):
    """> capacity fired (device, policy) pairs: the lane keeps the first K
    in device-major order and counts the rest as dropped."""
    specs = [{"token": f"p{i}", "command": "c", "min_level": "INFO"}
             for i in range(2)]
    jt, tt = tables(specs)
    B = D = 8
    fams = family_dicts(B, thr=([True] * B, [0] * B, [3] * B))
    dec = Pair(jitted, D, 2).step(jt, tt, fams, range(B), range(B),
                                  [1] * B, capacity=4)
    assert (dec.fired, dec.dropped, dec.n) == (16, 12, 4)
    assert dec.dev.tolist() == [0, 0, 1, 1]
    assert dec.policy_slot.tolist() == [0, 1, 0, 1]


def test_debounce_window_and_epoch_reset(jitted):
    """A blocked trigger leaves the stored last-fire ts; an epoch bump makes
    a mid-window trigger fire again."""
    spec = {"token": "p", "command": "c", "debounce_ms": 1000,
            "min_level": "INFO"}
    jt, tt = tables([spec])
    pair = Pair(jitted, 2, 2)
    fams = family_dicts(1, thr=([True], [0], [3]))
    fired = [pair.step(jt, tt, fams, [0], [ts], [1], capacity=4).n
             for ts in (100, 600, 1400, 1200)]
    assert fired == [1, 0, 1, 0]
    assert int(pair.t.slab[0, 0, 2]) == 1400
    jt, tt = tables([spec], epochs=[9])
    assert pair.step(jt, tt, fams, [0], [1500], [1], capacity=4).n == 1


def test_last_matching_row_wins(jitted):
    jt, tt = tables([{"token": "p", "command": "c", "min_level": "INFO"}])
    fams = family_dicts(6, thr=([True, False, True, True, False, True],
                                [0] * 6, [3, -1, 2, 1, -1, 2]))
    dec = Pair(jitted, 2, 2).step(jt, tt, fams, [0, 0, 0, 1, 1, 1],
                                  range(6), [1] * 6, capacity=8)
    assert dec.rows.tolist() == [2, 5] and dec.level.tolist() == [2, 2]


def test_no_fire_empty_lane(jitted):
    jt, tt = tables([{"token": "p0", "command": "c"}])
    dec = Pair(jitted, 4, 2).step(jt, tt, family_dicts(8), range(8),
                                  range(8), [1] * 8, capacity=8)
    assert dec.n == 0 and dec.fired == 0
