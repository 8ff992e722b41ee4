"""The rule-program stage's hand kernel (csrc/rule_programs.cu) and its plain
version, on adversarial worlds.

`chip_smoke.adversarial_rule_world` makes seeded worlds (chip_smoke's
RULE_WORLDS): every opcode and unknown ones, NaN/+-inf/-0.0/denormal values
and constants, generations that lag the epoch, device indices >= D,
timestamps near NEG that wrap, DEBOUNCE at its 2^30 cap, P = 256, N = 40
and 80, a node_limit, S = 64 (records too large for shared memory).

  - On the CPU, the JAX package's `eval_rule_programs` under jax.jit and
    the port's `eval_rule_programs_plain` must agree bit for bit on every
    slab lane, the generation and counters, and every row output, step
    after step (tolerance: none; f32 compared as bit patterns).
  - `eval_rule_programs` runs the plain version on CPU tensors and raises
    on mixed devices and wrong dtypes.
  - Marked `cuda` (skipped without a card): the kernel against the plain
    version on the card on the same worlds, bit for bit, one launch a
    step. Run on the card with
    `python -m pytest --noconftest -m cuda tests/test_torch_rule_kernel.py`
    (`--noconftest`: tests/conftest.py imports JAX, which the card's
    machine need not have; this file imports JAX only inside its CPU
    tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import RULE_WORLDS, adversarial_rule_world, rule_world_tensors
from sitewhere_tpu_torch.ops import stateful as tstateful
from sitewhere_tpu_torch.rules import compiler as tcomp

WORLDS = {w[0]: w for w in RULE_WORLDS}
SLAB_COUNTERS = ("slab", "gen", "fire_count", "suppress_count")
ROW_OUTPUTS = ("fired", "first_rule", "alert_level")


def make_world(name):
    _, seed, B, D, P, N, S, M, limit, over = WORLDS[name]
    return adversarial_rule_world(seed, B, D, P, N, S, M, node_limit=limit,
                                  attach_over_d=over)


def _np(x):
    """A numpy copy (a CPU tensor's .numpy() would share the slab that the
    next step updates in place)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(x)


def bits_equal(ref, got, what):
    ref, got = _np(ref), _np(got)
    assert got.dtype == ref.dtype, f"{what}: dtype {got.dtype} != {ref.dtype}"
    assert got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}"
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def run_port(world, device, fn):
    """`fn` (the plain version or the dispatcher) over the world's steps on
    `device`; per step, the state and outputs as numpy."""
    table, state, batches = rule_world_tensors(
        world, device, tcomp.RuleProgramTable, tstateful.RuleStateTensors)
    trace = []
    for batch in batches:
        rows = dict(batch)
        table = dataclasses.replace(table, epoch=rows.pop("epoch"))
        state, out = fn(table, state, node_limit=world["node_limit"], **rows)
        trace.append(({k: _np(getattr(state, k)) for k in SLAB_COUNTERS},
                      {k: _np(out[k]) for k in ROW_OUTPUTS}))
    return trace


def assert_traces_equal(ref, got):
    for step, ((rs, ro), (gs, go)) in enumerate(zip(ref, got)):
        for k in SLAB_COUNTERS:
            bits_equal(rs[k], gs[k], f"step {step} {k}")
        for k in ROW_OUTPUTS:
            bits_equal(ro[k], go[k], f"step {step} {k}")


# -- the plain version against the JAX package (CPU) ----------------------------

@pytest.fixture(scope="module")
def jax_eval():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from sitewhere_tpu.ops import stateful as jstateful
    from sitewhere_tpu.rules import compiler as jcomp

    fn = jax.jit(jstateful.eval_rule_programs,
                 static_argnames=("node_limit",))

    def run(world):
        table = jcomp.RuleProgramTable(
            **{k: jnp.asarray(v) for k, v in world["table"].items()})
        state = jstateful.RuleStateTensors(
            **{k: jnp.asarray(v) for k, v in world["state"].items()})
        trace = []
        for batch in world["batches"]:
            rows = {k: jnp.asarray(v) for k, v in batch.items()}
            table = table.replace(epoch=rows.pop("epoch"))
            state, out = fn(table, state, node_limit=world["node_limit"],
                            **rows)
            trace.append(({k: np.asarray(getattr(state, k))
                           for k in SLAB_COUNTERS},
                          {k: np.asarray(out[k]) for k in ROW_OUTPUTS}))
        return trace

    return run


@pytest.mark.parametrize("name", list(WORLDS))
def test_plain_version_bit_equal_to_jitted_jax(jax_eval, name):
    world = make_world(name)
    ref = jax_eval(world)
    got = run_port(world, "cpu", tstateful.eval_rule_programs_plain)
    assert_traces_equal(ref, got)


def _f32_cases(rng, n=4096):
    """Operands for the f32 helpers: NaNs of both signs, quiet and
    signalling, with payloads, in every operand position; infinities; and
    operands whose results land around FLT_MIN, in the window where a
    result rounds up to FLT_MIN from an exact value that is tiny after
    rounding (x86 flushes it)."""
    nans = np.array([0x7FC00001, 0xFFC00002, 0x7F800003, 0xFF800004,
                     0x7FC00000], np.uint32).view(np.float32)
    specials = np.concatenate([nans, np.array(
        [np.inf, -np.inf, 0.0, -0.0, 1.0, 1e-45, 1.1754944e-38],
        np.float32)])
    a = rng.uniform(0.5, 2.0, n).astype(np.float32)
    b = (rng.uniform(0.5, 2.0, n) * 1.1754944e-38).astype(np.float32)
    c = (rng.choice([-1.0, 1.0], n) * rng.uniform(0, 2, n)
         * 1.1754944e-38).astype(np.float32)
    a[::2] *= rng.choice([-1.0, 1.0], n // 2).astype(np.float32)
    k = len(specials)
    for arr, stride in ((a, 3), (b, 5), (c, 7)):
        pick = np.arange(0, n, stride)[:4 * k]
        arr[pick] = np.resize(specials, len(pick))
    # exact products FLT_MIN(1 - 2^-26) (kept) and FLT_MIN(1 - 2^-24)
    # (flushed), both rounding to FLT_MIN with gradual underflow
    bits = np.array([[0x3F7FF800, 0x00800400], [0x3F7FFFFF, 0x00800000],
                     [0xBF7FF800, 0x00800400]], np.uint32)
    a[-3:], b[-3:] = bits[:, 0].view(np.float32), bits[:, 1].view(np.float32)
    return a, b, c


@pytest.mark.parametrize("op", ["sub", "mul", "div", "fma"])
def test_f32_ops_follow_xla_nan_and_tininess_rules(op):
    """ops/numerics.py's sub_f32 / mul_f32 / div_f32 / fma_f32 (the rule
    programs' arithmetic, which the kernel repeats) against XLA's jitted
    ops on the CPU, bit for bit: the first NaN operand, quieted, and
    flushing where the exact result is tiny after rounding. Before, the
    RATE difference took torch's subtraction (a signalling NaN operand's
    payload before a quiet one's) and every result flushed only below
    FLT_MIN after rounding with gradual underflow (ROADMAP queue C)."""
    jax = pytest.importorskip("jax")
    from sitewhere_tpu_torch.ops import numerics

    a, b, c = _f32_cases(np.random.default_rng(17))
    if op == "div":
        a, b = b, np.where(np.isnan(a) | (np.abs(a) < 0.5), a,
                           np.abs(a)).astype(np.float32)
    jfn = {"sub": lambda x, y: x - y, "mul": lambda x, y: x * y,
           "div": lambda x, y: x / y,
           "fma": lambda x, y, z: x * y + z}[op]
    tfn = {"sub": numerics.sub_f32, "mul": numerics.mul_f32,
           "div": numerics.div_f32, "fma": numerics.fma_f32}[op]
    args = (a, b, c) if op == "fma" else (a, b)
    ref = np.asarray(jax.jit(jfn)(*args))
    got = tfn(*(torch.from_numpy(x) for x in args))
    bits_equal(ref, got, op)


def test_worlds_reach_the_traps():
    """The fixture reaches what it is for: fires and suppressions, stale
    records, the debounce cap, NaN state, rows >= D, wrapped timestamps."""
    hits = dict.fromkeys(("fired", "suppressed", "debounce_cap", "nan_value",
                          "stale", "over_d_attach", "wrapped_now"), 0)
    for name in WORLDS:
        world = make_world(name)
        S = (world["state"]["slab"].shape[-1] - 2) // 4
        trace = run_port(world, "cpu", tstateful.eval_rule_programs_plain)
        slab = trace[-1][0]["slab"]
        hits["fired"] += sum(int(o["fired"].sum()) for _, o in trace)
        hits["suppressed"] += int(
            (trace[-1][0]["suppress_count"]
             != world["state"]["suppress_count"]).sum())
        hits["debounce_cap"] += int((slab[:, :, 3 * S:4 * S] == 2 ** 30)
                                    .sum())
        hits["nan_value"] += int(np.isnan(
            slab[:, :, :S].view(np.float32)).sum())
        hits["stale"] += int((world["state"]["slab"][:, :, 4 * S + 1]
                              != world["table"]["epoch"][None]).sum())
        D = slab.shape[0]
        for b in world["batches"]:
            hits["over_d_attach"] += int((b["attach"] & (b["dev"] >= D))
                                         .sum())
            hits["wrapped_now"] += int((b["now_row"] < -2 ** 31 + 64).sum())
    assert all(hits.values()), hits


# -- dispatch ---------------------------------------------------------------------

def _cpu_call(name="mixed"):
    world = make_world(name)
    table, state, batches = rule_world_tensors(
        world, "cpu", tcomp.RuleProgramTable, tstateful.RuleStateTensors)
    rows = dict(batches[0])
    table = dataclasses.replace(table, epoch=rows.pop("epoch"))
    return world, table, state, rows


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    world, table, state, rows = _cpu_call()

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel path ran for CPU tensors")

    monkeypatch.setattr(tstateful, "_eval_rule_programs_kernel", no_kernel)
    launches = tstateful.eval_rule_programs.launches
    ref_state, ref_out = tstateful.eval_rule_programs_plain(
        table, dataclasses.replace(state, slab=state.slab.clone()),
        node_limit=world["node_limit"], **rows)
    got_state, got_out = tstateful.eval_rule_programs(
        table, state, node_limit=world["node_limit"], **rows)
    assert tstateful.eval_rule_programs.launches == launches
    for k in SLAB_COUNTERS:
        bits_equal(getattr(ref_state, k), getattr(got_state, k), k)
    for k in ROW_OUTPUTS:
        bits_equal(ref_out[k], got_out[k], k)


@pytest.mark.parametrize("field", ["lm_row", "dev", "table.opcode",
                                   "state.slab"])
def test_mixed_devices_raise(field):
    _, table, state, rows = _cpu_call()
    if field.startswith("table."):
        name = field.split(".")[1]
        table = dataclasses.replace(
            table, **{name: getattr(table, name).to("meta")})
    elif field.startswith("state."):
        state = dataclasses.replace(state, slab=state.slab.to("meta"))
    else:
        rows[field] = rows[field].to("meta")
    with pytest.raises(ValueError, match="is on"):
        tstateful.eval_rule_programs(table, state, **rows)


def test_no_kernel_for_other_devices():
    _, table, state, rows = _cpu_call()
    meta = tcomp.RuleProgramTable(**{
        f.name: getattr(table, f.name).to("meta")
        for f in dataclasses.fields(table)})
    mstate = tstateful.RuleStateTensors(**{
        f.name: getattr(state, f.name).to("meta")
        for f in dataclasses.fields(state)})
    with pytest.raises(ValueError, match="no rule-program kernel"):
        tstateful.eval_rule_programs(
            meta, mstate, **{k: v.to("meta") for k, v in rows.items()})


@pytest.mark.parametrize("field,dtype", [
    ("dev", torch.int64), ("attach", torch.int32), ("lm_row", torch.float64),
    ("table.fconst", torch.float64), ("table.active", torch.int32),
    ("state.slab", torch.int64)])
def test_wrong_dtypes_raise(field, dtype):
    _, table, state, rows = _cpu_call()
    if field.startswith("table."):
        name = field.split(".")[1]
        table = dataclasses.replace(
            table, **{name: getattr(table, name).to(dtype)})
    elif field.startswith("state."):
        state = dataclasses.replace(state, slab=state.slab.to(dtype))
    else:
        rows[field] = rows[field].to(dtype)
    with pytest.raises(TypeError, match="must be"):
        tstateful.eval_rule_programs(table, state, **rows)


def test_wrong_shapes_raise():
    _, table, state, rows = _cpu_call()
    rows["lm_row"] = rows["lm_row"][:, :-1]
    with pytest.raises(ValueError, match="must be"):
        tstateful.eval_rule_programs(table, state, **rows)


# -- the kernel against the plain version (the card) ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WORLDS))
def test_kernel_bit_equal_to_plain_on_the_card(cuda, name):
    world = make_world(name)
    ref = run_port(world, cuda, tstateful.eval_rule_programs_plain)
    launches = tstateful.eval_rule_programs.launches
    got = run_port(world, cuda, tstateful.eval_rule_programs)
    torch.cuda.synchronize()
    assert tstateful.eval_rule_programs.launches - launches == \
        len(world["batches"])
    assert_traces_equal(ref, got)


@pytest.mark.cuda
def test_kernel_plans_cover_every_path(cuda):
    """The worlds reach each of the kernel's instantiations: records in
    shared and in global memory, node bits in registers and in global
    memory; and node columns staged in shared memory and read from the
    table."""
    seen, columns = set(), set()
    for _, _, B, D, P, N, S, M, limit, _ in RULE_WORLDS:
        plan = tstateful.rule_programs_plan(
            B, P, min(N, limit) if limit else N, S, cuda.index or 0)
        seen.add((plan["records"], plan["node_bits"]))
        columns.add(plan["node_columns"])
    assert {("shared", "registers"), ("shared", "global"),
            ("global", "registers")} <= seen
    assert columns == {"shared", "global"}


@pytest.mark.cuda
def test_kernel_under_graph_capture_counts_captures(cuda):
    """Captured into a CUDA graph, the launch counts on `.captures`; each
    replay then runs the kernel on the captured tensors and equals the
    plain version step after step."""
    world = make_world("mixed")
    table, state, batches = rule_world_tensors(
        world, cuda, tcomp.RuleProgramTable, tstateful.RuleStateTensors)
    ptable, pstate, _ = rule_world_tensors(
        world, cuda, tcomp.RuleProgramTable, tstateful.RuleStateTensors)
    rows = {k: v.clone() for k, v in batches[0].items() if k != "epoch"}
    table = dataclasses.replace(table, epoch=batches[0]["epoch"].clone())
    captures = tstateful.eval_rule_programs.captures
    launches = tstateful.eval_rule_programs.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm the plan and the library first
        tstateful.rule_programs_plan(rows["dev"].shape[0], table.num_programs,
                                     table.num_nodes, 8, cuda.index or 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new_state, out = tstateful.eval_rule_programs(
            table, state, node_limit=world["node_limit"], **rows)
    assert tstateful.eval_rule_programs.captures == captures + 1
    assert tstateful.eval_rule_programs.launches == launches
    for batch in batches:
        for k, v in rows.items():
            v.copy_(batch[k])
        table.epoch.copy_(batch["epoch"])
        graph.replay()
        # the next replay starts from this one's generation and counters,
        # committed into the captured buffers as the engine commits them
        for k in ("gen", "fire_count", "suppress_count"):
            getattr(state, k).copy_(getattr(new_state, k))
        prows = {k: v for k, v in batch.items() if k != "epoch"}
        ptable = dataclasses.replace(ptable, epoch=batch["epoch"])
        pstate, pout = tstateful.eval_rule_programs_plain(
            ptable, pstate, node_limit=world["node_limit"], **prows)
        torch.cuda.synchronize()
        for k in SLAB_COUNTERS:
            bits_equal(getattr(pstate, k), getattr(state, k), k)
        for k in ROW_OUTPUTS:
            bits_equal(pout[k], out[k], k)
