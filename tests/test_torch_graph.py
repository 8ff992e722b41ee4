"""The captured step (sitewhere_tpu_torch/pipeline/graph.py) and the engine's
graph bookkeeping.

On the CPU (no CUDA graphs here):
  - the output arena moves a step's outputs through one flat buffer and
    back as typed views, bit for bit; the helpers behind static buffers
    (`step_key`, `commit`, `same_layout`) do what the engine relies on;
  - the engine's bookkeeping, with an eager stand-in for the CUDA graph
    (each "replay" runs the captured function on the static blob): one
    capture per static configuration (stage flags x wire layout), kernel
    launches counted per replay, the graphs dropped on a family transition,
    outputs that stay valid after later steps, and a failed capture that
    raises, marks the engine failed and never falls back to eager steps —
    all while alerts, command fires and every state group stay identical
    to an engine that never captures.
On the card (marked `cuda`; skipped elsewhere — run with
`python -m pytest --noconftest -m cuda tests/test_torch_graph.py`): the same
world with real graphs, bit-equal to eager `process_batch` (chip_smoke's
EagerTwin), the geofence kernel counted once per replay, one capture per
key, pipelined feeding equal to serial submits, and a capture beside more
threads querying on their own streams than PyTorch's stream pool holds.
This file imports no JAX: the world comes from chip_smoke.py at a small
size. Tolerance: none.
"""

import dataclasses
import threading

import pytest
import torch

import chip_smoke
from chip_smoke import (
    EagerTwin, assert_tree_bits_equal, build_stateful_world, build_world,
    synthetic_batch)
from sitewhere_tpu_torch.ops.pack import wire_variant_for
from sitewhere_tpu_torch.pipeline import engine as engine_mod
from sitewhere_tpu_torch.pipeline.graph import (
    CapturedStep, OutputArena, commit, same_layout, step_key)
from sitewhere_tpu_torch.runtime.health import FAILED
from sitewhere_tpu_torch.tree import tree_leaves

SMALL = dict(max_devices=512, n_registered=400, n_zones=24, n_verts=8,
             batch=256)


def small_batches(engine, n, seed=0, **kw):
    return [synthetic_batch(engine.packer, SMALL["n_registered"],
                            SMALL["batch"], chip_smoke.SEED + seed + s,
                            t_off_ms=1000 * s, **kw) for s in range(n)]


def drive(engine, batches):
    """submit + materialize + take_command_fires; (alert keys, fires,
    outputs) per step."""
    alerts, fires, outs = [], [], []
    for batch in batches:
        out = engine.submit(batch)
        alerts.append(chip_smoke._alert_keys(
            engine.materialize_alerts(batch, out)))
        fires.append(engine.take_command_fires())
        outs.append(out)
    return alerts, fires, outs


def assert_engines_equal(a, b):
    for group in ("_state", "_rule_state", "_model_state",
                  "_actuation_state"):
        assert_tree_bits_equal(getattr(a, group), getattr(b, group), group)
    assert a.rule_program_counters() == b.rule_program_counters()
    assert a.anomaly_model_counters() == b.anomaly_model_counters()
    assert a.actuation_policy_counters() == b.actuation_policy_counters()


# -- the CPU ------------------------------------------------------------------

def test_output_arena_round_trip():
    engine = build_stateful_world(torch.device("cpu"), **SMALL)
    out = engine.submit(small_batches(engine, 1)[0])
    arena = OutputArena(out)
    assert all(off % 16 == 0 for *_, off, _ in arena.fields)
    assert arena.nbytes >= sum(n for *_, n in arena.fields)
    flat = torch.full((arena.nbytes,), 0xA5, dtype=torch.uint8)
    arena.store(flat, out)
    back = arena.views(flat)
    assert_tree_bits_equal(out, back, "outputs")
    for f in dataclasses.fields(out):
        got = getattr(back, f.name)
        assert got.dtype == getattr(out, f.name).dtype
        assert got.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()


def test_static_buffer_helpers():
    flags = {"programs_enabled": True, "program_node_limit": 6,
             "models_enabled": False, "actuation_enabled": True}
    assert step_key(flags, (4, 256)) == (True, 6, False, True, (4, 256))
    assert step_key(flags, (3, 256)) != step_key(flags, (4, 256))
    engine = build_world(torch.device("cpu"), "auto", **SMALL)
    state = engine.state
    fresh = dataclasses.replace(
        state, event_count=state.event_count + 1,
        tenant_event_count=torch.arange(state.tenant_event_count.numel(),
                                        dtype=torch.int32))
    assert same_layout(state, fresh)
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    commit(state, fresh)
    assert [t.data_ptr() for t in tree_leaves(state)] == ptrs
    assert torch.equal(state.event_count, fresh.event_count)
    assert not same_layout(state, dataclasses.replace(
        state, event_count=state.event_count[:3]))


class EagerGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    function on the static blob and stores its outputs, as the graph's
    kernels would."""

    def __init__(self, step_fn, static_blob, arena, out_flat):
        self.replay = lambda: arena.store(out_flat, step_fn(static_blob))


def eager_capture(step_fn, blob_like, outputs_like):
    static_blob = torch.empty_like(blob_like)
    arena = OutputArena(outputs_like)
    out_flat = torch.empty(arena.nbytes, dtype=torch.uint8)
    graph = EagerGraph(step_fn, static_blob, arena, out_flat)
    return CapturedStep(graph, static_blob, arena, out_flat,
                        {"points_in_zones": 1}, None)


@pytest.fixture
def graphed(monkeypatch):
    """A CPU engine that captures (with the eager stand-in) and a plain
    CPU engine over the same stateful world and epoch."""
    monkeypatch.setattr(engine_mod, "capture_step", eager_capture)
    cpu = torch.device("cpu")
    ref = build_stateful_world(cpu, **SMALL)
    eng = build_stateful_world(cpu, ref.packer.epoch_base_ms, **SMALL)
    monkeypatch.setattr(eng, "_captures", lambda: True)
    return eng, ref


def test_graph_bookkeeping_matches_an_engine_that_never_captures(graphed):
    eng, ref = graphed
    batches = small_batches(eng, 6, mm_slots=(1, 2))
    # a location-free batch of one ts span packs in the 3-row layout
    packed = small_batches(eng, 2, seed=50, p_types=(0.9, 0.0, 0.1))
    trace = batches[:3] + packed + batches[3:]
    got, want = drive(eng, trace), drive(ref, trace)
    assert got[:2] == want[:2] and sum(map(len, got[0])) > 0
    for mine, theirs in zip(got[2], want[2]):   # outputs stay valid
        assert_tree_bits_equal(mine, theirs, "outputs")
    assert_engines_equal(eng, ref)
    shapes = {wire_variant_for(b)[0] for b in trace}
    assert shapes == {3, 4}
    assert eng.graph_captures == len(shapes) == len(eng._graphs)
    assert ref.graph_captures == 0 and not ref._graphs
    # every step but each key's first is a replay
    assert eng.graph_kernel_launches["points_in_zones"] == \
        len(trace) - len(shapes)

    # a family transition reallocates its group: the graphs go
    for spec in chip_smoke.STATEFUL_MODELS:
        for e in (eng, ref):
            e.remove_anomaly_model(spec["token"])
    more = small_batches(eng, 3, seed=90, mm_slots=(1, 2))
    got, want = drive(eng, more), drive(ref, more)
    assert got[:2] == want[:2]
    assert_engines_equal(eng, ref)
    assert eng.graph_captures == len(shapes) + 1 and len(eng._graphs) == 1


def test_failed_capture_raises_and_never_runs_eagerly(graphed, monkeypatch):
    eng, ref = graphed
    batches = small_batches(eng, 3)

    def broken(step_fn, blob_like, outputs_like):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(engine_mod, "capture_step", broken)
    ref.submit(batches[0])
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.submit(batches[0])
    assert eng.health.state == FAILED and eng.graph_captures == 0
    # the key's first step ran once (its state is kept) ...
    assert_engines_equal(eng, ref)
    eng.step_retries = 0
    # ... and the key never runs eagerly again
    with pytest.raises(RuntimeError, match="failed to capture"):
        eng.submit(batches[1])
    assert eng.batches_processed == 0
    assert_engines_equal(eng, ref)


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the geofence "
                    "kernel have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stateful", [False, True],
                         ids=["main", "stateful"])
def test_graph_engine_matches_eager_on_card(card, stateful):
    build = build_stateful_world if stateful else build_world
    engine = build(card, **({} if stateful else {"geofence_impl": "auto"}),
                   **SMALL)
    twin = EagerTwin(engine)
    batches = small_batches(engine, 6, mm_slots=(1, 2))
    chip_smoke.reset_launch_counts(engine)
    _, _, outs = drive(engine, batches)
    launches = chip_smoke.launch_counts(engine)["points_in_zones"]
    assert launches == len(batches)          # once per step, per replay
    assert engine.graph_captures == 1
    for batch, out in zip(batches, outs):
        assert_tree_bits_equal(twin.step(batch), out, "outputs")
    twin.assert_state_equal(engine)


@pytest.mark.cuda
def test_one_capture_per_key_and_pipelined_equals_serial_on_card(card):
    from sitewhere_tpu_torch.pipeline.feed import PipelinedSubmitter

    serial = build_world(card, "auto", **SMALL)
    piped = build_world(card, "auto", serial.packer.epoch_base_ms, **SMALL)
    batches = small_batches(serial, 4) + small_batches(
        serial, 3, seed=50, p_types=(0.9, 0.0, 0.1)) + small_batches(
        serial, 3, seed=70)
    want = drive(serial, batches)
    sub = PipelinedSubmitter(piped, depth=3, stagers=2)
    futs = [sub.submit(b) for b in batches]
    sub.flush()
    got = [chip_smoke._alert_keys(piped.materialize_alerts(b, f.result()))
           for b, f in zip(batches, futs)]
    sub.close()
    assert got == want[0]
    assert_engines_equal(serial, piped)
    assert serial.graph_captures == piped.graph_captures == 2
    assert piped.staging_ring.occupancy() == 0


@pytest.mark.cuda
def test_failed_capture_raises_on_card(card, monkeypatch):
    engine = build_world(card, "auto", **SMALL)

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        engine.submit(small_batches(engine, 1)[0])
    assert engine.health.state == FAILED
    with pytest.raises(RuntimeError, match="failed to capture"):
        engine.submit(small_batches(engine, 1, seed=3)[0])


@pytest.mark.cuda
def test_capture_beside_threads_on_their_own_streams_on_card(card):
    """40 threads, more than PyTorch's pool of 32 streams a priority, work
    and sync on their own streams (device.own_stream) while the engine's
    first step is captured: the capture's stream is none of theirs, the
    capture succeeds and the graph steps as the eager engine does."""
    from sitewhere_tpu_torch.device import own_stream
    from sitewhere_tpu_torch.pipeline.graph import capture_stream

    streams, errors = set(), []
    lock, stop = threading.Lock(), threading.Event()
    ready = threading.Barrier(41, timeout=60)

    def query():
        try:
            with own_stream(card):
                stream = torch.cuda.current_stream(card)
                with lock:
                    streams.add(stream.cuda_stream)
                x = torch.ones(4096, device=card)
                ready.wait()
                while not stop.is_set():
                    (x * 2.0).sum()
                    stream.synchronize()
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    engine = build_world(card, "auto", **SMALL)
    twin = EagerTwin(engine)
    batches = small_batches(engine, 3)
    threads = [threading.Thread(target=query) for _ in range(40)]
    for t in threads:
        t.start()
    try:
        ready.wait()
        _, _, outs = drive(engine, batches)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:3]
    assert engine.graph_captures == 1
    assert capture_stream(card).cuda_stream not in streams
    for batch, out in zip(batches, outs):
        assert_tree_bits_equal(twin.step(batch), out, "outputs")
    twin.assert_state_equal(engine)
