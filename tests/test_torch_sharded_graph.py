"""The sharded step as a captured graph, and the sharded engine on the card.

On the CPU (no CUDA graphs here), with the eager stand-in of
tests/test_torch_graph.py for the graph (each "replay" runs the captured
function on the static blob): a ShardedPipelineEngine that captures keeps
one graph per static configuration — the stage flags and the blob's shape,
which tells the device-routed flat blob `[rows, S*B]` from the host-routed
`[S, rows, B]` — counts S geofence launches a replay (one a shard), and
gives the alerts, presence transitions and state of a sharded engine that
never captures, on both routes and every wire layout.

On the card (marked `cuda`; skipped elsewhere — run with
`python -m pytest --noconftest -m cuda tests/test_torch_sharded_graph.py`):
the sharded engine with real graphs against the same engine on the CPU,
bit for bit, B1 counted S times a step, one capture per key, and the
pipelined feeder against serial submits. JAX-free: the world comes from
chip_smoke.py at a small size. Tolerance: none.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import assert_tree_bits_equal, build_world, synthetic_batch
from sitewhere_tpu_torch.ops.pack import wire_variant_for
from sitewhere_tpu_torch.pipeline import engine as engine_mod
from sitewhere_tpu_torch.pipeline.graph import CapturedStep, OutputArena

S = 4
SMALL = dict(max_devices=512, n_registered=400, n_zones=24, n_verts=8,
             batch=256, shards=S)
# a flat batch short of S * B: uniform traffic fits the lanes and shards
EVENTS = 160


def small_batches(engine, n, seed=0, **kw):
    return [synthetic_batch(engine.packer, SMALL["n_registered"], EVENTS,
                            chip_smoke.SEED + seed + s, t_off_ms=1000 * s,
                            **kw) for s in range(n)]


def layered(engine):
    """Compact, packed and full batches, interleaved."""
    compact = small_batches(engine, 3)
    packed = small_batches(engine, 2, seed=50, p_types=(0.9, 0.0, 0.1))
    full = small_batches(engine, 2, seed=70)
    for b in full:
        b.elevation = torch.full_like(b.elevation, 7.5)
    return [compact[0], packed[0], full[0], compact[1], packed[1],
            full[1], compact[2]]


def drive(engine, batches):
    alerts, outs = [], []
    for batch in batches:
        view, out = engine.submit(batch)
        alerts.append(chip_smoke._alert_keys(
            engine.materialize_alerts(view, out)))
        outs.append(out)
    return alerts, outs


def assert_same_state(a, b):
    assert_tree_bits_equal(a.canonical_state(), b.canonical_state(),
                           "state")


class _EagerGraph:
    def __init__(self, step_fn, static_blob, arena, out_flat):
        self.replay = lambda: arena.store(out_flat, step_fn(static_blob))


def eager_capture(step_fn, blob_like, outputs_like):
    """The graph stand-in: S geofence launches a replay, one a shard."""
    static_blob = torch.empty_like(blob_like)
    arena = OutputArena(outputs_like)
    out_flat = torch.empty(arena.nbytes, dtype=torch.uint8)
    return CapturedStep(_EagerGraph(step_fn, static_blob, arena, out_flat),
                        static_blob, arena, out_flat,
                        {"points_in_zones": S}, None)


@pytest.mark.parametrize("device_routing", [True, False],
                         ids=["device-route", "host-route"])
def test_one_graph_per_key_and_equal_to_an_engine_that_never_captures(
        monkeypatch, device_routing):
    monkeypatch.setattr(engine_mod, "capture_step", eager_capture)
    cpu = torch.device("cpu")
    ref = build_world(cpu, "auto", device_routing=device_routing, **SMALL)
    eng = build_world(cpu, "auto", ref.packer.epoch_base_ms,
                      device_routing=device_routing, **SMALL)
    monkeypatch.setattr(eng, "_captures", lambda: True)
    trace = layered(eng)
    got, want = drive(eng, trace), drive(ref, trace)
    assert got[0] == want[0] and sum(map(len, got[0])) > 0
    for mine, theirs in zip(got[1], want[1]):   # outputs stay valid
        assert_tree_bits_equal(mine, theirs, "outputs")
    assert_same_state(eng, ref)
    assert sorted(eng.presence_sweep()) == sorted(ref.presence_sweep())
    layouts = {wire_variant_for(b)[0] for b in trace}
    assert layouts == {3, 4, 5}
    assert eng.graph_captures == len(layouts) == len(eng._graphs)
    shapes = {key[-1] for key in eng._graphs}
    assert all(len(shape) == (2 if device_routing else 3)
               for shape in shapes)
    # every step but each key's first is a replay, S launches each
    assert eng.graph_kernel_launches["points_in_zones"] == \
        S * (len(trace) - len(layouts))
    if device_routing:
        assert eng.device_route_steps == len(trace)
        assert eng.device_route_fallbacks == eng.device_route_dropped == 0


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the geofence "
                    "kernel have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("device_routing", [True, False],
                         ids=["device-route", "host-route"])
def test_sharded_engine_on_card_equals_the_cpu(card, device_routing):
    cpu_eng = build_world(torch.device("cpu"), "auto",
                          device_routing=device_routing, **SMALL)
    engine = build_world(card, "auto", cpu_eng.packer.epoch_base_ms,
                         device_routing=device_routing, **SMALL)
    trace = layered(engine)
    chip_smoke.reset_launch_counts(engine)
    got = drive(engine, trace)
    launches = chip_smoke.launch_counts(engine)["points_in_zones"]
    want = drive(cpu_eng, trace)
    assert got[0] == want[0]
    for mine, theirs in zip(got[1], want[1]):
        assert_tree_bits_equal(theirs, mine, "outputs")
    assert_same_state(engine, cpu_eng)
    assert launches == S * len(trace)            # once a shard a step
    # one a wire layout on each card the mesh spreads over
    assert engine.graph_captures == 3 * engine.n_cards
    assert engine.device_route_dropped == 0


@pytest.mark.cuda
def test_sharded_pipelined_equals_serial_on_card(card):
    from sitewhere_tpu_torch.pipeline.feed import ShardedPipelinedSubmitter

    serial = build_world(card, "auto", **SMALL)
    piped = build_world(card, "auto", serial.packer.epoch_base_ms, **SMALL)
    trace = layered(serial)
    want = drive(serial, trace)
    sub = ShardedPipelinedSubmitter(piped, depth=3, stagers=2)
    futs = [sub.submit(b) for b in trace]
    sub.flush()
    got = []
    for f in futs:
        view, out = f.result()
        got.append(chip_smoke._alert_keys(piped.materialize_alerts(view,
                                                                   out)))
    sub.close()
    assert got == want[0]
    assert_same_state(serial, piped)
    assert serial.graph_captures == piped.graph_captures == \
        3 * serial.n_cards
    assert piped.staging_ring.occupancy() == 0
