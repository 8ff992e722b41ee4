"""The port's shard axis over several cards, held on the CPU in card blocks.

A mesh over K cards holds shard s on block `s // (S/K)`; the CPU stands in
for every card (`make_mesh(S, devices=("cpu",) * K)`), so the blocks, the
route's exchange between them, the partial sums and the gathers run the
multi-card code paths on one device. Held against, on the same numpy-seeded
steps:
  - the JAX `ShardedPipelineEngine` over 8 virtual CPU devices
    (tests/conftest.py), step by step: alerts (order included), lanes,
    route counters, the overflow backlog and every canonical state group
    (tests/test_torch_sharded_engine.py `step_both`);
  - the port's one-block engine: the outputs of every step and the
    canonical state, bit for bit;
  - for the route alone, the one-block `device_route_chunk` and the host
    router's `route_blob`, drops included.
Tolerance: bits; the anomaly score within the reference's rtol=1e-4,
atol=1e-5 (the stateful world). The card's cases are in the JAX-free
tests/test_torch_multicard_card.py.
"""

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.ops.pack import WIRE_ROWS
from sitewhere_tpu_torch.ops.route import (
    build_device_route_program, host_fits_device_route, route_lane_capacity)
from sitewhere_tpu_torch.parallel import ShardedPipelineEngine, live_mesh
from sitewhere_tpu_torch.parallel.mesh import ShardMesh, make_mesh
from sitewhere_tpu_torch.parallel.router import ShardRouter
from sitewhere_tpu_torch.pipeline import engine as tengine

from test_torch_pipeline import (
    B, RULES, _alert_key, assert_bits_equal, assert_dataclass_bits_equal,
    world)  # noqa: F401 (fixture)
from test_torch_pipeline_stateful import (
    BUCKETS, MODELS, POLICIES, PROGRAMS, install)
from test_torch_route import LAYOUTS, flat_batch, jax_blob
from test_torch_sharded_engine import (
    VARIANTS, _kwargs, assert_engines_equal, assert_outputs_equal, pack,
    sharded_pair, spread_cols)

S = 8


def blocks(K):
    return ("cpu",) * K


def port_engine(world, K, device_routing, name, epoch_base_ms, **extra):
    """A port engine over K CPU blocks, set up as `sharded_pair`'s."""
    eng = ShardedPipelineEngine(
        world["treg"], mesh=make_mesh(S, devices=blocks(K)),
        per_shard_batch=B // S, device_routing=device_routing, name=name,
        **_kwargs(**extra))
    eng.packer.epoch_base_ms = epoch_base_ms
    for mm in ("m1", "m2", "m3"):
        eng.packer.measurements.intern(mm)
    for spec in RULES:
        eng.upsert_rule(*tengine.rule_from_dict(dict(spec)))
    eng.start()
    return eng


def assert_outputs_bits(a, b, what):
    for name in a.__dataclass_fields__:
        assert_bits_equal(getattr(a, name).numpy(), getattr(b, name),
                          f"{what}.{name}")


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_mesh_blocks_put_shard_s_on_card_s_over_s_per_card(K):
    mesh = make_mesh(S, devices=blocks(K))
    per = S // K
    assert mesh.n_cards == K and mesh.shards_per_card == per
    assert mesh.cards == (torch.device("cpu"),) * K
    assert [mesh.card_of_shard(s) for s in range(S)] == \
        [s // per for s in range(S)]
    assert [mesh.shards_on(k) for k in range(K)] == \
        [list(range(k * per, (k + 1) * per)) for k in range(K)]
    assert list(mesh.devices) == [torch.device("cpu")] * S
    assert mesh.device == torch.device("cpu") and mesh.size == S


def test_mesh_refusals():
    """K must divide S; "cuda" without a card raises (no CPU stand-in);
    `live_mesh` answers None without a card; a process of a multi-process
    mesh holds K cards, K dividing its S/P shards."""
    with pytest.raises(ValueError, match="3 cards do not divide 8"):
        make_mesh(S, devices=blocks(3))
    with pytest.raises(ValueError, match="at least one card"):
        make_mesh(S, devices=())
    with pytest.raises(ValueError, match="3 cards do not divide the 4 "
                                         "shards of this process"):
        ShardMesh(8, n_processes=2, cards=blocks(3))
    host = ShardMesh(8, n_processes=2, process_index=1, cards=blocks(2))
    assert host.local_shards == [4, 5, 6, 7] and host.shards_per_card == 2
    assert [host.shards_on(k) for k in range(2)] == [[4, 5], [6, 7]]
    assert [host.card_of_shard(s) for s in host.local_shards] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="do not divide"):
        ShardMesh(4, cards=blocks(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(S)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(S, devices=("cuda:0", "cuda:0"))
        assert live_mesh() is None


# -- the route across blocks ---------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("Sr,K", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 8)])
def test_device_route_across_blocks_bit_equal(Sr, K, layout):
    """The route over K blocks (each block buckets its chunks, the exchange,
    each block compacts) equals the one-block route and, where the batch
    fits the lanes, the host router; a skewed batch drops the same rows."""
    Bs = 16
    one = build_device_route_program(make_mesh(Sr, device="cpu"), Sr, Bs)
    many = build_device_route_program(make_mesh(Sr, devices=blocks(K)),
                                      Sr, Bs)
    dropped = 0
    for seed, skew in ((Sr + K, False), (Sr + K + 50, True)):
        jb, _ = flat_batch(Sr, Bs, layout, seed, skew=skew)
        blob = jax_blob(jb, layout)
        want, wdrop = one(blob)
        got, gdrop = many(blob)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(gdrop.numpy(), wdrop.numpy())
        dropped += int(gdrop.sum())
        if not skew and host_fits_device_route(
                np.asarray(jb.device_idx) & (2 ** 22 - 1), jb.valid, Sr, Bs,
                route_lane_capacity(Bs, Sr)):
            expect, over = ShardRouter(Sr, Bs).route_blob(blob)
            assert len(over) == 0
            np.testing.assert_array_equal(got.numpy(), expect)
    assert dropped > 0


# -- the engine over blocks ----------------------------------------------------

def step_all(jeng, engines, cols, what, shift_ms=0):
    """One step of the JAX engine and of every port engine on the same
    batch: each port engine equal to the JAX engine (`step_both`'s
    checks), and every engine's outputs equal to the first's, bits."""
    jv, jout = jeng.submit(pack(jeng, cols, shift_ms))
    steps = [eng.submit(pack(eng, cols, shift_ms)) for eng in engines]
    for eng, (view, out) in zip(engines, steps):
        where = f"{what} K={eng.n_cards}"
        assert_outputs_equal(jout, out, where)
        assert_outputs_bits(steps[0][1], out, where)
    try:
        want = [_alert_key(a) for a in jeng.materialize_alerts(jv, jout)]
    except IndexError:
        # a row past the capacity fired and names no token: the reference
        # raises (ROADMAP queue C), and so does every port engine
        want = None
    for eng, (view, out) in zip(engines, steps):
        where = f"{what} K={eng.n_cards}"
        if want is None:
            with pytest.raises(IndexError):
                eng.materialize_alerts(view, out)
        else:
            got = eng.materialize_alerts(view, out)
            assert [_alert_key(a) for a in got] == want, where
    fires = jeng.take_command_fires()
    for eng in engines:
        assert eng.take_command_fires() == fires, what
        assert_engines_equal(jeng, eng, f"{what} K={eng.n_cards}")
    return want


@pytest.mark.parametrize("device_routing", [False, True])
def test_engine_over_blocks_bit_equal_to_jax_and_one_block(world,
                                                           device_routing):
    """S = 8 over K in {1, 2, 4, 8} blocks beside the JAX engine over 8
    devices, every wire layout, rows past the device capacity (step 4):
    every block engine equals the JAX engine and the one-block engine at
    every step, and the presence sweep reports the same devices."""
    tag = f"mc-{int(device_routing)}"
    jeng, one = sharded_pair(world, S, device_routing, f"{tag}-1")
    engines = [one] + [port_engine(world, K, device_routing, f"{tag}-{K}",
                                   jeng.packer.epoch_base_ms)
                       for K in (2, 4, 8)]
    for i, variant in enumerate(VARIANTS * 2):
        cols = spread_cols(10 * S + i, variant, S, oob=(i == 4))
        alerts = step_all(jeng, engines, cols, f"step {i}",
                          shift_ms=100 * i)
        assert alerts or i == 4
    for eng in engines:
        assert eng.device_route_steps == jeng.device_route_steps
        assert (eng.device_route_steps > 0) == device_routing
    sweep = jeng.presence_sweep()
    for eng in engines:
        assert eng.presence_sweep() == sweep, eng.n_cards
        assert_engines_equal(jeng, eng, f"swept K={eng.n_cards}")
    token = world["treg"].devices.token_of(17)
    for eng in engines[1:]:
        assert eng.get_device_state(token) == one.get_device_state(token)


def test_stateful_world_over_two_blocks(world):
    """Rule programs, anomaly models and actuation policies on two blocks,
    device-routed, beside the JAX engine and the one-block engine."""
    jeng, one = sharded_pair(world, S, True, "mc-stateful-1", **BUCKETS)
    two = port_engine(world, 2, True, "mc-stateful-2",
                      jeng.packer.epoch_base_ms, **BUCKETS)
    install((jeng, one, two), PROGRAMS, MODELS, POLICIES)
    for i, variant in enumerate(("compact", "packed", "full", "compact")):
        step_all(jeng, [one, two], spread_cols(300 + i, variant, S),
                 f"stateful step {i}", shift_ms=1000 * i)
    assert sum(c["fires"] for c in two.rule_program_counters().values())


# -- checkpoints across card counts --------------------------------------------

def port_blocks(K, epoch_base_ms, classes=S):
    """tests/test_torch_sharded_checkpoint.py's port engine (every family
    installed) over K CPU blocks."""
    import dataclasses

    from sitewhere_tpu_torch import convert
    from test_torch_checkpoint import _SEQ, _setup, jax_registry
    from test_torch_sharded_checkpoint import N, SHARDED_KW

    jreg = jax_registry(N, shard_classes=classes)
    reg = convert.registry_from_snapshot(
        dataclasses.asdict(jreg.snapshot()), jreg.devices.snapshot(),
        jreg.tenants.snapshot(),
        device_type_tokens=jreg.device_types.snapshot(),
        zone_tokens=jreg.zones_interner.snapshot(),
        area_tokens=jreg.areas.snapshot(),
        assignment_tokens=jreg.assignments.snapshot(),
        shard_classes=classes)
    eng = ShardedPipelineEngine(
        reg, mesh=make_mesh(S, devices=blocks(K)),
        per_shard_batch=B, name=f"mc-ckpt-{K}-{next(_SEQ)}", **SHARDED_KW)
    eng.packer.epoch_base_ms = epoch_base_ms
    return _setup(eng, tengine, stateful=True)


def test_checkpoints_cross_card_counts_and_packages(tmp_path):
    """A save on 2 blocks restores on 1 and 4 blocks and into the JAX
    engine over 8 devices; a JAX save restores on 2 blocks. Every restored
    engine equals its source, and all continue equal."""
    from sitewhere_tpu.persist import checkpoint as jckpt
    from sitewhere_tpu_torch.persist import checkpoint as tckpt
    from test_torch_checkpoint import CUT, assert_same_engines, step
    from test_torch_sharded_checkpoint import continue_equal, jax_sharded

    epoch = 1_700_000_000_000
    src = port_blocks(2, epoch)
    for k in range(CUT):
        step(src, 860 + k, k)
    path = tckpt.PipelineCheckpointer(str(tmp_path / "two")).save(src)
    one, four = port_blocks(1, 0), port_blocks(4, 0)
    for eng in (one, four):
        tckpt.PipelineCheckpointer(str(tmp_path / "two")).restore(eng, path)
        assert eng.packer.epoch_base_ms == epoch
        assert_same_engines(src, eng, f"K={eng.n_cards} restored")
    ref = jax_sharded(S, classes=S)
    jckpt.PipelineCheckpointer(str(tmp_path / "two")).restore(ref, path)
    assert_same_engines(ref, src, "JAX restored")
    assert continue_equal([ref, src, one, four], 860) > 0
    for eng in (src, one, four):
        assert_same_engines(ref, eng, f"K={eng.n_cards} continued")
    # and back: the JAX engine's save onto two blocks
    path = jckpt.PipelineCheckpointer(str(tmp_path / "jax")).save(ref)
    back = port_blocks(2, 0)
    tckpt.PipelineCheckpointer(str(tmp_path / "jax")).restore(back, path)
    assert_same_engines(ref, back, "K=2 from JAX")
    assert continue_equal([ref, back], 880, start=CUT + 3) > 0
    assert_same_engines(ref, back, "K=2 from JAX continued")


# -- the captured step over blocks ---------------------------------------------

class _EagerGraph:
    """A stand-in for a CUDA graph on the CPU: replay runs the captured
    function again into the outputs it returned at capture."""

    def __init__(self, fn, result):
        self.fn, self.result = fn, result

    def replay(self):
        for old, new in zip(self.result, self.fn()):
            if old is not None:
                old.copy_(new)

    def pool(self):
        return None


def _eager_capture_graph(fn, device):
    result = fn()
    return _EagerGraph(fn, result), result, {}


def _eager_capture_step(per_card):
    from sitewhere_tpu_torch.pipeline.graph import CapturedStep, OutputArena

    def capture(step_fn, blob_like, outputs_like, static_blob=None):
        static = (torch.empty_like(blob_like) if static_blob is None
                  else static_blob)
        arena = OutputArena(outputs_like)
        out_flat = torch.empty(arena.nbytes, dtype=torch.uint8)
        graph = _EagerGraph(lambda: [arena.store(out_flat,
                                                 step_fn(static))], [None])
        return CapturedStep(graph, static, arena, out_flat,
                            {"points_in_zones": per_card}, None)

    return capture


@pytest.mark.parametrize("K", [2, 4])
def test_captured_steps_over_blocks_replay_what_eager_steps_do(
        world, monkeypatch, K):
    """With captures stood in for on the CPU (each replay runs the captured
    function again on the static buffers), the K-block engine's replays
    (route prologues, the exchange into the received lanes, the bodies,
    the outputs gathered on the first block) equal the one-block engine
    step by step on both routes and every layout; one capture a block a
    key, and each block's replays counted on its own card."""
    import sitewhere_tpu_torch.parallel.engine as engine_mod

    monkeypatch.setattr(engine_mod, "capture_graph", _eager_capture_graph)
    monkeypatch.setattr(engine_mod, "capture_step",
                        _eager_capture_step(S // K))
    jeng, one = sharded_pair(world, S, True, f"mc-graph-1-{K}")
    many = port_engine(world, K, True, f"mc-graph-{K}",
                       jeng.packer.epoch_base_ms)
    monkeypatch.setattr(many, "_captures", lambda: True)
    steps = 0
    for routing in (True, False):
        for eng in (one, many):
            eng.device_routing = routing
        for i, variant in enumerate(VARIANTS * 2):
            cols = spread_cols(40 * K + i, variant, S)
            want_view, want = one.submit(pack(one, cols, 100 * steps))
            view, got = many.submit(pack(many, cols, 100 * steps))
            assert_outputs_bits(want, got, f"routing={routing} step {i}")
            assert list(map(_alert_key, many.materialize_alerts(view, got))) \
                == list(map(_alert_key, one.materialize_alerts(want_view,
                                                               want)))
            steps += 1
        assert_dataclass_bits_equal(one.canonical_state(),
                                    many.canonical_state(), "state")
    keys = len(many._graphs)
    assert keys == 2 * len(VARIANTS)
    assert many.graph_captures == K * keys
    assert many.card_graph_captures == [keys] * K
    assert [c["points_in_zones"] for c in many.card_kernel_launches] == \
        [(steps - keys) * S // K] * K
    flight = [r for r in many.flight.export(last_n=16)["records"]
              if r["engine"] == many.name][-1]
    assert [c["block"] for c in flight["cards"]] == list(range(K))
    assert {c["step"] for c in flight["cards"]} == {"replay"}


# -- the backlog, the landing and the ledger over blocks ------------------------

def test_skewed_batch_spills_and_drains_over_two_blocks(world):
    """A batch whose rows all own one shard overflows the device route's
    lanes on two blocks as on one: a host fallback, the same requeued
    backlog, folded by the next submit and drained, equal to the JAX
    engine throughout."""
    from test_torch_pipeline import make_cols

    jeng, one = sharded_pair(world, S, True, "mc-skew-1")
    two = port_engine(world, 2, True, "mc-skew-2", jeng.packer.epoch_base_ms)
    skew = make_cols(71, "compact", n=B)
    skew["device_idx"] = np.full(B, 8 + S * 3, np.int32)
    skew["device_idx"][::7] = 5 * S + 1
    step_all(jeng, [one, two], skew, "skew")
    assert two.device_route_fallbacks == 1 and two.pending_overflow > 0
    step_all(jeng, [one, two], spread_cols(72, "packed", S), "after skew",
             shift_ms=500)
    for eng in (jeng, one, two):
        eng.drain_pending()
    for eng in (one, two):
        assert_engines_equal(jeng, eng, f"drained K={eng.n_cards}")
        assert [_alert_key(a) for a in eng._pending_alerts] == \
            [_alert_key(a) for a in jeng._pending_alerts]


def test_feeders_land_on_two_blocks(tmp_path, monkeypatch):
    """A JAX feeder worker lands the reference's frames on the port's
    sharded service whose engine holds two blocks: its canonical state
    equals an inline JAX sharded engine fed the same frames."""
    import sitewhere_tpu.feeders as jfeeders
    import sitewhere_tpu.sources.fastlane as jfast
    import sitewhere_tpu_torch.parallel as parallel
    import test_feeders as jtf
    import test_torch_feeders as tf

    monkeypatch.setattr(
        parallel, "make_mesh",
        lambda n_shards=None, device="cuda", devices=None: make_mesh(
            n_shards, devices=("cpu", "cpu")))
    frames = jtf._stream(128, seed=9)
    inline = jtf._world_sharded()
    for batch in jfast.FastWireIngest(inline.packer).ingest(
            jtf._wire(frames)).batches:
        inline.submit(batch)
    inline.drain_pending()
    remote = tf._world_sharded()
    assert remote.n_cards == 2
    lb = tf._Loopback(remote, tmp_path / "port")
    try:
        lb.publish(frames)
        worker = jfeeders.FeederWorker("127.0.0.1", lb.server.port, "w0",
                                       epoch=1)
        assert tf._drain(worker) == 128
        worker.stop()
        remote.drain_pending()
    finally:
        lb.close()
    want, got = tf._state(inline, "jax"), tf._state(remote, "port")
    assert sorted(got) == sorted(want)
    for name in want:
        assert_bits_equal(want[name], got[name], name)


def test_memory_ledger_keeps_each_card(world):
    """The ledger lists each block's own tables; their sum is the
    engine's."""
    from sitewhere_tpu_torch.runtime import hbmledger

    eng = port_engine(world, 4, True, "mc-ledger", 0, **BUCKETS)
    install((eng,), PROGRAMS, MODELS, POLICIES)
    eng.submit(pack(eng, spread_cols(9, "compact", S)))
    out = hbmledger.ledger(eng)
    assert [c["card"] for c in out["cards"]] == ["cpu"] * 4
    for table in ("device_state", "rule_state", "model_state",
                  "rule_tables", "model_weights", "registry_params",
                  "staging_ring"):
        per_card = [c["tables"][table] for c in out["cards"]]
        assert sum(per_card) == out["tables"][table] > 0, table
        assert len(set(per_card)) == 1, table
    # the step was staged through one ring slot: its fixed buffers, one a
    # block, hold the whole [S, WIRE_ROWS, B] blob between them
    assert out["tables"]["staging_ring"] == \
        S * WIRE_ROWS * eng.batch_size * 4
