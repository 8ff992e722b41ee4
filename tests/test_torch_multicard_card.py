"""The shard axis over several cards, on the card (JAX-free; `cuda` marker).

`make_mesh(8)` over the visible cards, and the sharded engine over K card
blocks (every visible card when there are two or more, else two blocks on
cuda:0) beside the one-card engine over chip_smoke.py's world at a small
size, on both routes and every wire layout the traffic takes: each step's
outputs, every block of every state group and the alerts bit-equal, one
capture a card a key, and B1 launched S/K times a card a replay (each
card's launches as its wrapper and the engine count them). On the
card: `python -m pytest --noconftest -m cuda tests/test_torch_multicard_card.py`.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import _alert_keys, build_world, synthetic_batch
from sitewhere_tpu_torch.parallel import live_mesh
from sitewhere_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda

S = 8
SMALL = dict(max_devices=512, n_registered=400, n_zones=24, n_verts=8,
             batch=256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a mesh over cards, CUDA graphs)")
    return torch.device("cuda", 0)


def test_make_mesh_spreads_over_every_visible_card(card):
    n = torch.cuda.device_count()
    K = min(S, n)
    if S % K:
        with pytest.raises(ValueError, match=f"{n} visible cards"):
            make_mesh(S)
        return
    mesh = make_mesh(S)
    assert mesh.cards == tuple(torch.device("cuda", k) for k in range(K))
    assert [mesh.card_of_shard(s) for s in range(S)] == \
        [s // (S // K) for s in range(S)]
    assert [d.index for d in mesh.devices] == [s // (S // K)
                                               for s in range(S)]
    assert make_mesh(S, device="cuda:0").cards == (card,)
    assert (live_mesh() is None) == (n < 2)


def test_engine_over_cards_equals_the_one_card_engine(card):
    n = torch.cuda.device_count()
    cards = (tuple(torch.device("cuda", k) for k in range(min(S, n)))
             if n >= 2 and S % min(S, n) == 0 else (card, card))
    one = build_world(card, "auto", shards=S, **SMALL)
    many = build_world(card, "auto", one.packer.epoch_base_ms, shards=S,
                       mesh=make_mesh(S, devices=cards), **SMALL)
    counts = chip_smoke.CardLaunches(many)
    steps = 0
    for routing in (True, False):
        for eng in (one, many):
            eng.device_routing = routing
        for i in range(5):
            # 3/4 of S x B: a uniform flat batch of exactly S x B spills
            batch = synthetic_batch(one.packer, SMALL["n_registered"],
                                    SMALL["batch"] * 3 // 4,
                                    chip_smoke.SEED + 60 + steps,
                                    t_off_ms=1000 * steps)
            with counts.window():
                got = many.submit_routed(batch)
            want = one.submit_routed(batch)
            chip_smoke._outputs_bits_equal(want[1], got[1],
                                           f"routing={routing} step {i}")
            assert sorted(_alert_keys(many.materialize_alerts(*got))) == \
                sorted(_alert_keys(one.materialize_alerts(*want)))
            chip_smoke.blocks_equal(one, many, f"step {steps}")
            steps += 1
    assert many.device_route_steps > 0
    keys = len(many._graphs)
    assert many.card_graph_captures == [keys] * len(cards)
    per = S // len(cards)
    assert [c["points_in_zones"] for c in many.card_kernel_launches] == \
        [per * (steps - keys)] * len(cards)
    # measured on each card: the wrapper's eager launches plus the replays
    counts.check("points_in_zones", per, steps, "B1 over cards")
    chip_smoke.assert_tree_bits_equal(one.canonical_state(),
                                      many.canonical_state(), "state")
