"""The choice of the multi-process data plane's collectives backend
(parallel/distributed.py `choose_collectives`), on the CPU.

The choice is a pure function of every process's card identities
(`card_identity`: a card's UUID, or "cpu"), gathered over the world in
rank order: NCCL when every process holds CUDA cards only and no card is
held by two processes, else gloo. Two processes over gloo then show that
`make_global_mesh` gathers the identities and that both processes reach the
same answer: a card shared between them (the same fake UUID on both) gives
gloo; distinct cards choose NCCL, and on this build, which has no NCCL,
both raise instead of falling back to gloo; a layout one process refuses,
or a card it cannot read, raises on both, naming that process, instead of
leaving its peer in the gather.
"""

import itertools
import json

import pytest
import torch

from sitewhere_tpu_torch.parallel import distributed as tdist
from test_torch_multiprocess_pipeline import _free_port, run_two

CASES = [
    # (identities of each process's cards, in rank order; the answer)
    ([["GPU-a"], ["GPU-b"]], "nccl"),
    ([["GPU-a", "GPU-b"], ["GPU-c", "GPU-d"]], "nccl"),
    ([["GPU-a", "GPU-a"], ["GPU-b", "GPU-b"]], "nccl"),   # blocks of a card
    ([["GPU-a"], ["GPU-b"], ["GPU-c"], ["GPU-d"]], "nccl"),
    ([["GPU-a"], ["GPU-a"]], "gloo"),                      # one shared card
    ([["GPU-a", "GPU-b"], ["GPU-b", "GPU-c"]], "gloo"),
    ([["GPU-a"], ["GPU-b"], ["GPU-a"]], "gloo"),
    ([["cpu"], ["cpu"]], "gloo"),
    ([["cpu", "cpu"], ["GPU-b"]], "gloo"),
    ([["GPU-a"], ["cpu"]], "gloo"),
    ([["GPU-a", "cpu"], ["GPU-b"]], "gloo"),
]


@pytest.mark.parametrize("identities,want", CASES)
def test_choice_from_the_gathered_card_identities(identities, want):
    assert tdist.choose_collectives(identities) == want


@pytest.mark.parametrize("identities,want", CASES)
def test_every_rank_order_gives_the_same_choice(identities, want):
    """The answer depends on which cards are held by which processes, not
    on whose list comes first."""
    for order in itertools.permutations(identities):
        assert tdist.choose_collectives(list(order)) == want


def test_nccl_chosen_without_nccl_raises(monkeypatch):
    """Where NCCL is the choice but torch has none, the groups refuse
    (never gloo in its place)."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tdist._groups("nccl", torch.device("cuda", 0))


def test_card_identity_of_the_cpu():
    assert tdist.card_identity(torch.device("cpu")) == "cpu"


_CHILD = r"""
import json, sys
pid = int(sys.argv[1]); coord = sys.argv[2]; path = sys.argv[3] + str(pid)
import torch
from sitewhere_tpu_torch.parallel import distributed as tdist

assert tdist.initialize(coord, num_processes=2, process_id=pid) is True
out = {}
# the CPU: gloo
out["cpu"] = tdist.make_global_mesh(n_shards=4, device="cpu").collectives
# one card shared by both processes (the same UUID): gloo
tdist.card_identity = lambda card: "GPU-shared"
out["shared"] = tdist.make_global_mesh(n_shards=4,
                                       device="cpu").collectives
# a card each: NCCL is the choice; this build has none, so both raise
tdist.card_identity = lambda card: f"GPU-{pid}"
try:
    tdist.make_global_mesh(n_shards=4, device="cpu")
    out["distinct"] = "built"
except RuntimeError as exc:
    out["distinct"] = str(exc)
# process 1 refuses its layout (3 blocks for its 4 shards): both raise
tdist.card_identity = lambda card: "cpu"
try:
    tdist.make_global_mesh(n_shards=8, devices=["cpu"] * (2 + pid))
    out["refused"] = "built"
except ValueError as exc:
    out["refused"] = str(exc)
# process 0 cannot read its card (not a ValueError): both raise
def _unreadable(card):
    if pid == 0:
        raise RuntimeError("no card behind this index")
    return "cpu"
tdist.card_identity = _unreadable
try:
    tdist.make_global_mesh(n_shards=4, device="cpu")
    out["unreadable"] = "built"
except RuntimeError as exc:
    out["unreadable"] = str(exc)
tdist.card_identity = lambda card: "cpu"
# the world still pairs: a last mesh on both
out["after"] = tdist.make_global_mesh(n_shards=4, device="cpu").local_shards
with open(path + ".json", "w") as fh:
    json.dump(out, fh)
print(f"CHOICEOK {pid}", flush=True)
"""


def test_both_processes_reach_the_same_choice(tmp_path):
    outs = run_two(_CHILD, [f"127.0.0.1:{_free_port()}",
                            str(tmp_path / "host")], tmp_path)
    assert all(f"CHOICEOK {pid}" in outs[pid] for pid in range(2)), outs
    got = [json.load(open(tmp_path / f"host{pid}.json")) for pid in range(2)]
    for pid, out in enumerate(got):
        assert out["cpu"] == "gloo" and out["shared"] == "gloo"
        assert "NCCL" in out["distinct"] and "no NCCL" in out["distinct"]
        assert out["refused"].startswith("process 1:")
        assert "do not divide the 4 shards" in out["refused"]
        assert out["unreadable"] == "process 0: no card behind this index"
        assert out["after"] == [2 * pid, 2 * pid + 1]
    assert got[0]["distinct"] == got[1]["distinct"]
    assert got[0]["refused"] == got[1]["refused"]
