"""The interner's replica journal, held against the JAX package's: the same
seeded sequence of intern, intern_batch, intern_offsets and restore (a
restore may carry the None gaps of a shard-congruent snapshot) gives the
same journal entries, the same journal_epoch and the same table in both
packages, and a replica of either package that replays the other's
journal in seeded chunks with apply_delta ends with the authoritative
table and the same lookups. Tolerance: none."""

import numpy as np
import pytest

from sitewhere_tpu.registry.interning import TokenInterner as JaxInterner
from sitewhere_tpu_torch import native
from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.registry.interning import TokenInterner

CAPACITY = 4096


def _ops(seed, n=60):
    """A seeded op sequence over a shared token pool (repeats included)."""
    rng = np.random.default_rng(seed)
    pool = [f"tok-{i}" for i in range(900)] + ["", "ünïcode", "a" * 300]
    out = []
    for _ in range(n):
        r = rng.random()
        toks = [pool[int(i)] for i in rng.integers(0, len(pool),
                                                   int(rng.integers(1, 40)))]
        if r < 0.3:
            out.append(("intern", toks[0]))
        elif r < 0.6:
            out.append(("intern_batch", toks))
        elif r < 0.9:
            out.append(("intern_offsets", toks, bool(rng.random() < 0.5)))
        else:
            # a snapshot of what is there, gaps punched in at random
            out.append(("restore", float(rng.uniform(0, 0.3)),
                        int(rng.integers(0, 1 << 30))))
    return out


def _run(interner, ops):
    for op in ops:
        if op[0] == "intern":
            interner.intern(op[1])
        elif op[0] == "intern_batch":
            interner.intern_batch(op[1])
        elif op[0] == "intern_offsets":
            buf, off = native.join_tokens(op[1])
            interner.intern_offsets(buf, off, skip_empty=op[2])
        else:
            snap = interner.snapshot()
            rng = np.random.default_rng(op[2])
            holes = rng.random(len(snap)) < op[1]
            interner.restore([None if (h and i > 0) else t
                              for i, (t, h) in enumerate(zip(snap, holes))])
    return interner


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_journal_equals_the_jax_interners(seed):
    ops = _ops(seed)
    jax = _run(JaxInterner(CAPACITY, "j"), ops)
    port = _run(TokenInterner(CAPACITY, "p"), ops)
    assert port.snapshot() == jax.snapshot()
    assert port.journal_epoch == jax.journal_epoch
    assert port.journal_epoch == sum(op[0] == "restore" for op in ops)
    assert port.journal_len() == jax.journal_len()
    for start in (0, 1, port.journal_len() // 2, port.journal_len()):
        assert port.journal_since(start) == jax.journal_since(start)


@pytest.mark.parametrize("source,replica", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_a_replica_replays_the_other_packages_journal(source, replica):
    """Replay in seeded chunks after every op, resyncing from 0 when the
    epoch moves (what feeders/replica.py does); the replica's table,
    journal and batched lookups end equal to the authoritative one's."""
    make = {"jax": JaxInterner, "port": TokenInterner}
    auth = make[source](CAPACITY, "auth")

    def fresh():
        # the port builds its native mirror at the first batched call:
        # build it first, so the applies go through the mirror too
        out = make[replica](CAPACITY, "rep")
        out.lookup_batch(["warm"])
        return out

    rep = fresh()
    rng = np.random.default_rng(9)
    epoch = auth.journal_epoch
    for op in _ops(5, n=80):
        _run(auth, [op])
        new_epoch, entries = auth.journal_since(rep.journal_len())
        if new_epoch != epoch:
            rep = fresh()
            epoch, entries = auth.journal_since(0)
        base = rep.journal_len()
        while entries:
            k = int(rng.integers(1, 50))
            rep.apply_delta(entries[:k], base)
            base, entries = base + len(entries[:k]), entries[k:]
    assert rep.snapshot() == auth.snapshot()
    assert rep.journal_since(0)[1] == auth.journal_since(0)[1]
    tokens = [t for t in auth.snapshot() if t] + ["never-seen", ""]
    np.testing.assert_array_equal(rep.lookup_batch(tokens),
                                  auth.lookup_batch(tokens))


def test_apply_delta_refuses_a_stale_base_and_a_conflict():
    auth = TokenInterner(64, "auth")
    auth.intern_batch(["a", "b", "c"])
    rep = TokenInterner(64, "rep")
    _, entries = auth.journal_since(0)
    with pytest.raises(SiteWhereError, match="resync required"):
        rep.apply_delta(entries, 1)
    rep.apply_delta(entries[:1], 0)
    with pytest.raises(SiteWhereError, match="conflict"):
        rep.apply_delta([(1, "zzz")], 1)
    with pytest.raises(SiteWhereError, match="gap at occupied"):
        rep.apply_delta([(1, None)], 1)


def test_apply_delta_fills_a_gap_in_place_through_the_mirror():
    """A shard-congruent journal (the reference's sharded engine) fills a
    gap slot later; the port's replica fills it in its native mirror."""
    rep = TokenInterner(64, "rep")
    rep.lookup_batch(["warm"])
    rep.apply_delta([(1, None), (2, "b"), (3, None)], 0)
    assert rep.lookup_batch(["a", "b"]).tolist() == [0, 2]
    rep.apply_delta([(1, "a")], 3)
    assert rep.lookup_batch(["a", "b", "c"]).tolist() == [1, 2, 0]
    assert rep.snapshot() == [None, "a", "b", None]
