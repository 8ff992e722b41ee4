"""Shard-congruent interning held against the JAX package's interner.

With `shard_classes=S` a token's index lies in its class `crc32(token) %
S`, so a sharded engine's ownership `idx % S` depends only on the token.
Both packages' interners are fed the same tokens, in bulk and one by one,
through gap fills, restores and replica journals; indices, snapshots (gaps
included), journals and lookups must be identical, and the registry mirror
(`RegistryTensors(shard_classes=S)`) must allocate as the reference's.
"""

import numpy as np
import pytest

from sitewhere_tpu_torch.registry.interning import TokenInterner
from sitewhere_tpu_torch.registry.tensors import RegistryTensors


def _pair(capacity=512, classes=8):
    from sitewhere_tpu.registry.interning import TokenInterner as JInterner

    return (JInterner(capacity, "devices", shard_classes=classes),
            TokenInterner(capacity, "devices", shard_classes=classes))


def _tokens(seed, n):
    rng = np.random.default_rng(seed)
    return [f"dev-{int(x)}-{i}" for i, x in
            enumerate(rng.integers(0, 10 ** 6, n))]


def _same(j, t):
    assert t.snapshot() == j.snapshot()
    assert t.journal_since(0) == j.journal_since(0)
    assert list(t.token_array()) == list(j.token_array())


@pytest.mark.parametrize("classes", [2, 8])
def test_same_indices_gaps_and_journal(classes):
    j, t = _pair(classes=classes)
    toks = _tokens(classes, 120)
    for tok in toks[:40]:
        assert t.intern(tok) == j.intern(tok)
    np.testing.assert_array_equal(t.intern_batch(toks[40:80]),
                                  j.intern_batch(toks[40:80]))
    from sitewhere_tpu_torch import native

    buf, off = native.join_tokens(toks[80:] + [""])
    np.testing.assert_array_equal(
        t.intern_offsets(buf, off, skip_empty=True),
        j.intern_offsets(buf, off, skip_empty=True))
    # gap slots journal as (idx, None) before their class fills them
    assert any(tok is None for _, tok in t.journal_since(0)[1])
    for i, tok in enumerate(t.snapshot()):
        if i and tok is not None:
            assert i % classes == t._class_of(tok)
    np.testing.assert_array_equal(t.lookup_batch(toks + ["nope"]),
                                  j.lookup_batch(toks + ["nope"]))
    _same(j, t)


def test_restore_replica_and_refusals():
    j, t = _pair()
    toks = _tokens(5, 60)
    for tok in toks[:30]:
        j.intern(tok)
    snap = j.snapshot()
    t.restore(snap)
    j2, _ = _pair()
    j2.restore(snap)
    # both resume every class past its restored maximum
    for tok in toks[30:]:
        assert t.intern(tok) == j2.intern(tok)
    _same(j2, t)
    # a replica replaying the journal packs the same indices
    _, replica = _pair()
    epoch, entries = t.journal_since(0)
    replica.apply_delta(entries, 0)
    assert replica.snapshot() == t.snapshot()
    assert replica.intern("late-token") == t.intern("late-token")
    # a sequential snapshot is not congruent: both refuse it
    seq = [None] + toks[:10]
    for interner in _pair():
        with pytest.raises(ValueError, match="not congruent"):
            interner.restore(seq)
    with pytest.raises(ValueError, match="shard_classes"):
        TokenInterner(8, "x", shard_classes=8)


def test_class_exhaustion_names_the_class():
    from sitewhere_tpu.errors import SiteWhereError as JError

    from sitewhere_tpu_torch.errors import SiteWhereError

    j, t = _pair(capacity=16, classes=4)
    jerr = terr = None
    for tok in _tokens(9, 40):
        try:
            j.intern(tok)
        except JError as exc:
            jerr = str(exc)
        try:
            t.intern(tok)
        except SiteWhereError as exc:
            terr = str(exc)
        assert (jerr is None) == (terr is None)
        if jerr:
            break
    assert terr == jerr and "congruence class" in terr


def test_registry_mirror_allocates_congruently():
    from sitewhere_tpu.registry.tensors import RegistryTensors as JReg

    jreg = JReg(max_devices=256, max_zones=4, max_zone_vertices=4,
                shard_classes=8)
    treg = RegistryTensors(max_devices=256, max_zones=4, max_zone_vertices=4,
                           shard_classes=8)
    for tok in _tokens(11, 50):
        assert treg.devices.intern(tok) == jreg.devices.intern(tok)
    assert treg.devices.shard_classes == 8
