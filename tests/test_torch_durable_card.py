"""Checkpoint restore into an engine that already stepped (on the card:
captured its CUDA graph), with the worlds of chip_smoke.py at a small size.

A source engine runs a few steps and saves; a target engine of the same
world first steps on other traffic (on the card its first step captures
the graph), then restores and continues beside the source: alerts, command
fires, every state group (f32 as bit patterns) and the counters stay
identical, and on the card the target takes no new capture — the restore
copied into the buffers its graph reads. On the CPU (no graphs) the same
sequence runs eagerly. The card cases are marked `cuda` and skip elsewhere
— run them with
`python -m pytest --noconftest -m cuda tests/test_torch_durable_card.py`.
This file imports no JAX. Tolerance: none.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import (
    build_stateful_world, build_world, compare_snapshots, stateful_snapshot,
    synthetic_batch)
from sitewhere_tpu_torch.persist.checkpoint import PipelineCheckpointer

SMALL = dict(max_devices=512, n_registered=400, n_zones=24, n_verts=8,
             batch=256)
EPOCH = 1_700_000_000_000


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the engine's captured steps)")
    return torch.device(name)


def _batches(engine, n, seed):
    return [synthetic_batch(engine.packer, SMALL["n_registered"],
                            SMALL["batch"], chip_smoke.SEED + seed + s,
                            mm_slots=(1, 2), t_off_ms=1000 * s)
            for s in range(n)]


def _step(engine, batch):
    out = engine.submit(batch)
    return (chip_smoke._alert_keys(engine.materialize_alerts(batch, out)),
            engine.take_command_fires())


@pytest.mark.parametrize("stateful", [False, True], ids=["main", "stateful"])
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_restore_into_a_stepped_engine_continues_bit_equal(device, stateful,
                                                           tmp_path):
    dev = _device(device)
    build = build_stateful_world if stateful else (
        lambda d, epoch, **kw: build_world(d, "auto", epoch, **kw))
    src = build(dev, EPOCH, **SMALL)
    batches = _batches(src, 6, 900)
    for batch in batches[:3]:
        _step(src, batch)
    ckpt = PipelineCheckpointer(str(tmp_path))
    ckpt.save(src)
    tgt = build(dev, EPOCH + 5, **SMALL)
    for batch in _batches(tgt, 2, 990):
        _step(tgt, batch)
    captures = tgt.graph_captures
    assert captures == (1 if device == "cuda" else 0)
    ckpt.restore(tgt)
    assert tgt.packer.epoch_base_ms == EPOCH
    compare_snapshots(stateful_snapshot(src), stateful_snapshot(tgt))
    fired = 0
    for batch in batches[3:]:
        want = _step(src, batch)
        assert _step(tgt, batch) == want
        fired += len(want[0]) + len(want[1])
    assert fired > 0
    compare_snapshots(stateful_snapshot(src), stateful_snapshot(tgt))
    assert tgt.graph_captures == captures
