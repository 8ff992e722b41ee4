"""The comparison fails a broken timed path: the harness's look for a card
skipped, the rest of a run driven on the CPU with the port's step broken
underneath, `correct` comes out false. One case for each fault a cell can
have (no cell spans cards, so there is no exchange to leave out), and the
control: the reference in bfloat16 in the port's place."""

import dataclasses

import pytest
import torch

import sitewhere_tpu_torch.pipeline.engine as engine_mod
from swbench.tests.conftest import CELLS, tiny_spec

STEP = engine_mod.process_batch


def _clone(group):
    if group is None or not dataclasses.is_dataclass(group):
        return group
    return dataclasses.replace(group, **{
        f.name: getattr(group, f.name).clone()
        for f in dataclasses.fields(group)})


def state_unchanged(params, state, rule, model, act, batch, **kw):
    """The step computes its outputs but returns every group as it was."""
    out = STEP(params, _clone(state), _clone(rule), _clone(model),
               _clone(act), batch, **kw)
    return (state, rule, model, act, out[4])


def half_batch(params, state, rule, model, act, batch, **kw):
    """The second half of the batch left out."""
    B = batch.valid.shape[0]
    valid = batch.valid.clone()
    valid[B // 2:] = False
    return STEP(params, state, rule, model, act,
                dataclasses.replace(batch, valid=valid), **kw)


def answer_altered(params, state, rule, model, act, batch, **kw):
    """The first fired row's answer altered where the lanes are produced:
    the level (or model slot) of whichever family fired there."""
    *groups, out = STEP(params, state, rule, model, act, batch, **kw)
    lanes = out.alert_lanes.clone()
    lanes[2, 0] ^= 1 | (1 << 4) | (1 << 8) | (1 << 27)
    return (*groups, out.replace(alert_lanes=lanes))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(workload, fault, cpu, monkeypatch):
    from swbench.run import run_cell

    monkeypatch.setattr(engine_mod, "process_batch", FAULTS[fault])
    result = run_cell(tiny_spec(workload), 4242, 0.5, False, cpu)
    assert not result["correct"], (fault, result["_checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, cpu):
    from swbench.check import verdict
    from swbench.control import control_numbers

    n = control_numbers(tiny_spec(workload), 77, 12, cpu)
    assert not verdict(n), n
