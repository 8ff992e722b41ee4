"""Keyed per-device reductions: last-write-wins, scatter-max, counts.

Counterpart of `sitewhere_tpu/ops/segments.py`: a whole batch folds into
device-indexed state tensors with a stable sort, boundary detection and
unique-index writes, so the result does not depend on the order in which
the card applies writes.

Out-of-range keys (>= num_segments) are dropped, as XLA drops out-of-bounds
scatter updates in the reference: every write goes through a
[num_segments + 1] buffer whose last (pad) row takes the invalid and
out-of-range rows and is sliced off. Only that pad row ever receives more
than one write.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_NEG = -(2 ** 31)


def _pad_target(keys: torch.Tensor, valid: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """int64 write target: the key, or the pad row for invalid and
    out-of-range rows."""
    keep = valid & (keys < num_segments)
    return torch.where(keep, keys, num_segments).long()


def _last_row_selector(keys: torch.Tensor, ts: torch.Tensor,
                       valid: torch.Tensor, num_segments: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort rows by (key, ts) with invalid rows keyed to `num_segments`, and
    mark each sorted row that is the LAST of its key segment.

    Returns (order, target): the sorting permutation and, per sorted row,
    its key if it is the last row of an in-range segment, else the pad row
    `num_segments`. The order is that of the reference's
    `lexsort((ts, key))`: one stable sort on the int64 composite
    (key << 32) | (ts + 2^31), ties kept in batch order."""
    sort_key = torch.where(valid, keys, num_segments).long()
    composite = (sort_key << 32) | (ts.long() + 2 ** 31)
    _, order = torch.sort(composite, stable=True)
    sorted_keys = sort_key[order]
    next_keys = torch.cat([sorted_keys[1:], sorted_keys.new_full((1,), -1)])
    is_last = sorted_keys != next_keys
    target = torch.where(is_last & (sorted_keys < num_segments),
                         sorted_keys, num_segments)
    return order, target


def last_by_key(keys: torch.Tensor, ts: torch.Tensor, valid: torch.Tensor,
                num_segments: int, state_ts: torch.Tensor,
                states: Sequence[torch.Tensor],
                values: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Fold a batch into last-value-wins state tensors.

    For each key k among the valid rows, pick the row with the greatest ts
    (equal ts: the later batch position wins); if that ts >= state_ts[k],
    write each values[i] row into states[i][k] and update state_ts[k].
    Returns new tensors (new_state_ts, tuple(new_states)); the inputs are
    not modified."""
    order, target = _last_row_selector(keys, ts, valid, num_segments)
    sorted_ts = ts[order]
    n = num_segments
    candidate_ts = ts.new_zeros(n + 1).index_put_((target,), sorted_ts)[:n]
    touched = torch.zeros(n + 1, dtype=torch.bool, device=ts.device) \
        .index_put_((target,), torch.ones_like(target, dtype=torch.bool))[:n]
    newer = touched & (candidate_ts >= state_ts)
    new_state_ts = torch.where(newer, candidate_ts, state_ts)

    new_states = []
    for state, value in zip(states, values):
        candidate = state.new_zeros((n + 1,) + tuple(state.shape[1:])) \
            .index_put_((target,), value[order])[:n]
        mask = newer.reshape((n,) + (1,) * (state.dim() - 1))
        new_states.append(torch.where(mask, candidate, state))
    return new_state_ts, tuple(new_states)


def batch_device_order(dev: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation grouping batch rows by device, plus its inverse
    (`inv[order[i]] == i`). The stateful stages gather their state rows at
    `dev[order]` so all rows of a device read adjacent state, and un-sort
    their per-row outputs with `out[inv]`. Stability keeps batch order
    inside each device's segment, as the reference's `lexsort((rows, dev))`
    does."""
    _, order = torch.sort(dev, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return order, inv


def scatter_max_by_key(keys: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor, num_segments: int,
                       state: torch.Tensor) -> torch.Tensor:
    """state[k] = max(state[k], max over valid batch rows with key k)."""
    target = _pad_target(keys, valid, num_segments)
    padded = torch.cat([state, state.new_full((1,), _NEG)])
    return padded.scatter_reduce(0, target, values, "amax",
                                 include_self=True)[:num_segments]


def count_by_key(keys: torch.Tensor, valid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-key event counts (int32 [num_segments]) over the valid rows."""
    target = _pad_target(keys, valid, num_segments)
    return torch.zeros(num_segments + 1, dtype=torch.int32,
                       device=keys.device) \
        .index_add_(0, target, valid.to(torch.int32))[:num_segments]
