"""On-device shard routing: stable bucketing + one all_to_all, as tensor ops.

Counterpart of `sitewhere_tpu/ops/route.py`. The feeder ships the UNROUTED
flat wire blob `[rows, S*B]` (pack + one H2D, nothing else on the host),
split in S contiguous lane chunks, chunk s = lanes [s*B, (s+1)*B), and the
step routes it itself before the per-shard body (parallel/engine.py):

  1. bucket: each chunk's rows get their destination shard `dev % S` (the
     hash partition the host router and the congruent interner use;
     invalid rows go to bucket S) and their arrival-order rank within
     their (chunk, destination) bucket. All S chunks are ranked by ONE
     stable sort of the key `chunk * (S + 1) + dest` over the whole flat
     blob (ops/segments.py `bucket_ranks`), which gives each row the rank
     the reference's per-chunk sort gives it.
  2. exchange: rows scatter into `[rows, S_src, S_dst, C]` lanes (C =
     `route_lane_capacity`), and the reference's one `all_to_all` is a
     permute to `[S_dst, rows, S_src, C]`: every shard holds the buckets
     destined to it, source-major, i.e. in flat arrival order.
  3. compact: an exclusive prefix sum over the received candidates' valid
     bits packs them into each shard's `[rows, B]` routed blob.

Over K card blocks (parallel/mesh.py) the three steps split at the
exchange. Each card buckets the lane chunks of its own S/K shards
(`route_bucket`: one stable sort over its chunks gives each row the same
rank, since a rank is counted within one chunk) into destination-major
lanes `[S_dst, rows, S/K, C]`; card k copies the rows of card j's
destination shards to card j (`route_exchange`); each card compacts what it
received, `[K, S/K, rows, S/K, C]`, which read in card order is its rows of
the source-major permute (`route_compact`). The ts base of a packed blob
travels from card 0 to every card. One card is the case K = 1
(`device_route_chunk`).

Because the bucketing is stable and the exchange source-major, the routed
blob is bit-identical to the host arena router's (parallel/router.py) for
any batch that fits the lanes; `host_fits_device_route` (numpy, two
bincount passes) is the feeder's guard that spills a batch that would not
to the host route. Rows the kernel had to drop anyway are counted per
shard and ride the alert lanes' spare counts slot (`ROUTE_DROPPED_SLOT`).

Scatters with drop: JAX's `.at[...].set(..., mode="drop")` discards
out-of-range slots, torch raises on them, so each target gets one pad
column (slot `S*S*C` of the lanes, slot `B` of the routed blob) that is
sliced off. Several dropped rows may land in a pad column together; on the
card that write is nondeterministic, which is harmless only because the
pad is discarded. Kept slots are unique.

The packed 3-row variant carries its ts base by lane position in row 0 of
chunk 0 only: it is lifted there (the reference's scalar psum broadcasts
shard 0's value), the spare bits are stripped from every routed head, and
the base is re-embedded in each shard's blob after compaction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.ops.pack import (
    _BASE_LANES, _BASE_SHIFT, _VALID_SHIFT, WIRE_DEV_MAX, WIRE_ROWS_PACKED)
from sitewhere_tpu_torch.ops.segments import bucket_ranks

# low-29-bit mask: strips the packed variant's spare ts-base bits from a
# routed head (a no-op on classic 4/5-row blobs, whose spares are zero)
_SPARE_CLEAR = (1 << _BASE_SHIFT) - 1

# the on-device route's defensive drop count rides the alert lanes' counts
# row at this slot (slots 0..2 hold the fired/dropped/total alert counts,
# ops/compact.py; capacity >= MIN_ALERT_LANE_CAPACITY == 4 keeps it)
ROUTE_DROPPED_SLOT = 3


def route_lane_capacity(per_shard_batch: int, n_shards: int) -> int:
    """Per-(source, destination) lane capacity: 2x the uniform expectation
    ceil(B/S), capped at B."""
    if n_shards <= 1:
        return per_shard_batch
    return min(per_shard_batch, -(-2 * per_shard_batch // n_shards))


def host_fits_device_route(device_idx, valid, n_shards: int,
                           per_shard_batch: int, capacity: int) -> bool:
    """Host guard: can the device route carry this flat batch without
    dropping a row? True iff every (source chunk, destination) bucket fits
    its lane AND every destination's total fits the per-shard batch. Two
    bincount passes over the shard ids, no sort."""
    S, B, C = n_shards, per_shard_batch, capacity
    dev = np.asarray(device_idx)
    val = np.asarray(valid)
    n = dev.shape[0]
    shard = (dev % S).astype(np.int64)
    all_valid = bool(val.all())
    totals = np.zeros(S, np.int64)
    for c in range(0, n, B):
        sl = shard[c:c + B]
        if all_valid:
            counts = np.bincount(sl, minlength=S)
        else:
            counts = np.bincount(sl, weights=val[c:c + B],
                                 minlength=S).astype(np.int64)
        if int(counts.max(initial=0)) > C:
            return False
        totals += counts
    return int(totals.max(initial=0)) <= B


def _extract_ts_base(head: torch.Tensor) -> torch.Tensor:
    """The 32-bit ts base (int32 scalar) from row 0's spare bits, 3 per
    lane across lanes 0..10: the fields never overlap, so their int64 sum
    is their bitwise OR, and the int32 wrap of lane 10's shift rebuilds
    the base's two's complement exactly."""
    spare = (head[:_BASE_LANES] >> _BASE_SHIFT) & 7
    shifts = torch.arange(0, 3 * spare.shape[0], 3, dtype=torch.int32,
                          device=head.device)
    return (spare << shifts).sum(dtype=torch.int64).to(torch.int32)


def _embed_ts_base(row0: torch.Tensor, base: torch.Tensor) -> None:
    """OR the ts base into lanes 0..10 of row0 ([..., B], in place), as the
    host's uint32 embed does: LOGICAL shifts of the base (int64 of its
    unsigned value), so lane 10 carries exactly the top 2 bits."""
    lanes = row0[..., :_BASE_LANES]
    ubase = base.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 3 * lanes.shape[-1], 3, dtype=torch.int64,
                          device=row0.device)
    bits = ((ubase >> shifts) & 7).to(torch.int32)
    lanes |= bits << _BASE_SHIFT


def route_bucket(flat_blob: torch.Tensor, first_chunk: int, n_shards: int,
                 per_shard_batch: int, capacity: int):
    """Steps 1 and 2's first half on one card: the lane chunks `[rows,
    n*B]` of the n source shards `first_chunk ..` bucketed into lanes
    destination-major, `[S_dst, rows, n, C]` (the block for destination
    card j is one contiguous range), with each source chunk's lane
    overflow `[n]`. Returns (lanes, dropped, ts base): the base (int32
    scalar) only where chunk 0 of a packed blob is among the chunks, else
    None."""
    S, B, C = n_shards, per_shard_batch, capacity
    rows, width = flat_blob.shape
    if width % B:
        raise ValueError(f"lane chunks of {width} lanes; the route takes "
                         f"chunks of B = {B}")
    n = width // B
    device = flat_blob.device
    head = flat_blob[0]
    base = None
    if rows == WIRE_ROWS_PACKED and first_chunk == 0:
        # only chunk 0 carries the lane-embedded base (the reference's
        # psum of shard 0's value)
        base = _extract_ts_base(head[:B])
    valid = ((head >> _VALID_SHIFT) & 1) == 1
    dev = head & (WIRE_DEV_MAX - 1)
    dest = torch.where(valid, dev % S, S)              # S = padding bucket
    src = torch.arange(n * B, dtype=torch.int32, device=device) // B
    pos = bucket_ranks(src * (S + 1) + dest)
    keep = valid & (pos < C)
    n_lanes = n * S * C
    # source-major lane index: [n_src, S_dst, C] flattened; drops -> pad
    slot = torch.where(keep, (src * S + dest) * C + pos, n_lanes).long()
    # routed heads carry LOCAL device indices with spare bits stripped, as
    # the host router's head rewrite does
    local_head = ((head & _SPARE_CLEAR & ~(WIRE_DEV_MAX - 1)) | (dev // S))
    vals = torch.cat([local_head[None], flat_blob[1:]], dim=0)
    lanes = torch.zeros((rows, n_lanes + 1), dtype=torch.int32,
                        device=device)
    lanes.index_copy_(1, slot, vals)
    dropped = (valid & ~keep).to(torch.int32).reshape(n, B).sum(
        dim=1, dtype=torch.int32)
    # [rows, n_src, S_dst, C] -> [S_dst, rows, n_src, C]
    send = lanes[:, :n_lanes].reshape(rows, n, S, C).permute(2, 0, 1, 3) \
        .contiguous()
    return send, dropped, base


def route_compact(received: torch.Tensor, dropped: torch.Tensor,
                  base: Optional[torch.Tensor], per_shard_batch: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 3 on one card: the lanes its n destination shards received
    from the K source cards, `[K, n, rows, n_src, C]` in card order,
    compacted into the routed `[n, rows, B]` blob (the ts base re-embedded
    for a packed blob). `dropped` is the n shards' own lane overflow (each
    shard is its own source chunk); the result adds their receive
    overflow."""
    B = per_shard_batch
    K, n, rows = received.shape[:3]
    # the all_to_all's result: [n_dst, rows, S_src * C], source-major
    cand = received.permute(1, 2, 0, 3, 4).reshape(n, rows, -1)
    cvalid = (cand[:, 0] >> _VALID_SHIFT) & 1          # [n_dst, S*C]
    crank = torch.cumsum(cvalid, dim=1, dtype=torch.int32) - cvalid
    ckeep = (cvalid == 1) & (crank < B)
    cslot = torch.where(ckeep, crank, B).long()
    blob = torch.zeros((n, rows, B + 1), dtype=torch.int32,
                       device=received.device)
    blob.scatter_(2, cslot[:, None, :].expand(n, rows, cand.shape[-1]), cand)
    blob = blob[:, :, :B].contiguous()
    dropped = dropped + ((cvalid == 1) & ~ckeep).to(torch.int32).sum(
        dim=1, dtype=torch.int32)
    if base is not None:
        _embed_ts_base(blob[:, 0], base)
    return blob, dropped


def route_exchange(sends, bases, received, received_bases) -> None:
    """The all_to_all between K cards: card k's lanes for card j's
    destination shards (`sends[k]`, `[S_dst, rows, n_src, C]`, rows j*n ..
    (j+1)*n) copied into `received[j][k]`, and the ts base (`bases[0]`,
    chunk 0's, or None) into every `received_bases[j]`. Each copy is
    contiguous; a copy between two cards is ordered by PyTorch against the
    current streams of both (events on the sender's and the receiver's
    streams)."""
    K = len(sends)
    n = sends[0].shape[0] // K
    for j in range(K):
        for k in range(K):
            received[j][k].copy_(sends[k][j * n:(j + 1) * n],
                                 non_blocking=True)
        if bases[0] is not None:
            received_bases[j].copy_(bases[0], non_blocking=True)


def device_route_chunk(flat_blob: torch.Tensor, n_shards: int,
                       per_shard_batch: int, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route the stacked flat wire blob `[rows, S*B]` (chunk s = lanes
    [s*B, (s+1)*B)) to its owner shards on one card. Returns (routed `[S,
    rows, B]` int32 blob, int32 `[S]` rows each shard had to drop: its
    chunk's lane overflow plus its own receive overflow). The blob is
    bit-identical to the host arena router's whenever nothing dropped."""
    S, B = n_shards, per_shard_batch
    if flat_blob.shape[1] != S * B:
        raise ValueError(f"flat blob has {flat_blob.shape[1]} lanes; the "
                         f"route takes S*B = {S * B}")
    send, dropped, base = route_bucket(flat_blob, 0, S, B, capacity)
    return route_compact(send[None], dropped, base, B)


def device_route_cards(parts, n_shards: int, per_shard_batch: int,
                       capacity: int):
    """The route over K card blocks: `parts[k]` is card k's lane chunks
    `[rows, S/K*B]` of the flat blob, on its card. Each card buckets its
    chunks, the lanes cross between the cards (`route_exchange`), each
    card compacts what it received. Returns the per-card (routed `[S/K,
    rows, B]` blob, dropped `[S/K]`), which equal `device_route_chunk`'s
    rows of that card bit for bit."""
    K = len(parts)
    n = n_shards // K
    sends, drops, bases = [], [], []
    for k, part in enumerate(parts):
        send, dropped, base = route_bucket(part, k * n, n_shards,
                                           per_shard_batch, capacity)
        sends.append(send)
        drops.append(dropped)
        bases.append(base)
    received = [torch.empty((K,) + tuple(sends[0][:n].shape),
                            dtype=torch.int32, device=part.device)
                for part in parts]
    received_bases = [None if bases[0] is None else
                      torch.empty((), dtype=torch.int32, device=part.device)
                      for part in parts]
    route_exchange(sends, bases, received, received_bases)
    return [route_compact(received[k], drops[k], received_bases[k],
                          per_shard_batch) for k in range(K)]


def build_device_route_program(mesh, n_shards: int, per_shard_batch: int,
                               capacity: Optional[int] = None):
    """The route alone over `mesh`: flat wire blob `[rows, S*B]` (numpy or
    a tensor) -> (routed `[S, rows, B]` tensor on the mesh's first card,
    per-shard dropped counts `[S]`). Over K cards each card takes its lane
    chunks and the blocks come back in shard order. The tests hold it
    against `ShardRouter.route_blob` bit for bit; the engine's step calls
    the pieces directly."""
    cap = capacity or route_lane_capacity(per_shard_batch, n_shards)
    cards = mesh.cards

    def route(flat_blob):
        blob = torch.as_tensor(np.asarray(flat_blob, np.int32)) \
            if not isinstance(flat_blob, torch.Tensor) else flat_blob
        if len(cards) == 1:
            return device_route_chunk(blob.to(cards[0]), n_shards,
                                      per_shard_batch, cap)
        width = blob.shape[1] // len(cards)
        parts = [blob[:, k * width:(k + 1) * width].contiguous().to(card)
                 for k, card in enumerate(cards)]
        routed = device_route_cards(parts, n_shards, per_shard_batch, cap)
        return (torch.cat([b.to(cards[0]) for b, _ in routed]),
                torch.cat([d.to(cards[0]) for _, d in routed]))

    return route
