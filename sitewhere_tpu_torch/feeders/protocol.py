"""Feeder <-> landing-host wire protocol (busnet subsystem ops).

Five ops, mounted on the landing host's BusServer via ``register_op``
(feeders/service.py):

``feeder_hello``
    Feeder bootstrap: the landing host describes the engine's packing
    contract (batch width, wire-variant policy, interner capacities and
    the packer's ``epoch_base_ms``) so a remote pack is bit-identical to
    an inline one, plus the frames topic and lease TTL.

``feeder_lease``
    Lease lifecycle against the landing host's LeaseTable: acquire / renew /
    release one source partition. A steal of a live lease requires a
    strictly higher epoch — the takeover path; grants out of a takeover
    are counted (`takeover.count`).

``feeder_journal`` / ``feeder_intern``
    The interner-delta replication protocol: a replica pulls the
    append-only token journal from its last position, and allocates NEW
    measurement/alert-type tokens authoritatively on the landing host (the
    only per-TOKEN — never per-event — round trip). Device tokens are
    lookup-only on both sides (unknown must stay 0).

``feeder_blob``
    One ready-to-stage wire blob: raw int32 bytes + shape, the partition
    offset extent it covers (the exactly-once watermark), the age
    sidecar in cross-process form (age-so-far entries, re-stamped at the
    receiver — perf_counter stamps never cross a process boundary raw),
    and the feeder's host-route guard verdict. Epoch-fenced per
    partition: the request carries ``fence=feeder:p<N>`` so a zombie
    feeder's blobs bounce off the raised floor after takeover.

Blobs travel as raw ``tobytes()`` payloads inside the existing
length-prefixed msgpack busnet frames — no new framing layer.

Consume-side ops (the built-in busnet poll / commit_at /
seek_committed) are not in this table but carry the same per-partition
fencing: ``consume_fences`` stamps them with ``[fence_key, epoch]``
pairs so a fenced-out zombie cannot move the shared server-side cursor
(records it silently skipped would otherwise be lost, not duplicated).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.runtime.eventage import AgeSidecar, sidecar_to_wire

# busnet op names (BusServer.register_op keys)
OP_HELLO = "feeder_hello"
OP_LEASE = "feeder_lease"
OP_JOURNAL = "feeder_journal"
OP_INTERN = "feeder_intern"
OP_BLOB = "feeder_blob"

# consumer group the fleet commits under: one group, partitions pinned
# explicitly per lease (busnet poll `partitions` override) — ownership
# follows the lease, not the TCP connection
FEEDER_GROUP = "feeder-fleet"


def feeder_fence_key(partition: int) -> str:
    """EpochFence resource for one source partition's write stream."""
    return f"feeder:p{int(partition)}"


def fence_key_partition(key: str) -> Optional[int]:
    """Inverse of feeder_fence_key: the partition a stale_epoch rejection
    names, or None for a non-feeder fence resource."""
    key = str(key)
    if not key.startswith("feeder:p"):
        return None
    try:
        return int(key[len("feeder:p"):])
    except ValueError:
        return None


def consume_fences(partitions: Sequence[int], epoch: int) -> List[list]:
    """Per-partition [fence_key, epoch] stamps for consume-side busnet
    ops (poll / commit_at / seek_committed). A fenced-out zombie feeder
    must bounce with stale_epoch BEFORE its request can move the shared
    server-side cursor: an unfenced zombie poll skips records it will
    never ship, and once the successor's later extents advance the landing host
    watermark those skipped records redeliver as false 'replays' —
    silent loss, not duplicates."""
    return [[feeder_fence_key(p), int(epoch)] for p in partitions]


def partition_resource(partition: int) -> str:
    """LeaseTable resource name for one source partition."""
    return f"feeder-partition-{int(partition)}"


def blob_message(blob: np.ndarray, *, n_events: int, partition: int,
                 seq: int, extent: Sequence[int], epoch: int,
                 fits_device_route: bool = True,
                 age: Optional[AgeSidecar] = None,
                 advance: bool = True, chunk: int = 0) -> dict:
    """Build the ``feeder_blob`` request body. ``extent`` is the
    [start, end) partition offset range the blob covers — the landing host
    host's replay watermark judges duplicates by it. A record too large
    for one batch ships as chunks: ``chunk`` is the 0-based index within
    the extent and ``advance=False`` marks every chunk but the last.
    The watermark only moves on the LAST chunk, but the landing host also
    remembers the highest applied (extent, chunk) of an in-progress
    record, so a replay after a mid-record shed/fence/crash dedupes the
    already-applied chunks instead of double-stepping them — chunking is
    deterministic (greedy record grouping + fixed batch width), so a
    re-pack of the same extent reproduces the same chunk boundaries."""
    blob = np.ascontiguousarray(blob, np.int32)
    return {
        "blob": blob.tobytes(),
        "rows": int(blob.shape[0]),
        "width": int(blob.shape[1]),
        "n_events": int(n_events),
        "partition": int(partition),
        "seq": int(seq),
        "extent": [int(extent[0]), int(extent[1])],
        "fits_device_route": bool(fits_device_route),
        "age": sidecar_to_wire(age),
        "advance": bool(advance),
        "chunk": int(chunk),
        "fence": feeder_fence_key(partition),
        "epoch": int(epoch),
    }


def count_hot_events(data: bytes) -> int:
    """Hot-event frame count of one bus record's payload — a header-only
    walk (8 bytes/frame), no payload decode. Lets the feeder group
    records into record-ALIGNED blobs (extent commits can never split a
    record) without decoding twice."""
    from sitewhere_tpu_torch.transport.wire import _HEADER, HOT_TYPES, MAGIC

    hot = {int(t) for t in HOT_TYPES}
    pos, n, count = 0, len(data), 0
    while pos + _HEADER.size <= n:
        magic, _version, mtype, length = _HEADER.unpack_from(data, pos)
        if magic != MAGIC:
            break
        if pos + _HEADER.size + length > n:
            break
        if mtype in hot:
            count += 1
        pos += _HEADER.size + length
    return count


def decode_blob(msg: dict) -> np.ndarray:
    """Reconstruct the wire blob from a ``feeder_blob`` request. The
    frombuffer view is read-only; staging copies it to the device (or
    the copy to the device), so no writable copy is made here."""
    rows, width = int(msg["rows"]), int(msg["width"])
    blob = np.frombuffer(msg["blob"], np.int32)
    if blob.size != rows * width:
        raise ValueError(
            f"blob payload {blob.size} int32s != shape [{rows}, {width}]")
    return blob.reshape(rows, width)


def lease_request(action: str, partition: int, owner: str, epoch: int,
                  ttl_s: Optional[float] = None) -> dict:
    req = {"action": str(action), "partition": int(partition),
           "owner": str(owner), "epoch": int(epoch)}
    if ttl_s is not None:
        req["ttl_s"] = float(ttl_s)
    return req


def partitions_of(leases: dict) -> List[int]:
    """Sorted partition list from a {partition: epoch} ownership map."""
    return sorted(int(p) for p in leases)
