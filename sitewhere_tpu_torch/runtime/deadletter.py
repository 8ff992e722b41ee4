"""Dead-letter operability: list / inspect / replay parked records.

Poison records park on `<topic>.dead-letter` after a consumer's retry
budget is exhausted (runtime/bus.py ConsumerHost, busnet
RemoteConsumerHost) and on `<topic>.misrouted` when cluster hosts disagree
on ownership (parallel/cluster.py). The reference makes reprocessing a
first-class pipeline input — `inbound-reprocess-events` is one of the
per-tenant topics (KafkaTopicNaming.java:48-69) that inbound processing
consumes alongside decoded events. This module is the operator surface
over that loop:

  list   -> every parked topic with its backlog (records past the replay
            cursor)
  read   -> inspect records (decoded preview when the value is the
            standard msgpack decoded-request envelope)
  replay -> republish parked records to their reprocess destination and
            advance the replay cursor (a committed consumer group on the
            dead-letter topic, so repeated replays take only NEW records)

The default replay destination: a parked `<decoded-events>.dead-letter`
record goes to the tenant's `inbound-reprocess-events` (consumed by
InboundProcessingService); anything else replays onto its base topic.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Optional

import msgpack

from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming

REPLAY_GROUP = "dead-letter-replay"
_PARKED_SUFFIXES = (".dead-letter", ".misrouted")


def _replay_backlog(bus: EventBus, topic_name: str) -> int:
    """Records past the replay cursor (committed REPLAY_GROUP offsets)."""
    consumer = bus.consumer(topic_name, REPLAY_GROUP)
    end = bus.topic(topic_name).end_offsets()
    return sum(max(0, int(e) - int(c))
               for e, c in zip(end, consumer.committed))


def list_parked_topics(bus: EventBus,
                       naming: TopicNaming) -> List[Dict]:
    """Every dead-letter / misrouted topic with totals + replay backlog.

    Unions in-memory topics with on-disk ones: after a restart, parked
    records sit in durable logs no live component has touched yet — the
    post-crash triage this tool exists for."""
    names = set(bus.topics()) | set(bus.persisted_topics())
    out = []
    for name in sorted(names):
        if not name.endswith(_PARKED_SUFFIXES):
            continue
        topic = bus.topic(name)
        total = sum(int(e) for e in topic.end_offsets())
        if total == 0:
            continue
        out.append({
            "topic": name,
            "records": total,
            "replayBacklog": _replay_backlog(bus, name),
            "replayTarget": default_replay_target(name, naming),
        })
    return out


def _tenant_of(topic_name: str, naming: TopicNaming) -> Optional[str]:
    """Tenant token of a per-tenant topic name, None for global topics.
    Layout (bus.py TopicNaming): `<product>.<instance>.tenant.<t>.<suffix>`."""
    prefix = naming._tenant("", "")  # "<product>.<instance>.tenant.."
    prefix = prefix[:-1]             # trailing "." of empty suffix
    if not topic_name.startswith(prefix):
        return None
    rest = topic_name[len(prefix):]
    tenant, _, _suffix = rest.partition(".")
    return tenant or None


def default_replay_target(parked_topic: str, naming: TopicNaming) -> str:
    """Where a parked record should re-enter the pipeline."""
    base = parked_topic
    for suffix in _PARKED_SUFFIXES:
        if base.endswith(suffix):
            base = base[:-len(suffix)]
            break
    tenant = _tenant_of(base, naming)
    if tenant is not None and base == naming.event_source_decoded_events(
            tenant):
        # the reference's reprocess loop: decoded-event poison re-enters
        # through the dedicated reprocess topic, not the live ingest topic
        return naming.inbound_reprocess_events(tenant)
    return base


def _preview(value: bytes) -> Dict:
    """Best-effort decode for inspection: the standard decoded-request
    envelope renders as JSON-ish; anything else as base64."""
    try:
        data = msgpack.unpackb(value, raw=False)
        if isinstance(data, dict):
            return {"kind": "decoded-request",
                    "deviceToken": data.get("deviceToken"),
                    "requestKind": data.get("kind"),
                    "sourceId": data.get("sourceId"),
                    "fwdFrom": data.get("fwdFrom")}
    except Exception:
        pass
    return {"kind": "opaque",
            "base64": base64.b64encode(value[:512]).decode()}


def read_parked_records(bus: EventBus, topic_name: str,
                        limit: int = 100) -> List[Dict]:
    """Inspect (without consuming) the oldest parked records still behind
    the replay cursor."""
    topic = bus.topic(topic_name)
    consumer = bus.consumer(topic_name, REPLAY_GROUP)
    out: List[Dict] = []
    for p, partition in enumerate(topic.partitions):
        start = max(int(consumer.committed[p]), partition.start_offset())
        for offset, key, value, ts in partition.read(
                start, max(0, limit - len(out))):
            out.append({
                "partition": p, "offset": int(offset),
                "key": key.decode(errors="replace"),
                "timestamp_ms": int(ts),
                "size": len(value),
                "preview": _preview(value),
            })
            if len(out) >= limit:
                return out
    return out


def replay_parked_records(bus: EventBus, naming: TopicNaming,
                          topic_name: str,
                          target: Optional[str] = None,
                          max_records: int = 65536) -> Dict:
    """Republish parked records (past the replay cursor) to `target` and
    commit the cursor — at-least-once: the cursor advances only after the
    republish, so a crash mid-replay re-replays rather than losing."""
    target = target or default_replay_target(topic_name, naming)
    consumer = bus.consumer(topic_name, REPLAY_GROUP)
    replayed = 0
    while replayed < max_records:
        batch = consumer.poll(min(4096, max_records - replayed))
        if not batch:
            break
        bus.topic(target).publish_many(
            [(r.key, r.value) for r in batch])
        bus.commit(consumer)
        replayed += len(batch)
    return {"topic": topic_name, "target": target, "replayed": replayed,
            "remaining": _replay_backlog(bus, topic_name)}
