"""Partitioned event bus: the in-process data plane replacing Kafka.

Reference: the Kafka topic pipeline (SURVEY.md §1) — topics named
`{product}.{instance}.tenant.{tenant}.{suffix}` (KafkaTopicNaming.java:81-98),
per-key partitioning for per-device ordering, consumer groups with committed
offsets (MicroserviceKafkaConsumer.java:36, offset commit in
DecodedEventsConsumer.java:194-199), at-least-once delivery, and replay.

Here a Topic is N append-only partitions. Records are (offset, key, value)
byte pairs; a record's partition is hash(key) % N, preserving per-device
ordering exactly like the reference's device-token record keys. Consumer
groups track committed offsets per partition and independently replay.
Durability is an optional length-prefixed append log per partition, replayed
on open — the Kafka-replay story the device-state cache depends on
(SURVEY.md §5 checkpoint/resume) works the same way here.

Counterpart of `sitewhere_tpu/runtime/bus.py`, record for record: the
port's checkpointer replays it past the saved offsets (`recover`). The hot
path does not hop through this bus between stages: the captured step
(pipeline/step.py) replaces those broker round-trips. The bus carries the
edge flows: ingest -> pipeline, pipeline -> outbound connectors / command
delivery, plus control-plane topics.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

# one definition of the retry jitter, shared with the engine's retries
from sitewhere_tpu_torch.runtime.faults import jittered


class Record(NamedTuple):
    """One bus record. A NamedTuple, not a frozen dataclass: poll paths
    construct hundreds of thousands per second and frozen-dataclass
    __init__ (object.__setattr__ per field) dominated networked-poll
    profiles."""

    topic: str
    partition: int
    offset: int
    key: bytes
    value: bytes
    timestamp_ms: int


def batch_extent(records: List["Record"]) -> Dict[int, int]:
    """Per-partition exclusive end offsets of a polled batch — the extent
    retry cycles re-poll (ConsumerHost / RemoteConsumerHost `until`)."""
    extent: Dict[int, int] = {}
    for record in records:
        extent[record.partition] = max(extent.get(record.partition, 0),
                                       record.offset + 1)
    return extent




class TopicNaming:
    """Topic name taxonomy (KafkaTopicNaming.java:33-98)."""

    def __init__(self, product: str = "swtpu", instance: str = "default"):
        self.product = product
        self.instance = instance

    def _global(self, suffix: str) -> str:
        return f"{self.product}.{self.instance}.{suffix}"

    def _tenant(self, tenant: str, suffix: str) -> str:
        return f"{self.product}.{self.instance}.tenant.{tenant}.{suffix}"

    # global topics (KafkaTopicNaming.java:33-43)
    def microservice_state_updates(self) -> str:
        return self._global("microservice-state-updates")

    def instance_topology_updates(self) -> str:
        return self._global("instance-topology-updates")

    def tenant_model_updates(self) -> str:
        return self._global("tenant-model-updates")

    def provisioning_model_updates(self) -> str:
        """Cross-host control-plane provisioning stream (tenant/user/
        authority mutations, multitenant/replication.py) — the cluster
        analog of the per-host tenant-model-updates topic."""
        return self._global("provisioning-model-updates")

    def instance_logging(self) -> str:
        return self._global("instance-logging")

    def feeder_frames(self) -> str:
        """Raw hot-event wire frames awaiting a feeder's decode+pack
        (feeders/): partition ownership follows TTL leases, not consumer
        membership, so this stays a global topic — tenancy is resolved by
        the engine after the blob lands."""
        return self._global("feeder-frames")

    # per-tenant topics (KafkaTopicNaming.java:45-69)
    def event_source_decoded_events(self, tenant: str) -> str:
        return self._tenant(tenant, "event-source-decoded-events")

    def event_source_failed_decode_events(self, tenant: str) -> str:
        return self._tenant(tenant, "event-source-failed-decode-events")

    def inbound_persisted_events(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-persisted-events")

    def inbound_enriched_events(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-enriched-events")

    def inbound_enriched_batches(self, tenant: str) -> str:
        """Batch-granularity enriched stream for the bulk lane: one compact
        marker per persisted EventBatch (tenant, row count, event-date
        span) instead of one envelope per event — consumers read the
        referenced rows back from the columnar log. The per-event
        `inbound_enriched_events` topic stays the control-plane-rate
        surface; no per-event Python object survives the bulk path."""
        return self._tenant(tenant, "inbound-enriched-batches")

    def inbound_enriched_command_invocations(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-enriched-command-invocations")

    def inbound_device_registration_events(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-device-registration-events")

    def inbound_unregistered_device_events(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-unregistered-device-events")

    def inbound_reprocess_events(self, tenant: str) -> str:
        return self._tenant(tenant, "inbound-reprocess-events")

    def undelivered_command_invocations(self, tenant: str) -> str:
        return self._tenant(tenant, "undelivered-command-invocations")


_FRAME = struct.Struct("<IIq")  # key_len, value_len, timestamp_ms


class _Partition:
    """One append-only ordered log. Thread-safe; optionally file-backed."""

    def __init__(self, path: Optional[str] = None):
        self._records: List[Tuple[int, bytes, bytes, int]] = []  # offset, k, v, ts
        self._base_offset = 0  # offset of _records[0] after truncation
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._fh = None
        if path:
            self._load(path)
            self._fh = open(path, "ab")

    def _load(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            data = fh.read()
        pos, offset = 0, 0
        while pos + _FRAME.size <= len(data):
            klen, vlen, ts = _FRAME.unpack_from(data, pos)
            pos += _FRAME.size
            if pos + klen + vlen > len(data):
                break  # torn tail write; drop
            key = data[pos:pos + klen]
            value = data[pos + klen:pos + klen + vlen]
            pos += klen + vlen
            self._records.append((offset, key, value, ts))
            offset += 1

    def append(self, key: bytes, value: bytes) -> int:
        ts = int(time.time() * 1000)
        with self._cv:
            offset = self._base_offset + len(self._records)
            self._records.append((offset, key, value, ts))
            if self._fh is not None:
                self._fh.write(_FRAME.pack(len(key), len(value), ts))
                self._fh.write(key)
                self._fh.write(value)
                # flush to the OS page cache: an accepted record must
                # survive a process crash (Kafka's default durability —
                # page cache, not fsync). Without this, records sat in
                # userspace buffers and a crash lost events producers
                # thought were accepted.
                self._fh.flush()
            self._cv.notify_all()
            return offset

    def append_many(self, records: List[Tuple[bytes, bytes]]) -> int:
        """Bulk append under ONE lock acquisition / durable write / wakeup
        (the per-record path costs a lock+notify each — the networked bus
        edge moves thousands of records per request). Returns the offset
        of the LAST appended record."""
        ts = int(time.time() * 1000)
        with self._cv:
            offset = self._base_offset + len(self._records) - 1
            chunks: List[bytes] = []
            for key, value in records:
                offset += 1
                self._records.append((offset, key, value, ts))
                if self._fh is not None:
                    chunks.append(_FRAME.pack(len(key), len(value), ts))
                    chunks.append(key)
                    chunks.append(value)
            if self._fh is not None and chunks:
                self._fh.write(b"".join(chunks))
                self._fh.flush()  # page-cache durability, once per batch
            self._cv.notify_all()
            return offset

    def read(self, from_offset: int, max_records: int) -> List[Tuple[int, bytes, bytes, int]]:
        with self._lock:
            start = max(0, from_offset - self._base_offset)
            return self._records[start:start + max_records]

    def end_offset(self) -> int:
        with self._lock:
            return self._base_offset + len(self._records)

    def start_offset(self) -> int:
        with self._lock:
            return self._base_offset

    def truncate_before(self, offset: int) -> None:
        """Drop in-memory records below `offset` (retention)."""
        with self._lock:
            drop = offset - self._base_offset
            if drop > 0:
                del self._records[:drop]
                self._base_offset = offset

    def wait_for_data(self, from_offset: int, timeout_s: float) -> bool:
        with self._cv:
            if self._base_offset + len(self._records) > from_offset:
                return True
            self._cv.wait(timeout_s)
            return self._base_offset + len(self._records) > from_offset

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class Topic:
    # sweep cadence: retention is evaluated per partition once per this
    # many appends (amortizes the group-floor scan off the hot path)
    RETENTION_CHECK_EVERY = 2048

    def __init__(self, name: str, partitions: int, data_dir: Optional[str] = None):
        self.name = name
        paths = [None] * partitions
        if data_dir:
            safe = name.replace("/", "_")
            topic_dir = os.path.join(data_dir, safe)
            os.makedirs(topic_dir, exist_ok=True)
            paths = [os.path.join(topic_dir, f"p{i:04d}.log") for i in range(partitions)]
        self.partitions = [_Partition(p) for p in paths]
        # in-memory retention (Kafka's log.retention role, bounded RAM):
        # installed by EventBus.enable_retention() AFTER boot replay —
        # None = unlimited (standalone topics, pre-restore boot window)
        self._retention_records: Optional[int] = None
        self._floor_fn = None           # partition idx -> min committed
        self._since_check = [0] * partitions
        self.retention_dropped = 0

    def enable_retention(self, max_records: int, floor_fn) -> None:
        self._retention_records = int(max_records)
        self._floor_fn = floor_fn
        for idx in range(len(self.partitions)):
            self._apply_retention(idx)

    def _apply_retention(self, idx: int) -> None:
        """Truncate partition `idx`'s in-memory window. Keeps, from
        newest to oldest: the cap window (future/new consumers can read
        that far back, like Kafka's retention window); anything an
        EXISTING group has not committed yet (crash-replay stays intact
        for live laggards); but never more than 8x the cap — a dead
        group must not pin unbounded memory (Kafka answers the same way:
        retention wins over a too-slow consumer; the busnet consumer
        path already handles truncated extents)."""
        cap = self._retention_records
        if cap is None:
            return
        p = self.partitions[idx]
        end = p.end_offset()
        cutoff = end - cap
        if cutoff <= p.start_offset():
            return
        floor = self._floor_fn(idx) if self._floor_fn is not None else end
        cutoff = min(cutoff, floor)
        cutoff = max(cutoff, end - 8 * cap)
        if cutoff > p.start_offset():
            self.retention_dropped += cutoff - p.start_offset()
            p.truncate_before(cutoff)

    def _maybe_retain(self, idx: int, appended: int) -> None:
        if self._retention_records is None:
            return
        self._since_check[idx] += appended
        if self._since_check[idx] >= self.RETENTION_CHECK_EVERY:
            self._since_check[idx] = 0
            self._apply_retention(idx)

    def partition_for(self, key: bytes) -> int:
        # Stable across processes/restarts (unlike Python hash()).
        return zlib.crc32(key) % len(self.partitions)

    def publish(self, key: bytes, value: bytes) -> Tuple[int, int]:
        part = self.partition_for(key)
        offset = self.partitions[part].append(key, value)
        self._maybe_retain(part, 1)
        return part, offset

    def publish_many(self, records: List[Tuple[bytes, bytes]]
                     ) -> Tuple[int, int]:
        """Bulk publish: group by partition once, one append_many per
        touched partition. Per-key partition routing (and therefore
        per-device ordering) is identical to publish(). Returns
        (partition, offset) of the LAST record in arrival order."""
        if not records:
            raise ValueError("publish_many requires at least one record")
        by_part: Dict[int, List[Tuple[bytes, bytes]]] = {}
        last_part = 0
        for key, value in records:
            last_part = self.partition_for(key)
            by_part.setdefault(last_part, []).append((key, value))
        last: Tuple[int, int] = (last_part, -1)
        for part, recs in by_part.items():
            offset = self.partitions[part].append_many(recs)
            self._maybe_retain(part, len(recs))
            if part == last_part:
                last = (part, offset)
        return last

    def end_offsets(self) -> List[int]:
        return [p.end_offset() for p in self.partitions]

    def flush(self) -> None:
        for p in self.partitions:
            p.flush()

    def close(self) -> None:
        for p in self.partitions:
            p.close()


class ConsumerGroup:
    """Committed-offset cursor over all partitions of a topic.

    poll() returns the next batch past the *position* (not yet committed);
    commit() advances the committed offsets — crash/restart replays anything
    uncommitted, giving at-least-once semantics like the reference's manual
    offset commits.
    """

    def __init__(self, topic: Topic, group_id: str,
                 committed: Optional[List[int]] = None):
        self.topic = topic
        self.group_id = group_id
        n = len(topic.partitions)
        self.committed = list(committed) if committed else [0] * n
        if len(self.committed) != n:
            self.committed = (self.committed + [0] * n)[:n]
        self.position = list(self.committed)
        self._lock = threading.Lock()
        # records retention truncated AWAY FROM THIS GROUP before it
        # polled them (position < partition base): poll() counts them
        # here instead of silently clamping — a lagging consumer can see
        # exactly how many records it lost, per partition
        self.retention_skipped = 0
        self.retention_skipped_by_partition: Dict[int, int] = {}

    def poll(self, max_records: int = 4096, timeout_s: float = 0.0,
             partitions: Optional[List[int]] = None,
             until: Optional[Dict[int, int]] = None) -> List[Record]:
        """`partitions` restricts the poll to a subset (consumer-group
        member assignment — busnet's networked groups); None = all.
        `until` maps partition -> exclusive end offset and bounds the poll
        to exactly a previously-seen extent (retry cycles re-polling a
        failing batch — records beyond the extent are neither returned nor
        skipped); partitions absent from `until` are not read at all, and
        the long-poll wait is skipped (the bounded rows already exist)."""
        out: List[Record] = []
        owned = (range(len(self.topic.partitions)) if partitions is None
                 else partitions)
        if until is not None:
            owned = [idx for idx in owned if idx in until]
        with self._lock:
            budget = max_records
            for idx in owned:
                if budget <= 0:
                    break
                part = self.topic.partitions[idx]
                base = part.start_offset()
                if self.position[idx] < base:
                    # retention truncated records this group never saw:
                    # surface the skip instead of silently reading from
                    # the new base. Committed advances with the clamp —
                    # the records are gone, a later seek_to_committed
                    # must not re-count (or appear to re-deliver) them.
                    lost = base - self.position[idx]
                    self.retention_skipped += lost
                    self.retention_skipped_by_partition[idx] = (
                        self.retention_skipped_by_partition.get(idx, 0)
                        + lost)
                    self.position[idx] = base
                    self.committed[idx] = max(self.committed[idx], base)
                rows = part.read(self.position[idx], budget)
                if until is not None:
                    rows = [r for r in rows if r[0] < until[idx]]
                for offset, key, value, ts in rows:
                    out.append(Record(self.topic.name, idx, offset, key, value, ts))
                if rows:
                    self.position[idx] = rows[-1][0] + 1
                    budget -= len(rows)
        if not out and timeout_s > 0 and until is None:
            # Deadline-based wait ACROSS partitions: waiting the full
            # timeout on each partition in turn would block a
            # multi-partition idle topic for partitions * timeout (a
            # remote long-poll would outlive its client's socket timeout).
            deadline = time.monotonic() + timeout_s
            if not owned:
                # a member that owns no partitions (more members than
                # partitions) must idle-wait, not busy-spin
                time.sleep(timeout_s)
                return []
            while True:
                for idx in owned:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    part = self.topic.partitions[idx]
                    if part.wait_for_data(self.position[idx],
                                          min(remaining, 0.05)):
                        return self.poll(max_records, 0.0,
                                         partitions=partitions)
        return out

    def commit(self, partitions: Optional[List[int]] = None) -> None:
        with self._lock:
            if partitions is None:
                self.committed = list(self.position)
            else:
                for idx in partitions:
                    self.committed[idx] = self.position[idx]

    def commit_at(self, offsets: Dict[int, int],
                  partitions: Optional[List[int]] = None) -> None:
        """Commit EXPLICIT per-partition exclusive end offsets (Kafka's
        commitSync(offsets) shape) — the cursor a consumer actually
        finished, independent of where the poll position has since moved.
        Monotonic: never rewinds a committed offset. `partitions`
        restricts the commit to an owned subset (networked groups)."""
        with self._lock:
            for idx, off in offsets.items():
                if partitions is not None and idx not in partitions:
                    continue
                if not 0 <= idx < len(self.committed):
                    continue
                # clamp to the real log end: a buggy/corrupted client
                # extent must never commit past records that don't exist
                # yet (that would silently skip future deliveries — the
                # contract here is "duplicates possible, loss not")
                end = self.topic.partitions[idx].end_offset()
                off = max(0, min(int(off), end))
                self.committed[idx] = max(self.committed[idx], off)
                # preserve the position >= committed invariant, or a
                # reconnect-triggered seek would redeliver (and possibly
                # dead-letter) records this very call just committed
                self.position[idx] = max(self.position[idx],
                                         self.committed[idx])

    def seek_to_committed(self, partitions: Optional[List[int]] = None) -> None:
        with self._lock:
            if partitions is None:
                self.position = list(self.committed)
            else:
                for idx in partitions:
                    self.position[idx] = self.committed[idx]

    def seek_to_beginning(self) -> None:
        with self._lock:
            self.position = [p.start_offset() for p in self.topic.partitions]
            self.committed = list(self.position)

    def lag(self) -> int:
        with self._lock:
            return sum(e - c for e, c in zip(self.topic.end_offsets(), self.committed))


class EventBus:
    """Broker facade: topic registry + consumer-group registry + offsets store.

    Committed group offsets persist to `<data_dir>/_offsets/<topic>@<group>`
    so restart resumes from the last commit (the reference relies on Kafka's
    __consumer_offsets for the same thing).
    """

    def __init__(self, partitions: int = 8, data_dir: Optional[str] = None):
        self._partitions = partitions
        self._data_dir = data_dir
        self._topics: Dict[str, Topic] = {}
        self._groups: Dict[Tuple[str, str], ConsumerGroup] = {}
        self._lock = threading.RLock()  # consumer() -> topic() re-enters
        self._retention_records: Optional[int] = None
        if data_dir:
            os.makedirs(os.path.join(data_dir, "_offsets"), exist_ok=True)

    def enable_retention(self, max_records: int = 65536) -> None:
        """Bound every partition's IN-MEMORY window (Kafka's
        log.retention role). Must be called AFTER boot replay / any
        checkpoint cursor rewind: from then on, a partition keeps its
        newest `max_records` plus whatever live consumer groups have not
        committed (hard-bounded at 8x — see Topic._apply_retention).
        Durable log files are unaffected; in-memory reads below the
        window report a truncated extent, which consumers already
        handle. Applies to existing topics immediately and to topics
        created later."""
        with self._lock:
            self._retention_records = int(max_records)
            topics = list(self._topics.values())
        for topic in topics:
            topic.enable_retention(self._retention_records,
                                   self._floor_fn(topic.name))

    def _floor_fn(self, topic_name: str):
        def floor(idx: int) -> int:
            with self._lock:
                groups = [g for (t, _gid), g in self._groups.items()
                          if t == topic_name]
            floors = []
            for group in groups:
                with group._lock:
                    if idx < len(group.committed):
                        floors.append(group.committed[idx])
            return min(floors) if floors else (1 << 62)
        return floor

    def topic(self, name: str, partitions: Optional[int] = None) -> Topic:
        with self._lock:
            if name not in self._topics:
                topic = Topic(name, partitions or self._partitions,
                              self._data_dir)
                if self._retention_records is not None:
                    topic.enable_retention(self._retention_records,
                                           self._floor_fn(name))
                self._topics[name] = topic
            return self._topics[name]

    def publish(self, topic_name: str, key: bytes, value: bytes) -> Tuple[int, int]:
        return self.topic(topic_name).publish(key, value)

    def publish_batch(self, topic_name: str,
                      records: List[Tuple[bytes, bytes]]) -> Tuple[int, int]:
        """Bulk publish (one lock/write/wakeup per touched partition);
        returns (partition, offset) of the last record."""
        return self.topic(topic_name).publish_many(records)

    def _offsets_path(self, topic_name: str, group_id: str) -> Optional[str]:
        if not self._data_dir:
            return None
        safe = f"{topic_name}@{group_id}".replace("/", "_")
        return os.path.join(self._data_dir, "_offsets", safe)

    def consumer(self, topic_name: str, group_id: str) -> ConsumerGroup:
        with self._lock:
            key = (topic_name, group_id)
            if key not in self._groups:
                committed = None
                path = self._offsets_path(topic_name, group_id)
                if path and os.path.exists(path):
                    with open(path, "r", encoding="utf-8") as fh:
                        committed = [int(x) for x in fh.read().split()] or None
                self._groups[key] = ConsumerGroup(self.topic(topic_name), group_id,
                                                  committed)
            return self._groups[key]

    def _persist_offsets(self, group: ConsumerGroup) -> None:
        path = self._offsets_path(group.topic.name, group.group_id)
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(" ".join(str(o) for o in group.committed))
            os.replace(tmp, path)

    def commit_at(self, group: ConsumerGroup, offsets: Dict[int, int],
                  partitions: Optional[List[int]] = None) -> None:
        """Explicit-offset commit, persisted like commit()."""
        group.commit_at(offsets, partitions)
        self._persist_offsets(group)

    def commit(self, group: ConsumerGroup,
               partitions: Optional[List[int]] = None) -> None:
        group.commit(partitions)
        self._persist_offsets(group)

    def persisted_topics(self) -> List[str]:
        """Topic names with on-disk logs from ANY process incarnation.
        `topics()` lists only lazily-created in-memory topics — after a
        restart, a durable topic (e.g. parked dead-letter records) exists
        on disk but not in memory until first touch, and the dead-letter
        operability surface must still find it. Names containing '/' are
        stored escaped ('_') and cannot be recovered from the dir listing;
        no framework topic uses '/'."""
        if not self._data_dir or not os.path.isdir(self._data_dir):
            return []
        return [name for name in os.listdir(self._data_dir)
                if name != "_offsets"
                and os.path.isdir(os.path.join(self._data_dir, name))]

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._topics)

    def flush(self) -> None:
        with self._lock:
            topics = list(self._topics.values())
        for t in topics:
            t.flush()

    def close(self) -> None:
        with self._lock:
            topics = list(self._topics.values())
            self._topics.clear()
        for t in topics:
            t.close()


class ConsumerHost:
    """Background poll loop driving a handler with batches — the reference's
    MicroserviceKafkaConsumer single-thread poll loop (:115-121) as a
    lifecycle-managed thread. Handler exceptions leave offsets uncommitted so
    the batch redelivers — but only `max_retries` times, with exponential
    backoff between attempts (0.05s doubling to `max_backoff_s`, ~2 min
    total at the defaults) so transient downstream outages are ridden out;
    a batch still failing after that is treated as deterministically
    poisonous, parks on the dead-letter topic, and offsets advance instead
    of redelivering forever. The reference parks failures the same way
    (failed-decode / undelivered topics, KafkaTopicNaming.java:48,69)."""

    def __init__(self, bus: EventBus, topic_name: str, group_id: str,
                 handler: Callable[[List[Record]], None],
                 max_records: int = 4096, poll_timeout_s: float = 0.2,
                 max_retries: int = 12, max_backoff_s: float = 30.0,
                 dead_letter_topic: Optional[str] = None):
        self._bus = bus
        self._topic_name = topic_name
        self._group_id = group_id
        self._handler = handler
        self._max_records = max_records
        self._poll_timeout_s = poll_timeout_s
        self._max_retries = max_retries
        self._max_backoff_s = max_backoff_s
        self.dead_letter_topic = (dead_letter_topic
                                  or f"{topic_name}.dead-letter")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors = 0
        self.dead_lettered = 0
        # (committed-offset fingerprint, consecutive failures,
        # per-partition exclusive end offsets of the batch at first
        # failure) — retries re-poll exactly that extent
        self._failing: Optional[
            Tuple[Tuple[int, ...], int, Dict[int, int]]] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"consumer-{self._group_id}", daemon=True)
        self._thread.start()

    def _park(self, batch: List[Record]) -> None:
        """Publish a poisonous batch to the dead-letter topic; caller then
        commits past it. Key/value pass through unchanged so a repair tool
        can replay them onto the source topic."""
        dlq = self._bus.topic(self.dead_letter_topic)
        for record in batch:
            dlq.publish(record.key, record.value)
        self.dead_lettered += len(batch)

    def _run(self) -> None:
        consumer = self._bus.consumer(self._topic_name, self._group_id)
        consumer.seek_to_committed()
        while not self._stop.is_set():
            # During a retry cycle, poll EXACTLY the extent of the batch
            # that first failed (per-partition end offsets): records
            # arriving during the backoff must not join the retried batch,
            # or parking would dead-letter (and commit past) innocent
            # records that were never at fault.
            until = self._failing[2] if self._failing else None
            batch = consumer.poll(self._max_records,
                                  timeout_s=self._poll_timeout_s,
                                  until=until)
            if not batch:
                if self._failing:
                    # the failing extent yielded nothing (e.g. retention
                    # truncated it): abandon the retry cycle rather than
                    # re-polling an empty extent forever
                    self._failing = None
                    consumer.seek_to_committed()
                continue
            try:
                self._handler(batch)
                self._bus.commit(consumer)
                self._failing = None
            except Exception:
                self.errors += 1
                fingerprint = tuple(consumer.committed)
                if self._failing and self._failing[0] == fingerprint:
                    retries = self._failing[1] + 1
                    extent = self._failing[2]
                else:
                    retries = 1
                    extent = batch_extent(batch)
                self._failing = (fingerprint, retries, extent)
                if retries > self._max_retries:
                    self._park(batch)
                    self._bus.commit(consumer)  # advance past the poison
                    self._failing = None
                else:
                    consumer.seek_to_committed()
                    backoff = min(0.05 * (2 ** (retries - 1)),
                                  self._max_backoff_s)
                    self._stop.wait(jittered(backoff))

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout_s)
            self._thread = None
