"""Centralized instance logging over the event bus.

Reference: MicroserviceLogProducer.java:33-47 — every microservice pushes
structured log records onto the `instance-logging` Kafka topic through a
bounded queue + background thread, and the admin surface reads the merged
stream. Here `BusLogHandler` is a stdlib logging.Handler doing the same onto
the in-proc bus topic (runtime/bus.py TopicNaming.instance_logging), and
`LogAggregator` tails the topic into a ring buffer the REST API serves
(GET /api/instance/logs).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming


class BusLogHandler(logging.Handler):
    """Publish log records to the instance-logging topic.

    Non-blocking like the reference's queue+thread: records append to a
    bounded deque drained by a daemon thread, so logging in the hot path
    never waits on the bus (overflow drops oldest, counted)."""

    def __init__(self, bus: EventBus, naming: Optional[TopicNaming] = None,
                 source: str = "instance", max_queue: int = 10_000,
                 level: int = logging.INFO):
        super().__init__(level=level)
        self.bus = bus
        self.naming = naming or TopicNaming()
        self.source = source
        self.dropped = 0
        self._queue: Deque[bytes] = deque(maxlen=max_queue)
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="bus-log-producer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def emit(self, record: logging.LogRecord) -> None:
        try:
            payload = json.dumps({
                "ts_ms": int(record.created * 1000),
                "level": record.levelname,
                "logger": record.name,
                "source": self.source,
                "message": record.getMessage(),
                "thread": record.threadName,
            }).encode()
        except Exception:  # formatting must never raise into callers
            self.handleError(record)
            return
        if len(self._queue) == self._queue.maxlen:
            self.dropped += 1
        self._queue.append(payload)
        self._event.set()

    def _drain(self) -> None:
        topic = self.naming.instance_logging()
        while not self._stop.is_set():
            self._event.wait(timeout=0.5)
            self._event.clear()
            while self._queue:
                payload = self._queue.popleft()
                try:
                    self.bus.publish(topic, self.source.encode(), payload)
                except Exception:
                    self.dropped += 1


class LogAggregator:
    """Tail the instance-logging topic into a queryable ring buffer — the
    admin-facing merged log view (the reference aggregates the Kafka topic
    the same way). Built on the shared ConsumerHost poll loop
    (runtime/bus.py) so offset tracking and restart semantics are the same
    as every other consumer."""

    def __init__(self, bus: EventBus, naming: Optional[TopicNaming] = None,
                 capacity: int = 5000):
        from sitewhere_tpu_torch.runtime.bus import ConsumerHost
        self.bus = bus
        self.naming = naming or TopicNaming()
        self._records: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._host = ConsumerHost(bus, self.naming.instance_logging(),
                                  group_id="log-aggregator",
                                  handler=self._consume)

    def start(self) -> None:
        self._host.start()

    def stop(self) -> None:
        self._host.stop()

    def _consume(self, records) -> None:
        for record in records:
            try:
                entry = json.loads(record.value)
            except ValueError:
                entry = {"message": record.value.decode("utf-8", "replace")}
            with self._lock:
                self._records.append(entry)

    def recent(self, limit: int = 200, level: Optional[str] = None,
               source: Optional[str] = None) -> List[Dict[str, Any]]:
        if limit <= 0:
            return []
        with self._lock:
            records = list(self._records)
        if level:
            records = [r for r in records if r.get("level") == level]
        if source:
            records = [r for r in records if r.get("source") == source]
        return records[-limit:]
