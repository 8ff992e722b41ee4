"""Device stream management: declare streams, append/read chunks, reassemble
(counterpart of `sitewhere_tpu/streams/manager.py`).

Reference: service-streaming-media — media/DeviceStreamManager.java handles
device requests to create streams and submit/request chunks, persisting
stream metadata via device management and chunk data via the event store
(chunked stream-data persistence across Mongo/Cassandra/InfluxDB). Here
stream metadata is a durable per-tenant collection (same store backends as
the registry) and chunks ride the same columnar event log as every other
event (DeviceStreamData events with `stream_id` + `sequence_number`), so
stream content is replayable and sharded exactly like the rest of the
event plane.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sitewhere_tpu_torch.errors import ErrorCode, NotFoundError, SiteWhereError
from sitewhere_tpu_torch.model.common import SearchCriteria, SearchResults, page
from sitewhere_tpu_torch.model.device import DeviceStream
from sitewhere_tpu_torch.model.event import DeviceStreamData
from sitewhere_tpu_torch.persist.eventlog import EventFilter
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent

_KIND = "device_stream"


class DeviceStreamManager(LifecycleComponent):
    """Per-tenant stream registry + chunk IO on top of event management."""

    def __init__(self, registry, event_management, store=None,
                 name: str = "device-stream-manager"):
        super().__init__(name)
        self.registry = registry
        self.events = event_management
        self.store = store
        self._streams: Dict[str, DeviceStream] = {}  # key: assignment|stream
        self._lock = threading.RLock()
        if store is not None:
            from sitewhere_tpu_torch.registry.store import _entity_from_json
            for _entity_id, _token, payload in store.load_all(_KIND):
                stream = _entity_from_json(DeviceStream, payload)
                self._streams[self._key(stream.assignment_id,
                                        stream.token)] = stream

    @staticmethod
    def _key(assignment_id: str, stream_id: str) -> str:
        return f"{assignment_id}|{stream_id}"

    def _require_assignment(self, assignment_token: str):
        assignment = self.registry.get_device_assignment_by_token(
            assignment_token)
        if assignment is None:
            raise NotFoundError(f"unknown assignment: {assignment_token}",
                                ErrorCode.INVALID_ASSIGNMENT_TOKEN)
        return assignment

    # -- stream registry ---------------------------------------------------
    def create_device_stream(self, assignment_token: str, stream_id: str,
                             content_type: str = "application/octet-stream"
                             ) -> DeviceStream:
        """Declare a stream (DeviceStreamManager.handleDeviceStreamRequest):
        duplicate ids under one assignment are rejected."""
        assignment = self._require_assignment(assignment_token)
        with self._lock:
            key = self._key(assignment.id, stream_id)
            if key in self._streams:
                raise SiteWhereError(
                    f"duplicate stream id: {stream_id}",
                    ErrorCode.DUPLICATE_STREAM_ID, http_status=409)
            stream = DeviceStream(token=stream_id,
                                  assignment_id=assignment.id,
                                  content_type=content_type)
            self._streams[key] = stream
            if self.store is not None:
                from sitewhere_tpu_torch.registry.store import _entity_to_json
                self.store.save(_KIND, stream.id, key,
                                _entity_to_json(stream))
        return stream

    def get_device_stream(self, assignment_token: str, stream_id: str
                          ) -> Optional[DeviceStream]:
        assignment = self.registry.get_device_assignment_by_token(
            assignment_token)
        if assignment is None:
            return None
        with self._lock:
            return self._streams.get(self._key(assignment.id, stream_id))

    def require_device_stream(self, assignment_token: str,
                              stream_id: str) -> DeviceStream:
        stream = self.get_device_stream(assignment_token, stream_id)
        if stream is None:
            raise NotFoundError(f"unknown stream: {stream_id}",
                                ErrorCode.INVALID_STREAM_ID)
        return stream

    def list_device_streams(self, assignment_token: str,
                            criteria: Optional[SearchCriteria] = None
                            ) -> SearchResults[DeviceStream]:
        assignment = self._require_assignment(assignment_token)
        with self._lock:
            streams = [s for s in self._streams.values()
                       if s.assignment_id == assignment.id]
        streams.sort(key=lambda s: s.created_date)
        return page(streams, criteria or SearchCriteria())

    # -- chunk IO ----------------------------------------------------------
    def add_stream_data(self, assignment_token: str, stream_id: str,
                        sequence_number: int, data: bytes
                        ) -> DeviceStreamData:
        """Persist one chunk (handleDeviceStreamDataRequest)."""
        self.require_device_stream(assignment_token, stream_id)
        event = DeviceStreamData(stream_id=stream_id,
                                 sequence_number=sequence_number, data=data)
        return self.events.add_stream_data(assignment_token, event)[0]

    def get_stream_data(self, assignment_token: str, stream_id: str,
                        sequence_number: int) -> Optional[DeviceStreamData]:
        """Exact columnar lookup; on redelivered duplicates the newest chunk
        wins (matching reassemble's last-write-wins)."""
        results = self.events.log.query(
            self.events.tenant,
            EventFilter(assignment_token=assignment_token,
                        stream_id=stream_id,
                        sequence_number=sequence_number),
            SearchCriteria(page_number=1, page_size=1))  # newest-first order
        return results.results[0] if results.results else None

    def list_stream_data(self, assignment_token: str, stream_id: str,
                         criteria: Optional[SearchCriteria] = None
                         ) -> SearchResults[DeviceStreamData]:
        return self.events.list_stream_data(assignment_token, stream_id,
                                            criteria)

    def reassemble(self, assignment_token: str, stream_id: str,
                   page_size: int = 10_000) -> bytes:
        """Concatenate all chunks in sequence order (no silent cap).

        Fetched as ONE page sized to the reported total, growing until a
        fetch returns everything it reported — fixed page boundaries over a
        live log would shift when a device appends mid-scan and silently
        skip a chunk. Redelivered duplicates: last write wins — equal
        sequence numbers keep append order under the stable sort, so a
        plain dict overwrite keeps the newest bytes."""
        self.require_device_stream(assignment_token, stream_id)
        want = max(page_size, 1)
        while True:
            results = self.events.list_stream_data(
                assignment_token, stream_id,
                SearchCriteria(page_number=1, page_size=want))
            if results.num_results <= want:
                break
            want = results.num_results
        by_seq: Dict[int, bytes] = {
            chunk.sequence_number: chunk.data for chunk in results.results}
        return b"".join(by_seq[seq] for seq in sorted(by_seq))
