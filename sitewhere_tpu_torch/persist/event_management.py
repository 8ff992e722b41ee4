"""Device event management: the persistence API over the columnar log.

Reference surface: IDeviceEventManagement (sitewhere-core-api
spi/device/event/IDeviceEventManagement.java) / the 16 rpcs of
device-event-management.proto:20-93 (AddDeviceEventBatch, GetDeviceEventById,
GetDeviceEventByAlternateId, Add/ListMeasurements, Add/ListLocations,
Add/ListAlerts, Add/ListCommandInvocations, ListCommandResponsesForInvocation,
Add/ListStateChanges, Add/ListStreamData) routed through
EventManagementImpl.java:82 and decorated by KafkaEventPersistenceTriggers.java:50
which forwards every persisted event to the inbound-persisted-events topic.

List rpcs take an *index* (assignment / area / asset / customer) plus ids and
a date range — EventIndex mirrors that.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Sequence

import msgpack

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.common import (
    DateRangeCriteria, SearchCriteria, SearchResults, new_id, now_ms)
from sitewhere_tpu_torch.model.event import (
    DeviceAlert, DeviceCommandInvocation, DeviceCommandResponse, DeviceEvent,
    DeviceEventBatch, DeviceEventContext, DeviceEventType, DeviceLocation,
    DeviceMeasurement, DeviceStateChange, DeviceStreamData)
from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog, EventFilter
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent


class EventIndex(enum.Enum):
    """Which entity field a list query filters on
    (GDeviceEventIndex in device-event-model.proto)."""

    ASSIGNMENT = "assignment"
    AREA = "area"
    ASSET = "asset"
    CUSTOMER = "customer"
    DEVICE = "device"


_INDEX_FIELD = {
    EventIndex.ASSIGNMENT: "assignment_token",
    EventIndex.AREA: "area_id",
    EventIndex.ASSET: "asset_id",
    EventIndex.CUSTOMER: "customer_id",
    EventIndex.DEVICE: "device_token",
}


def context_for_assignment(registry, assignment_token: str,
                           tenant: str) -> DeviceEventContext:
    """Resolve assignment token -> full event context (the lookup the
    reference does over gRPC in both persistence and enrichment). Shared by
    DeviceEventManagement and PayloadEnrichment so their contexts never
    diverge."""
    assignment = registry.get_device_assignment_by_token(assignment_token)
    if assignment is None:
        raise SiteWhereError(f"unknown assignment: {assignment_token}")
    device = registry.get_device(assignment.device_id)
    return DeviceEventContext(
        device_id=device.id, device_token=device.token,
        device_type_id=device.device_type_id, assignment_id=assignment.token,
        customer_id=assignment.customer_id, area_id=assignment.area_id,
        asset_id=assignment.asset_id, tenant_id=tenant)


class DeviceEventManagement(LifecycleComponent):
    """Tenant-scoped event persistence facade.

    `registry` (a DeviceManagement) resolves assignment context so every
    persisted event carries device/customer/area/asset ids, exactly like the
    reference fills GDeviceEventContext during persistence.
    """

    def __init__(self, log: ColumnarEventLog, registry=None,
                 tenant: str = "default", device_interner=None):
        super().__init__(f"event-management:{tenant}")
        self.log = log
        self.registry = registry
        self.tenant = tenant
        self.device_interner = device_interner
        self._listeners: List[Callable[[List[DeviceEvent]], None]] = []

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        self.log.start()

    def on_stop(self, monitor) -> None:
        # The log is shared across tenants: its lifecycle belongs to whoever
        # constructed it (stop() joins the flusher). Only seal THIS tenant.
        self.log.flush_tenant(self.tenant)

    # -- triggers (KafkaEventPersistenceTriggers equivalent) ---------------
    def add_listener(self, callback: Callable[[List[DeviceEvent]], None]) -> None:
        self._listeners.append(callback)

    def _fire(self, events: List[DeviceEvent]) -> None:
        for cb in self._listeners:
            cb(events)

    # -- context resolution ------------------------------------------------
    def _context_for_assignment(self, assignment_token: str) -> DeviceEventContext:
        if self.registry is None:
            return DeviceEventContext(assignment_id=assignment_token,
                                      tenant_id=self.tenant)
        return context_for_assignment(self.registry, assignment_token,
                                      self.tenant)

    def _stamp(self, ev: DeviceEvent, ctx: DeviceEventContext) -> DeviceEvent:
        if not ev.id:
            ev.id = new_id()
        ev.device_id = ctx.device_token or ev.device_id
        ev.device_assignment_id = ctx.assignment_id
        ev.customer_id = ctx.customer_id
        ev.area_id = ctx.area_id
        ev.asset_id = ctx.asset_id
        ev.received_date = now_ms()
        return ev

    def _persist(self, assignment_token: str,
                 events: Sequence[DeviceEvent]) -> List[DeviceEvent]:
        ctx = self._context_for_assignment(assignment_token)
        stamped = [self._stamp(ev, ctx) for ev in events]
        self.log.append_events(self.tenant, stamped, self.device_interner)
        self._fire(list(stamped))
        return list(stamped)

    # -- add rpcs ----------------------------------------------------------
    def add_measurements(self, assignment_token: str,
                         *events: DeviceMeasurement) -> List[DeviceMeasurement]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_locations(self, assignment_token: str,
                      *events: DeviceLocation) -> List[DeviceLocation]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_alerts(self, assignment_token: str,
                   *events: DeviceAlert) -> List[DeviceAlert]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_command_invocations(self, assignment_token: str,
                                *events: DeviceCommandInvocation
                                ) -> List[DeviceCommandInvocation]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_command_responses(self, assignment_token: str,
                              *events: DeviceCommandResponse
                              ) -> List[DeviceCommandResponse]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_state_changes(self, assignment_token: str,
                          *events: DeviceStateChange) -> List[DeviceStateChange]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_stream_data(self, assignment_token: str,
                        *events: DeviceStreamData) -> List[DeviceStreamData]:
        return self._persist(assignment_token, events)  # type: ignore[return-value]

    def add_device_event_batch(self, device_token: str,
                               batch: DeviceEventBatch) -> List[DeviceEvent]:
        """AddDeviceEventBatch: resolve the device's active assignment, then
        persist every event in the batch (IDeviceEventBatch flow)."""
        if self.registry is None:
            raise SiteWhereError("device event batch requires a registry")
        device = self.registry.get_device_by_token(device_token)
        if device is None:
            raise SiteWhereError(f"unknown device: {device_token}")
        assignment = self.registry.get_active_assignment(device.id)
        if assignment is None:
            raise SiteWhereError(f"device has no active assignment: {device_token}")
        return self._persist(assignment.token, batch.all_events())

    # -- get rpcs ----------------------------------------------------------
    def get_event_by_id(self, event_id: str) -> Optional[DeviceEvent]:
        res = self.log.query(self.tenant, EventFilter(id=event_id),
                             SearchCriteria(page_number=1, page_size=1))
        return res.results[0] if res.results else None

    def get_event_by_alternate_id(self, alternate_id: str
                                  ) -> Optional[DeviceEvent]:
        res = self.log.query(self.tenant, EventFilter(alternate_id=alternate_id),
                             SearchCriteria(page_number=1, page_size=1))
        return res.results[0] if res.results else None

    # -- list rpcs ---------------------------------------------------------
    def _list(self, event_type: DeviceEventType, index: EventIndex,
              token: str, criteria: Optional[SearchCriteria]
              ) -> SearchResults[DeviceEvent]:
        flt = EventFilter(event_type=event_type)
        setattr(flt, _INDEX_FIELD[index], token)
        return self.log.query(self.tenant, flt, criteria)

    def list_measurements(self, index: EventIndex, token: str,
                          criteria: Optional[DateRangeCriteria] = None
                          ) -> SearchResults[DeviceMeasurement]:
        return self._list(DeviceEventType.MEASUREMENT, index, token, criteria)

    def list_locations(self, index: EventIndex, token: str,
                       criteria: Optional[DateRangeCriteria] = None
                       ) -> SearchResults[DeviceLocation]:
        return self._list(DeviceEventType.LOCATION, index, token, criteria)

    def list_alerts(self, index: EventIndex, token: str,
                    criteria: Optional[DateRangeCriteria] = None
                    ) -> SearchResults[DeviceAlert]:
        return self._list(DeviceEventType.ALERT, index, token, criteria)

    def list_command_invocations(self, index: EventIndex, token: str,
                                 criteria: Optional[DateRangeCriteria] = None
                                 ) -> SearchResults[DeviceCommandInvocation]:
        return self._list(DeviceEventType.COMMAND_INVOCATION, index, token,
                          criteria)

    def list_command_responses_for_invocation(
            self, invocation_event_id: str,
            criteria: Optional[SearchCriteria] = None
            ) -> SearchResults[DeviceCommandResponse]:
        return self.log.query(
            self.tenant,
            EventFilter(event_type=DeviceEventType.COMMAND_RESPONSE,
                        originating_event_id=invocation_event_id), criteria)

    def list_state_changes(self, index: EventIndex, token: str,
                           criteria: Optional[DateRangeCriteria] = None
                           ) -> SearchResults[DeviceStateChange]:
        return self._list(DeviceEventType.STATE_CHANGE, index, token, criteria)

    def list_stream_data(self, assignment_token: str, stream_id: str,
                         criteria: Optional[SearchCriteria] = None
                         ) -> SearchResults[DeviceStreamData]:
        return self.log.query(
            self.tenant,
            EventFilter(event_type=DeviceEventType.STREAM_DATA,
                        assignment_token=assignment_token,
                        stream_id=stream_id), criteria,
            order_by="sequence_asc")  # pages align with chunk order

    def list_device_events(self, device_token: str,
                           criteria: Optional[DateRangeCriteria] = None
                           ) -> SearchResults[DeviceEvent]:
        return self.log.query(
            self.tenant, EventFilter(device_token=device_token), criteria)


class EventPersistenceTriggers:
    """Forward persisted events onto the bus — KafkaEventPersistenceTriggers
    (forwardEvents :72): each persisted event goes to inbound-persisted-events,
    keyed by device token for per-device ordering."""

    def __init__(self, bus, naming, tenant: str = "default"):
        self.bus = bus
        self.topic = naming.inbound_persisted_events(tenant)

    def __call__(self, events: List[DeviceEvent]) -> None:
        for ev in events:
            payload = msgpack.packb(ev.to_dict(), use_bin_type=True)
            self.bus.publish(self.topic, ev.device_id.encode(), payload)

    def attach(self, management: DeviceEventManagement) -> None:
        management.add_listener(self)
