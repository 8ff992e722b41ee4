"""Host-side rule processors: the user extension point for custom rules.

Reference: service-rule-processing — RuleProcessorsManager hosts N
IRuleProcessors, each wrapped in KafkaRuleProcessorHost.java:47 with its own
consumer group (:78) on the enriched topic, dispatching by event type
(attemptToProcess :144). Base RuleProcessor.java:31 has no-op hooks
(onLocation/onAlert/... :58-77); the shipped impl is
ZoneTestRuleProcessor.java:33 (JTS point-in-polygon geofencing).

TPU-first split: built-in threshold/geofence rules run VECTORIZED inside the
fused pjit step (ops/threshold.py, ops/geofence.py) — that is the 1M ev/s
path. This module is the *extension point* for arbitrary Python rule logic
at control-plane rates, same SPI shape as the reference.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert, DeviceCommandInvocation,
    DeviceCommandResponse, DeviceEvent, DeviceEventContext, DeviceLocation,
    DeviceMeasurement, DeviceStateChange, dispatch_event)
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.rules")


class RuleProcessor(LifecycleComponent):
    """Base rule processor (RuleProcessor.java:31): override the hooks."""

    def __init__(self, processor_id: str):
        super().__init__(f"rule-processor:{processor_id}")
        self.processor_id = processor_id

    def process(self, context: DeviceEventContext, event: DeviceEvent) -> None:
        dispatch_event(self, context, event)

    # no-op hooks (RuleProcessor.java:58-77)
    def on_measurement(self, context, event: DeviceMeasurement) -> None: ...
    def on_location(self, context, event: DeviceLocation) -> None: ...
    def on_alert(self, context, event: DeviceAlert) -> None: ...
    def on_command_invocation(self, context,
                              event: DeviceCommandInvocation) -> None: ...
    def on_command_response(self, context,
                            event: DeviceCommandResponse) -> None: ...
    def on_state_change(self, context, event: DeviceStateChange) -> None: ...
    def on_stream_data(self, context, event) -> None: ...


class RuleProcessorHost(LifecycleComponent):
    """Own consumer group on the enriched topic per processor
    (KafkaRuleProcessorHost.java:47,:78)."""

    def __init__(self, bus: EventBus, processor: RuleProcessor,
                 tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"rule-host:{processor.processor_id}")
        self.bus = bus
        self.processor = processor
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.add_nested(processor)
        m = (metrics or MetricsRegistry()).scoped(
            f"rules.{processor.processor_id}")
        self.processed_meter = m.meter("processed")
        self.failed_counter = m.counter("failed")
        self._host = ConsumerHost(
            bus, self.naming.inbound_enriched_events(tenant),
            group_id=f"rule-processor-{processor.processor_id}-{tenant}",
            handler=self.process)

    def on_start(self, monitor) -> None:
        self._host.start()

    def on_stop(self, monitor) -> None:
        self._host.stop()

    def process(self, records: List[Record]) -> None:
        """attemptToProcess :144 per record; public for synchronous tests."""
        # deferred: the pipeline package imports ops/stateful.py, which
        # imports this package's compiler — a module-level import here
        # closes that cycle whenever ops.stateful is imported first
        from sitewhere_tpu_torch.pipeline.enrichment import unpack_enriched
        for record in records:
            try:
                context, event = unpack_enriched(record.value)
            except Exception:
                self.failed_counter.inc()
                continue
            try:
                self.processor.process(context, event)
                self.processed_meter.mark(1)
            except Exception:
                self.failed_counter.inc()
                LOGGER.exception("rule processor %s failed",
                                 self.processor.processor_id)


class ScriptedRuleProcessor(RuleProcessor):
    """User-script rule processor (the reference's Groovy rule processor
    role): every enriched event dispatches to the script's entry callable
    `(context, event)`. Wired from the rule management surface with a
    hot-swappable ScriptManager proxy (runtime/scripts.py resolve), so
    activating a new script version retargets live processors.

    HOST-LOCAL and non-durable by design: the processor wraps a live
    Python callable on THIS process; it re-installs from config at boot
    (`__main__._apply_scripted_rule`) but, unlike fused rules, is not
    checkpointed or gossiped. `script_id` records which script backs it
    (operator audit surface)."""

    def __init__(self, processor_id: str, handler,
                 script_id: str = ""):
        super().__init__(processor_id)
        self.handler = handler
        self.script_id = script_id

    def process(self, context: DeviceEventContext,
                event: DeviceEvent) -> None:
        self.handler(context, event)


class RuleProcessorsManager(LifecycleComponent):
    """Hosts all rule processors of one tenant (RuleProcessorsManager)."""

    def __init__(self, bus: EventBus, tenant: str = "default",
                 naming: Optional[TopicNaming] = None):
        super().__init__("rule-processors-manager")
        self.bus = bus
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.hosts: List[RuleProcessorHost] = []

    def add_processor(self, processor: RuleProcessor) -> RuleProcessorHost:
        """Install a processor; atomic duplicate-id check, and live start
        when the manager is running (REST rule management). A failed live
        start rolls the install back so a retry is not met with a
        duplicate error for a rule that never ran. Mutations hold the
        component _lock — lifecycle start/stop iterate _nested under it."""
        from sitewhere_tpu_torch.errors import DuplicateTokenError

        host = RuleProcessorHost(self.bus, processor, self.tenant, self.naming)
        with self._lock:
            if any(h.processor.processor_id == processor.processor_id
                   for h in self.hosts):
                raise DuplicateTokenError(
                    f"rule processor '{processor.processor_id}' already "
                    f"exists")
            self.hosts.append(host)
            self._nested.append(host)
            if host.tenant_id is None:  # add_nested's propagation
                host.tenant_id = self.tenant_id
            live = self.is_running()
        if live:
            try:
                host.start()
            except Exception:
                with self._lock:
                    if host in self.hosts:
                        self.hosts.remove(host)
                    if host in self._nested:
                        self._nested.remove(host)
                raise
        return host

    def get_processor(self, processor_id: str) -> Optional[RuleProcessor]:
        with self._lock:
            for host in self.hosts:
                if host.processor.processor_id == processor_id:
                    return host.processor
        return None

    def list_processors(self) -> List[RuleProcessorHost]:
        with self._lock:
            return list(self.hosts)

    def remove_processor(self, processor_id: str) -> bool:
        """Stop + detach one processor's host (live uninstall)."""
        with self._lock:
            target = None
            for host in self.hosts:
                if host.processor.processor_id == processor_id:
                    target = host
                    break
            if target is None:
                return False
            self.hosts.remove(target)
            if target in self._nested:
                self._nested.remove(target)
        target.stop()  # outside the lock: stop joins consumer threads
        return True


def point_in_polygon(lat: float, lon: float,
                     vertices: np.ndarray) -> bool:
    """Crossing-number containment for one point against [N,2] (lat,lon)
    vertices — the scalar twin of ops/geofence.points_in_zones."""
    inside = False
    n = len(vertices)
    for i in range(n):
        y1, x1 = vertices[i]
        y2, x2 = vertices[(i + 1) % n]
        if (x1 > lon) != (x2 > lon):
            t = (lon - x1) / (x2 - x1)
            if lat < y1 + t * (y2 - y1):
                inside = not inside
    return inside


class ZoneTestRuleProcessor(RuleProcessor):
    """Geofence rule at the extension point (ZoneTestRuleProcessor.java:33):
    per-location containment test against a cached zone polygon, firing a
    DeviceAlert through event management on condition match.

    Prefer the fused GeofenceRule (pipeline/engine.py) for volume; this
    exists for SPI parity and custom per-event logic.
    """

    def __init__(self, processor_id: str, registry, events,
                 zone_token: str, condition: str = "outside",
                 alert_type: str = "zone.violation",
                 alert_level: AlertLevel = AlertLevel.WARNING,
                 alert_message: str = ""):
        super().__init__(processor_id)
        self.registry = registry
        self.events = events
        self.zone_token = zone_token
        self.condition = condition
        self.alert_type = alert_type
        self.alert_level = alert_level
        self.alert_message = alert_message
        self._polygon: Optional[np.ndarray] = None  # getZonePolygon :72 cache

    def _zone_polygon(self) -> np.ndarray:
        if self._polygon is None:
            zone = self.registry.get_zone_by_token(self.zone_token)
            self._polygon = np.array(
                [(p.latitude, p.longitude) for p in zone.bounds], np.float64)
        return self._polygon

    def on_location(self, context, event: DeviceLocation) -> None:
        contained = point_in_polygon(event.latitude, event.longitude,
                                     self._zone_polygon())
        fired = contained if self.condition == "inside" else not contained
        if fired:
            self.events.add_alerts(context.assignment_id, DeviceAlert(
                device_id=context.device_token, source=AlertSource.SYSTEM,
                level=self.alert_level, type=self.alert_type,
                message=self.alert_message or
                f"zone condition '{self.condition}' met for {self.zone_token}",
                event_date=event.event_date))
