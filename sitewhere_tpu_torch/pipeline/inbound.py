"""Inbound processing: decoded events -> validate -> persist -> device step.

Reference: service-inbound-processing — DecodedEventsConsumer.java:38 reads
event-source-decoded-events, InboundPayloadProcessingLogic.java:91-197
validates device + active assignment (gRPC lookups in the reference; registry
dict lookups here), unregistered devices route to
inbound-unregistered-device-events, and UnaryEventStorageStrategy.java:54
persists each event through event management.

Difference: persistence and rule/state processing are NOT two more
microservice hops. One consumer batch is (a) persisted through
DeviceEventManagement (whose triggers feed the persisted->enriched topics for
control-plane consumers) and (b) packed into a fixed-width EventBatch and
submitted to the engine's step, which does rule-eval + device-state in one
captured step. Rule alerts are materialized host-side and persisted as system
events, closing the loop the reference runs through three services.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import msgpack

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.event import (
    DeviceAlert, DeviceCommandResponse, DeviceEvent, DeviceEventBatch,
    DeviceLocation, DeviceMeasurement, DeviceStreamData, event_from_dict)
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.recovery import GLOBAL_REPLAY_BARRIER

LOGGER = logging.getLogger("sitewhere.inbound")


def _events_from_request(kind: str, request: Dict[str, Any]) -> List[DeviceEvent]:
    """Rebuild API events from a decoded-request payload (sources/manager
    _pack_request's `request` dict)."""
    if kind == "DeviceEventBatch":
        events: List[DeviceEvent] = []
        for group in ("measurements", "locations", "alerts"):
            for data in request.get(group, []):
                events.append(event_from_dict(data))
        return events
    if kind in ("DeviceCommandResponse", "DeviceStreamData"):
        return [event_from_dict(request)]
    raise SiteWhereError(f"unsupported decoded request kind '{kind}'")


class InboundProcessingService(LifecycleComponent):
    """Tenant-scoped inbound processor (InboundProcessingTenantEngine).

    `engine` is a PipelineEngine; `events` is the tenant's
    DeviceEventManagement. Either may be None for partial wiring (e.g.
    persist-only during replay). `batcher` is the latency tier's shared
    AdaptiveBatcher (pipeline/feed.py). The reference's multi-host hooks
    (`cluster`: ownership routing, lockstep feeding) come with the
    multi-host data plane (ROADMAP A6d); passing them raises.
    """

    def __init__(self, bus: EventBus, registry, events=None, engine=None,
                 tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 cluster=None,
                 batcher=None,
                 persist_rule_alerts: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"inbound-processing:{tenant}")
        if cluster is not None:
            raise NotImplementedError(
                "multi-host inbound hooks (ownership routing, lockstep "
                "feeding) come with the multi-host data plane: ROADMAP A6d")
        self.bus = bus
        self.registry = registry
        self.events = events
        self.engine = engine
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.persist_rule_alerts = persist_rule_alerts
        # latency tier (pipeline.mode="latency"): hot events route through
        # the shared AdaptiveBatcher (pipeline/feed.py) instead of packing
        # a per-consumer-poll batch — offers coalesce across tenants and
        # flush on fill or linger, bounding ingest->alert wall time
        self.batcher = batcher
        m = (metrics or MetricsRegistry()).scoped("inbound")
        self.processed_meter = m.meter("processed")
        self.unregistered_counter = m.counter("unregistered")
        self.failed_counter = m.counter("failed")
        self.dead_letter_counter = m.counter("step_dead_lettered")
        self._host = ConsumerHost(
            bus, self.naming.event_source_decoded_events(tenant),
            group_id=f"inbound-processing-{tenant}", handler=self.process)
        # the reprocess loop is a first-class pipeline input (reference:
        # KafkaTopicNaming.java:48-69): records an operator replays from a
        # dead-letter topic (runtime/deadletter.py) re-enter here with the
        # same validate -> persist -> fused-step handling
        self._reprocess_host = ConsumerHost(
            bus, self.naming.inbound_reprocess_events(tenant),
            group_id=f"inbound-reprocess-{tenant}", handler=self.process)

    def on_start(self, monitor) -> None:
        self._host.start()
        self._reprocess_host.start()

    def on_stop(self, monitor) -> None:
        self._reprocess_host.stop()
        self._host.stop()

    # -- processing --------------------------------------------------------
    def process(self, records: List[Record]) -> None:
        """One consumer batch end-to-end. Public so replay/tests can drive
        it synchronously without the poll thread."""
        hot: List[Tuple[DeviceEvent, str]] = []
        hot_records: List[Record] = []
        replay_all: Optional[bool] = None  # every hot record suppressed?
        for record in records:
            try:
                data = msgpack.unpackb(record.value, raw=False)
                token = data.get("deviceToken", "")
                events = _events_from_request(data.get("kind", ""),
                                              data.get("request", {}))
            except Exception:
                self.failed_counter.inc()
                continue
            if not self._validate(token, record):
                continue
            # exactly-once effects under checkpoint replay
            # (runtime/recovery.py): while this tenant's replay budget
            # lasts, a record's events still rebuild device/rule/model
            # state (they join `hot`) but skip re-persisting — the rows
            # are already durable, and skipping the persist also skips
            # the trigger fan-out (enriched topics, command delivery,
            # analytics increments). A PARTIAL take at the budget
            # boundary persists anyway: at-least-once for that record,
            # with sequence-watermark dedup catching stamped stragglers.
            suppressed = False
            if events and GLOBAL_REPLAY_BARRIER.active(self.tenant):
                took = GLOBAL_REPLAY_BARRIER.take(self.tenant, len(events))
                suppressed = took >= len(events)
            if suppressed:
                persisted = list(events)
            else:
                persisted = self._persist(token, events)
            if persisted:
                hot_records.append(record)
                replay_all = suppressed if replay_all is None \
                    else (replay_all and suppressed)
            for event in persisted:
                hot.append((event, token))
            self.processed_meter.mark(len(persisted))
        if self.engine is not None and hot:
            # Never let the hot path poison the consumer: a raising handler
            # would redeliver the batch and re-persist duplicates forever.
            # A batch that exhausts the engine's dispatch retries parks on
            # the dead-letter topic instead (replayable via `deadletters
            # replay` -> the reprocess loop; re-persist on replay is
            # tolerated by the model's idempotent event ids) — every
            # offered event either materializes, parks, or is counted
            # shed, never silently lost.
            try:
                self._submit_hot(hot, suppress_effects=bool(replay_all))
            except Exception:
                self.failed_counter.inc()
                LOGGER.exception("fused step failed for batch of %d events",
                                 len(hot))
                self._park_hot(hot_records)

    def _park_hot(self, hot_records: List[Record]) -> None:
        """Park the source records of a step-poisoned batch on the decoded
        topic's dead-letter surface and mark the engine draining — the
        no-silent-loss half of the swallow above."""
        dlq = (self.naming.event_source_decoded_events(self.tenant)
               + ".dead-letter")
        for record in hot_records:
            self.bus.publish(dlq, record.key, record.value)
        self.dead_letter_counter.inc(len(hot_records))
        health = getattr(self.engine, "health", None)
        if health is not None:
            health.note_poison()

    def _validate(self, token: str, record: Record) -> bool:
        """Device + active-assignment check
        (InboundPayloadProcessingLogic.validateAssignment :156-193)."""
        device = self.registry.get_device_by_token(token)
        if device is None or self.registry.get_active_assignment(device.id) is None:
            self.unregistered_counter.inc()
            self.bus.publish(
                self.naming.inbound_unregistered_device_events(self.tenant),
                token.encode(), record.value)
            return False
        return True

    def _persist(self, token: str,
                 events: List[DeviceEvent]) -> List[DeviceEvent]:
        if self.events is None:
            return events
        try:
            batch = DeviceEventBatch(device_token=token)
            extra: List[DeviceEvent] = []
            for event in events:
                if isinstance(event, DeviceAlert):
                    batch.alerts.append(event)
                elif isinstance(event, DeviceMeasurement):
                    batch.measurements.append(event)
                elif isinstance(event, DeviceLocation):
                    batch.locations.append(event)
                else:
                    extra.append(event)
            persisted = self.events.add_device_event_batch(token, batch)
            if extra:
                device = self.registry.get_device_by_token(token)
                assignment = self.registry.get_active_assignment(device.id)
                for event in extra:
                    if isinstance(event, DeviceCommandResponse):
                        persisted.extend(self.events.add_command_responses(
                            assignment.token, event))
                    else:
                        persisted.extend(self.events.add_stream_data(
                            assignment.token, event))
            return persisted
        except Exception:
            self.failed_counter.inc()
            LOGGER.exception("persist failed for device '%s'", token)
            return []

    def _submit_hot(self, hot: List[Tuple[DeviceEvent, str]],
                    suppress_effects: bool = False) -> None:
        """Pack + run the fused step; rule alerts feed back into persistence
        (the reference's ZoneTestRuleProcessor -> addDeviceAlerts loop).

        `suppress_effects` (replay barrier): the step still runs — the
        replayed events must rebuild rule/device state — but the derived
        alerts fired the first time around, so their persist + fan-out
        is skipped for an all-replay batch."""
        events = [e for e, _ in hot]
        tokens = [t for _, t in hot]
        if self.batcher is not None:
            # latency tier: coalesce into the shared adaptive batcher and
            # wait for the flush (so consumer commit still means "reached
            # device state", the same contract as the direct path)
            pairs = self.batcher.offer(events, tokens).result(timeout=60.0)
        else:
            pairs = (self.engine.submit_routed(batch)
                     for batch in self.engine.packer.pack_events(events,
                                                                 tokens))
        for batch, outputs in pairs:
            if not self.persist_rule_alerts or self.events is None \
                    or suppress_effects:
                continue
            for alert in self.engine.materialize_alerts(batch, outputs):
                device = self.registry.get_device_by_token(alert.device_id)
                if device is None:
                    continue
                assignment = self.registry.get_active_assignment(device.id)
                if assignment is None:
                    continue
                self.events.add_alerts(assignment.token, alert)
