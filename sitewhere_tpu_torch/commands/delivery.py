"""Command delivery service: enriched command invocations -> devices.

Reference call stack (SURVEY.md §3.4): EnrichedCommandInvocationsConsumer ->
DefaultCommandProcessingStrategy (resolve IDeviceCommand, build execution) ->
CommandRoutingLogic / target resolution -> OutboundCommandRouter ->
CommandDestination (encode + extract params + deliver). Failures land on the
undelivered-command-invocations topic (KafkaTopicNaming.java:69).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from sitewhere_tpu_torch.commands.destinations import CommandDestination
from sitewhere_tpu_torch.commands.encoding import (
    CommandExecution, SystemCommand, coerce_parameters)
from sitewhere_tpu_torch.commands.routing import CommandRouter, SingleDestinationRouter
from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.device import Device, DeviceAssignment
from sitewhere_tpu_torch.model.event import CommandTarget, DeviceCommandInvocation
from sitewhere_tpu_torch.pipeline.enrichment import unpack_enriched
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

LOGGER = logging.getLogger("sitewhere.commands")


class CommandProcessingStrategy:
    """Resolve the invocation into an executable command
    (DefaultCommandProcessingStrategy.java)."""

    def __init__(self, registry):
        self.registry = registry

    def create_execution(self, invocation: DeviceCommandInvocation
                         ) -> CommandExecution:
        command = None
        if invocation.command_token:
            command = self.registry.device_commands.get_by_token(
                invocation.command_token)
        if command is None and invocation.device_command_id:
            command = self.registry.device_commands.get(
                invocation.device_command_id)
        if command is None:
            raise SiteWhereError(
                f"invocation references unknown command "
                f"'{invocation.command_token or invocation.device_command_id}'")
        parameters = coerce_parameters(command, invocation.parameter_values)
        return CommandExecution(invocation=invocation, command=command,
                                parameters=parameters)


class TargetResolver:
    """Resolve invocation target to (device, assignment) pairs
    (the reference's CommandTargetResolver; only ASSIGNMENT targets exist
    in 2.0 — CommandTarget in sitewhere.proto)."""

    def __init__(self, registry):
        self.registry = registry

    def resolve(self, invocation: DeviceCommandInvocation
                ) -> List[Tuple[Device, DeviceAssignment]]:
        if invocation.target != CommandTarget.ASSIGNMENT:
            raise SiteWhereError(f"unsupported target {invocation.target}")
        token = invocation.target_id or invocation.device_assignment_id
        assignment = self.registry.get_device_assignment_by_token(token)
        if assignment is None:
            raise SiteWhereError(f"unknown assignment '{token}'")
        device = self.registry.get_device(assignment.device_id)
        return [(device, assignment)]


class CommandDeliveryService(LifecycleComponent):
    """Tenant-scoped command delivery engine (CommandDeliveryTenantEngine).

    Consumes inbound-enriched-command-invocations, resolves + routes +
    delivers; also the entry point for system commands (registration acks).
    """

    def __init__(self, bus: EventBus, registry, tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 router: Optional[CommandRouter] = None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"command-delivery:{tenant}")
        self.bus = bus
        self.registry = registry
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.strategy = CommandProcessingStrategy(registry)
        self.targets = TargetResolver(registry)
        self.router = router
        self.destinations: Dict[str, CommandDestination] = {}
        m = (metrics or MetricsRegistry()).scoped("commands")
        self.delivered_meter = m.meter("delivered")
        self.undelivered_counter = m.counter("undelivered")
        self._host = ConsumerHost(
            bus, self.naming.inbound_enriched_command_invocations(tenant),
            group_id=f"command-delivery-{tenant}", handler=self._process)

    # -- wiring ------------------------------------------------------------
    def add_destination(self, destination: CommandDestination) -> None:
        self.destinations[destination.destination_id] = destination
        self.add_nested(destination)
        if self.router is None:  # first destination becomes the default route
            self.router = SingleDestinationRouter(destination.destination_id)

    def on_start(self, monitor) -> None:
        self._host.start()

    def on_stop(self, monitor) -> None:
        self._host.stop()

    # -- delivery ----------------------------------------------------------
    def _process(self, records: List[Record]) -> None:
        for record in records:
            try:
                _, event = unpack_enriched(record.value)
            except Exception as exc:
                self._park_undelivered(record, f"undecodable payload: {exc}")
                continue
            if not isinstance(event, DeviceCommandInvocation):
                continue
            try:
                self.deliver(event)
            except Exception as exc:
                self._park_undelivered(record, str(exc))

    def deliver(self, invocation: DeviceCommandInvocation) -> None:
        """Synchronous delivery path, also callable directly (tests, REST)."""
        from sitewhere_tpu_torch.commands.encoding import calculate_nesting

        execution = self.strategy.create_execution(invocation)
        for device, assignment in self.targets.resolve(invocation):
            # composite targets deliver THROUGH their gateway
            # (DefaultCommandProcessingStrategy.java:74); routing selects
            # the destination by the GATEWAY's device type — the transport
            # that physically carries the frame
            # (DeviceTypeMappingCommandRouter routes on the gateway)
            nesting = calculate_nesting(self.registry, device)
            for destination in self._route(execution, nesting.gateway,
                                           assignment):
                destination.deliver_command(execution, device, assignment,
                                            nesting=nesting)
                self.delivered_meter.mark(1)

    def send_system_command(self, device_token: str,
                            command: SystemCommand) -> None:
        """Deliver a system message (e.g. registration ack) to one device
        (CommandRoutingLogic.routeSystemCommand)."""
        from sitewhere_tpu_torch.commands.encoding import calculate_nesting

        device = self.registry.get_device_by_token(device_token)
        if device is None:
            raise SiteWhereError(f"unknown device '{device_token}'")
        # composite children receive system traffic (registration acks)
        # through their gateway's transport, like regular commands
        nesting = calculate_nesting(self.registry, device)
        for destination in self._route(None, nesting.gateway, None):
            destination.deliver_system_command(command, device,
                                               nesting=nesting)

    def _route(self, execution: Optional[CommandExecution], device: Device,
               assignment: Optional[DeviceAssignment]
               ) -> List[CommandDestination]:
        if self.router is None:
            raise SiteWhereError("no command destinations configured")
        return self.router.route(execution, device, assignment,
                                 self.destinations)

    def _park_undelivered(self, record: Record, reason: str) -> None:
        self.undelivered_counter.inc()
        LOGGER.warning("undelivered command invocation: %s", reason)
        self.bus.publish(
            self.naming.undelivered_command_invocations(self.tenant),
            record.key, record.value)
