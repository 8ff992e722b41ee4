"""Outbound command routers: pick the destination for an execution.

Reference: service-command-delivery routing/ — IOutboundCommandRouter with
DeviceTypeMappingCommandRouter (map device-type token -> destination id with
a fallback) and the single-destination NoOpCommandRouter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol

from sitewhere_tpu_torch.commands.destinations import CommandDestination
from sitewhere_tpu_torch.commands.encoding import CommandExecution
from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.device import Device, DeviceAssignment


class CommandRouter(Protocol):
    def route(self, execution: Optional[CommandExecution], device: Device,
              assignment: Optional[DeviceAssignment],
              destinations: Dict[str, CommandDestination]
              ) -> List[CommandDestination]: ...


class SingleDestinationRouter:
    """Route everything to one destination (the implicit default when a
    tenant configures exactly one destination)."""

    def __init__(self, destination_id: str):
        self.destination_id = destination_id

    def route(self, execution, device, assignment, destinations):
        if self.destination_id not in destinations:
            raise SiteWhereError(
                f"unknown command destination '{self.destination_id}'")
        return [destinations[self.destination_id]]


class DeviceTypeMappingRouter:
    """Map device-type token -> destination id, with optional default
    (DeviceTypeMappingCommandRouter.java). Needs the registry to resolve the
    device's type token from its id."""

    def __init__(self, registry, mappings: Dict[str, str],
                 default_destination: Optional[str] = None):
        self.registry = registry
        self.mappings = dict(mappings)
        self.default_destination = default_destination

    def route(self, execution, device, assignment, destinations):
        device_type = self.registry.get_device_type(device.device_type_id)
        destination_id = self.mappings.get(
            device_type.token if device_type else "",
            self.default_destination)
        if destination_id is None:
            raise SiteWhereError(
                f"no destination mapping for device type of '{device.token}'")
        if destination_id not in destinations:
            raise SiteWhereError(
                f"unknown command destination '{destination_id}'")
        return [destinations[destination_id]]


class BroadcastRouter:
    """Deliver to every destination — useful for redundant transports."""

    def route(self, execution, device, assignment, destinations):
        return list(destinations.values())
