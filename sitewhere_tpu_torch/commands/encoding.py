"""Command encoders: CommandExecution -> on-the-wire bytes for a device.

Reference: service-command-delivery encoders — per-device-type protobuf via
ProtobufMessageBuilder (sitewhere-communication
protobuf/ProtobufMessageBuilder.java), Groovy scripted encoders, and
JSON encoders. Here the wire encoder emits COMMAND frames of the framework's
device wire protocol (transport/wire.py), the JSON encoder emits plain JSON
for HTTP-ish devices, and the scripted encoder takes any Python callable —
the Groovy extension point without a JVM.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Protocol

from sitewhere_tpu_torch.model.device import Device, DeviceAssignment, DeviceCommand
from sitewhere_tpu_torch.model.event import DeviceCommandInvocation
from sitewhere_tpu_torch.transport.wire import MessageType, WireCodec, encode_frame


@dataclass
class CommandExecution:
    """A resolved invocation ready to encode (IDeviceCommandExecution):
    the invocation event + the command definition + coerced parameters."""

    invocation: DeviceCommandInvocation
    command: DeviceCommand
    parameters: Dict[str, str] = field(default_factory=dict)


@dataclass
class SystemCommand:
    """Cloud->device system message (non-invocation), e.g. a registration
    ack (Device.Command.ACK_REGISTRATION in sitewhere.proto)."""

    message_type: MessageType
    payload: bytes


@dataclass
class DeviceNestingContext:
    """How to address the target through its gateway
    (IDeviceNestingContext; commands/NestedDeviceSupport.java:69). For a
    standalone device the gateway IS the target and `nested` is None;
    for a composite-mapped device the transport delivers to `gateway`
    and the payload addresses `nested` at the schema `path`."""

    gateway: Device
    nested: Optional[Device] = None
    path: str = ""

    @property
    def target(self) -> Device:
        return self.nested if self.nested is not None else self.gateway


def calculate_nesting(registry, target: Device) -> DeviceNestingContext:
    """NestedDeviceSupport.calculateNestedDeviceInformation:32 — resolve
    the gateway whose transport physically carries the target's traffic;
    fall back to the target as its own gateway when unparented (or
    unmapped, which the reference treats the same way).

    Multi-level composites (A hosts B hosts C) resolve to the ROOT
    unparented ancestor — only the root has a physical connection — with
    the schema paths of every hop joined into one address
    ("busA/slotB/busB/slotC")."""
    path_segments = []
    node = target
    seen = {target.id}
    while node.parent_device_id:
        if node.parent_device_id in seen:
            break  # corrupt cycle (replication race): stop at this node
        seen.add(node.parent_device_id)
        parent = registry.devices.get(node.parent_device_id)
        if parent is None:
            # dangling backreference (parent deleted out-of-band, e.g. a
            # replicated tombstone landing before the child update):
            # deliver to the highest resolvable ancestor rather than
            # failing the command
            break
        mapping = next((m for m in parent.device_element_mappings
                        if m.device_token == node.token), None)
        if mapping is None:
            break
        path_segments.append(mapping.device_element_schema_path)
        node = parent
    if node is target:
        return DeviceNestingContext(gateway=target)
    return DeviceNestingContext(
        gateway=node, nested=target,
        path="/".join(reversed(path_segments)))


class CommandEncoder(Protocol):
    def encode(self, execution: CommandExecution, device: Device,
               assignment: Optional[DeviceAssignment],
               nesting: Optional[DeviceNestingContext] = None) -> bytes: ...

    def encode_system(self, command: SystemCommand, device: Device) -> bytes: ...


class WireCommandEncoder:
    """Encode as wire-protocol frames — the default binary device SDK path
    (counterpart of ProtobufExecutionEncoder)."""

    def encode(self, execution: CommandExecution, device: Device,
               assignment: Optional[DeviceAssignment],
               nesting: Optional[DeviceNestingContext] = None) -> bytes:
        parameters = dict(execution.parameters)
        if nesting is not None and nesting.nested is not None:
            # gateway-addressed frame carrying the nested target: the
            # device-side dispatcher routes on these reserved keys
            parameters["_nestedPath"] = nesting.path
            parameters["_nestedToken"] = nesting.nested.token
        payload = WireCodec.encode_command(
            token=device.token, command=execution.command.name,
            parameters=parameters,
            invocation_id=execution.invocation.id)
        return encode_frame(MessageType.COMMAND, payload)

    def encode_system(self, command: SystemCommand, device: Device) -> bytes:
        return encode_frame(command.message_type, command.payload)


class JsonCommandEncoder:
    """Encode as a JSON document (JsonCommandExecutionEncoder)."""

    def encode(self, execution: CommandExecution, device: Device,
               assignment: Optional[DeviceAssignment],
               nesting: Optional[DeviceNestingContext] = None) -> bytes:
        doc = {
            "deviceToken": device.token,
            "command": execution.command.name,
            "namespace": execution.command.namespace,
            "invocationId": execution.invocation.id,
            "parameters": execution.parameters,
        }
        if nesting is not None and nesting.nested is not None:
            doc["nesting"] = {"gateway": nesting.gateway.token,
                              "nested": nesting.nested.token,
                              "path": nesting.path}
        return json.dumps(doc).encode("utf-8")

    def encode_system(self, command: SystemCommand, device: Device) -> bytes:
        return json.dumps({
            "deviceToken": device.token,
            "systemCommand": MessageType(command.message_type).name,
            "payload": command.payload.hex(),
        }).encode("utf-8")


class ScriptedCommandEncoder:
    """User-supplied callable `(execution, device, assignment) -> bytes`
    (GroovyCommandExecutionEncoder's extension point). Scripts that
    declare a `nesting` keyword receive the composite-delivery context;
    legacy three-argument scripts keep working."""

    def __init__(self, script: Callable[..., bytes],
                 system_script: Optional[Callable[..., bytes]] = None):
        self.script = script
        self.system_script = system_script
        import inspect
        try:
            self._script_accepts_nesting = "nesting" in \
                inspect.signature(script).parameters
        except (TypeError, ValueError):
            self._script_accepts_nesting = False

    def encode(self, execution: CommandExecution, device: Device,
               assignment: Optional[DeviceAssignment],
               nesting: Optional[DeviceNestingContext] = None) -> bytes:
        if self._script_accepts_nesting:
            return self.script(execution, device, assignment,
                               nesting=nesting)
        return self.script(execution, device, assignment)

    def encode_system(self, command: SystemCommand, device: Device) -> bytes:
        if self.system_script is None:
            return WireCommandEncoder().encode_system(command, device)
        return self.system_script(command, device)


def coerce_parameters(command: DeviceCommand,
                      values: Dict[str, Any]) -> Dict[str, str]:
    """Validate invocation parameter values against the command's declared
    parameters; required parameters must be present (the validation
    DefaultCommandProcessingStrategy performs before encoding)."""
    out: Dict[str, str] = {}
    declared = {p.name for p in command.parameters}
    for parameter in command.parameters:
        if parameter.name in values:
            out[parameter.name] = str(values[parameter.name])
        elif parameter.required:
            raise ValueError(
                f"missing required parameter '{parameter.name}' "
                f"for command '{command.name}'")
    for name, value in values.items():
        if name not in declared:  # pass through undeclared extras
            out[name] = str(value)
    return out
