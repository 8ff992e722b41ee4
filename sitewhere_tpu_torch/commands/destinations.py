"""Command destinations: encoder + parameter extractor + delivery provider.

Reference: service-command-delivery destination/ — a CommandDestination
combines an ICommandExecutionEncoder, an ICommandDeliveryParameterExtractor
(e.g. MqttParameterExtractor building per-device topic names) and an
ICommandDeliveryProvider (MqttCommandDeliveryProvider.java, CoAP, SMS).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from sitewhere_tpu_torch.commands.encoding import (
    CommandEncoder, CommandExecution, SystemCommand, WireCommandEncoder)
from sitewhere_tpu_torch.model.device import Device, DeviceAssignment
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.sources.receivers import EventLoopThread
from sitewhere_tpu_torch.transport.coap import CoapClient
from sitewhere_tpu_torch.transport.mqtt import MqttClient

LOGGER = logging.getLogger("sitewhere.commands")


class ParameterExtractor(Protocol):
    """Compute per-delivery routing parameters (topic/path/phone number)."""

    def extract(self, device: Device,
                assignment: Optional[DeviceAssignment]) -> Dict[str, str]: ...


class MqttParameterExtractor:
    """Default topic scheme: commands on SW/{device}/command, system
    messages on SW/{device}/system (DefaultMqttParameterExtractor's
    {command,system}Topic expressions)."""

    def __init__(self, command_topic: str = "SW/{token}/command",
                 system_topic: str = "SW/{token}/system"):
        self.command_topic = command_topic
        self.system_topic = system_topic

    def extract(self, device: Device,
                assignment: Optional[DeviceAssignment]) -> Dict[str, str]:
        return {
            "commandTopic": self.command_topic.format(token=device.token),
            "systemTopic": self.system_topic.format(token=device.token),
        }


class MetadataParameterExtractor:
    """Read routing parameters straight from device metadata (the pattern
    CoapMetadataParameterExtractor uses for per-device host/port)."""

    def __init__(self, keys: Dict[str, str],
                 defaults: Optional[Dict[str, str]] = None):
        self.keys = keys  # param name -> metadata key
        self.defaults = defaults or {}

    def extract(self, device: Device,
                assignment: Optional[DeviceAssignment]) -> Dict[str, str]:
        out = dict(self.defaults)
        for name, meta_key in self.keys.items():
            if meta_key in device.metadata:
                out[name] = device.metadata[meta_key]
        return out


class DeliveryProvider(Protocol):
    def deliver(self, device: Device, encoded: bytes,
                parameters: Dict[str, str]) -> None: ...

    def deliver_system(self, device: Device, encoded: bytes,
                       parameters: Dict[str, str]) -> None: ...


class MqttDeliveryProvider(LifecycleComponent):
    """Publish encoded commands to the device's MQTT topics
    (MqttCommandDeliveryProvider.java)."""

    def __init__(self, host: str, port: int,
                 client_id: Optional[str] = None,
                 loop_thread: Optional[EventLoopThread] = None):
        super().__init__("mqtt-delivery")
        self.host = host
        self.port = port
        # unique default: two providers on one broker must not take over
        # each other's MQTT session
        from sitewhere_tpu_torch.model.common import new_id
        self.client_id = client_id or f"command-delivery-{new_id()[:8]}"
        self._loop_thread = loop_thread
        self._client: Optional[MqttClient] = None

    @property
    def loop_thread(self) -> EventLoopThread:
        if self._loop_thread is None:
            self._loop_thread = EventLoopThread.shared()
        return self._loop_thread

    def on_start(self, monitor) -> None:
        client = MqttClient(self.host, self.port, client_id=self.client_id)
        self.loop_thread.run(client.connect())
        self._client = client

    def on_stop(self, monitor) -> None:
        if self._client is not None:
            self.loop_thread.run(self._client.disconnect())
            self._client = None

    def _publish(self, topic: str, payload: bytes) -> None:
        if self._client is None:
            raise RuntimeError("mqtt delivery provider not started")
        self.loop_thread.run(self._client.publish(topic, payload))

    def deliver(self, device: Device, encoded: bytes,
                parameters: Dict[str, str]) -> None:
        self._publish(parameters["commandTopic"], encoded)

    def deliver_system(self, device: Device, encoded: bytes,
                       parameters: Dict[str, str]) -> None:
        self._publish(parameters["systemTopic"], encoded)


class CoapDeliveryProvider(LifecycleComponent):
    """POST encoded commands to the device's CoAP endpoint; host/port/paths
    come from extractor parameters (CoapCommandDeliveryProvider.java)."""

    def __init__(self, loop_thread: Optional[EventLoopThread] = None,
                 confirmable: bool = True):
        super().__init__("coap-delivery")
        self._loop_thread = loop_thread
        self.confirmable = confirmable

    @property
    def loop_thread(self) -> EventLoopThread:
        if self._loop_thread is None:
            self._loop_thread = EventLoopThread.shared()
        return self._loop_thread

    def _post(self, parameters: Dict[str, str], path: str,
              payload: bytes) -> None:
        client = CoapClient(parameters["host"], int(parameters["port"]))
        self.loop_thread.run(
            client.post(path, payload, confirmable=self.confirmable))

    def deliver(self, device: Device, encoded: bytes,
                parameters: Dict[str, str]) -> None:
        self._post(parameters, parameters.get("commandPath", "command"),
                   encoded)

    def deliver_system(self, device: Device, encoded: bytes,
                       parameters: Dict[str, str]) -> None:
        self._post(parameters, parameters.get("systemPath", "system"),
                   encoded)


class SmsParameterExtractor:
    """Phone number from device metadata (the reference's
    SmsParameterExtractor resolves per-device SMS routing the same way)."""

    def __init__(self, phone_metadata_key: str = "sms.phone"):
        self.phone_metadata_key = phone_metadata_key

    def extract(self, device: Device,
                assignment: Optional[DeviceAssignment]) -> Dict[str, str]:
        phone = device.metadata.get(self.phone_metadata_key, "")
        return {"phone": phone}


class SmsDeliveryProvider(LifecycleComponent):
    """Deliver encoded commands as SMS messages
    (destination/sms/SmsCommandDestination.java + Twilio provider).

    Gated like the broker adapters: the Twilio client library is optional
    in this image, so constructing with no `send_fn` requires it at start
    (require_optional -> clear 501). A custom `send_fn(to, from_, body)`
    plugs in any SMS gateway (and makes the provider testable in-proc).
    Binary payloads ride base64; textual payloads go through as-is."""

    def __init__(self, account_sid: str = "", auth_token: str = "",
                 from_number: str = "",
                 send_fn: Optional[Callable[[str, str, str], None]] = None):
        super().__init__("sms-delivery")
        self.account_sid = account_sid
        self.auth_token = auth_token
        self.from_number = from_number
        self._send_fn = send_fn

    def on_start(self, monitor) -> None:
        if self._send_fn is None:
            from sitewhere_tpu_torch.sources.receivers_ext import require_optional
            twilio_rest = require_optional("twilio.rest", "Twilio SMS")
            client = twilio_rest.Client(self.account_sid, self.auth_token)

            def send(to: str, from_: str, body: str) -> None:
                client.messages.create(to=to, from_=from_, body=body)

            self._send_fn = send

    @staticmethod
    def _as_text(encoded: bytes) -> str:
        # Always prefixed ("txt:" / "b64:"): an unprefixed scheme would be
        # ambiguous — a binary frame that happens to decode as UTF-8 would
        # arrive looking like text, and the device couldn't tell which
        # decoding to apply.
        try:
            return "txt:" + encoded.decode("utf-8")
        except UnicodeDecodeError:
            import base64
            return "b64:" + base64.b64encode(encoded).decode("ascii")

    def _send(self, device: Device, encoded: bytes,
              parameters: Dict[str, str]) -> None:
        if self._send_fn is None:
            raise RuntimeError("sms delivery provider not started")
        phone = parameters.get("phone", "")
        if not phone:
            from sitewhere_tpu_torch.errors import SiteWhereError
            raise SiteWhereError(
                f"device {device.token} has no SMS phone number metadata")
        self._send_fn(phone, self.from_number, self._as_text(encoded))

    def deliver(self, device: Device, encoded: bytes,
                parameters: Dict[str, str]) -> None:
        self._send(device, encoded, parameters)

    def deliver_system(self, device: Device, encoded: bytes,
                       parameters: Dict[str, str]) -> None:
        self._send(device, encoded, parameters)


class InProcDeliveryProvider(LifecycleComponent):
    """Hand deliveries to a Python callback — used by tests and by co-located
    device simulators (no reference equivalent needed: the in-proc path)."""

    def __init__(self, callback: Optional[Callable[..., None]] = None):
        super().__init__("inproc-delivery")
        self.callback = callback
        self.delivered: List[Tuple[str, bytes, Dict[str, str]]] = []
        self.system: List[Tuple[str, bytes, Dict[str, str]]] = []

    def deliver(self, device: Device, encoded: bytes,
                parameters: Dict[str, str]) -> None:
        self.delivered.append((device.token, encoded, parameters))
        if self.callback:
            self.callback("command", device, encoded, parameters)

    def deliver_system(self, device: Device, encoded: bytes,
                       parameters: Dict[str, str]) -> None:
        self.system.append((device.token, encoded, parameters))
        if self.callback:
            self.callback("system", device, encoded, parameters)


class CommandDestination(LifecycleComponent):
    """One fully-wired delivery path (ICommandDestination): encoder +
    parameter extractor + delivery provider, addressed by id from routers."""

    def __init__(self, destination_id: str,
                 provider: DeliveryProvider,
                 encoder: Optional[CommandEncoder] = None,
                 extractor: Optional[ParameterExtractor] = None):
        super().__init__(f"command-destination:{destination_id}")
        self.destination_id = destination_id
        self.encoder = encoder or WireCommandEncoder()
        self.extractor = extractor or MqttParameterExtractor()
        self.provider = provider
        self._encoder_accepts_nesting: Optional[bool] = None
        if isinstance(provider, LifecycleComponent):
            self.add_nested(provider)

    def deliver_command(self, execution: CommandExecution, device: Device,
                        assignment: Optional[DeviceAssignment],
                        nesting=None) -> None:
        """Encode + extract + deliver. With a nesting context the
        TRANSPORT addresses the gateway (its MQTT topic / CoAP endpoint /
        phone number) while the payload addresses the nested target —
        CommandDestination.deliverCommand:60 passing nesting to both the
        encoder and the parameter extractor."""
        encoded = self._encode(execution, device, assignment, nesting)
        transport_device = (nesting.gateway if nesting is not None
                            else device)
        parameters = self.extractor.extract(transport_device, assignment)
        self.provider.deliver(transport_device, encoded, parameters)

    def _encode(self, execution, device, assignment, nesting) -> bytes:
        if nesting is None:
            return self.encoder.encode(execution, device, assignment)
        accepts = self._encoder_accepts_nesting
        if accepts is None:
            # resolved once per destination: third-party encoders may
            # predate the nesting-aware CommandEncoder protocol
            import inspect
            try:
                accepts = "nesting" in inspect.signature(
                    self.encoder.encode).parameters
            except (TypeError, ValueError):
                accepts = False
            self._encoder_accepts_nesting = accepts
        if accepts:
            return self.encoder.encode(execution, device, assignment,
                                       nesting=nesting)
        # encoder predates the nesting-aware protocol: deliver without
        # payload-level nesting (gateway addressing still applies)
        return self.encoder.encode(execution, device, assignment)

    def deliver_system_command(self, command: SystemCommand,
                               device: Device, nesting=None) -> None:
        """System payloads always name the TARGET device; with a nesting
        context the transport (topic/endpoint/phone) addresses the
        gateway that physically carries it — same split as
        deliver_command."""
        encoded = self.encoder.encode_system(command, device)
        transport_device = (nesting.gateway if nesting is not None
                            else device)
        parameters = self.extractor.extract(transport_device, None)
        self.provider.deliver_system(transport_device, encoded, parameters)
