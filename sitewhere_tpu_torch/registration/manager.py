"""Device auto-registration manager.

Reference: service-device-registration DefaultRegistrationManager.java:39 —
consumes inbound-device-registration-events (decoded registration requests
routed by the event sources, InboundEventSource -> registration topic) and
inbound-unregistered-device-events (events from devices the validation step
didn't recognize), creates device + assignment when allowed
(handleDeviceRegistration :81), and answers with a RegistrationAck system
command through command delivery (:226).
"""

from __future__ import annotations

import enum
import logging
from typing import List, Optional

import msgpack

from sitewhere_tpu_torch.errors import SiteWhereError
from sitewhere_tpu_torch.model.device import Device, DeviceAssignment
from sitewhere_tpu_torch.model.event import DeviceRegistrationRequest
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, EventBus, Record, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.transport.wire import MessageType, WireCodec

LOGGER = logging.getLogger("sitewhere.registration")


class RegistrationAckState(enum.Enum):
    """RegistrationAckState in sitewhere.proto:36-47."""

    NEW_REGISTRATION = "NEW_REGISTRATION"
    ALREADY_REGISTERED = "ALREADY_REGISTERED"
    REGISTRATION_ERROR = "REGISTRATION_ERROR"


class RegistrationManager(LifecycleComponent):
    """Per-tenant registration engine.

    Options mirror DefaultRegistrationManager: `allow_new_devices`, and
    fallback tokens used when a request omits its device type / area.
    `command_delivery` (a CommandDeliveryService) is optional — without it
    acks are only counted, not sent.
    """

    def __init__(self, bus: EventBus, registry, tenant: str = "default",
                 naming: Optional[TopicNaming] = None,
                 allow_new_devices: bool = True,
                 default_device_type_token: Optional[str] = None,
                 default_area_token: Optional[str] = None,
                 auto_assign: bool = True,
                 command_delivery=None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(f"registration:{tenant}")
        self.bus = bus
        self.registry = registry
        self.tenant = tenant
        self.naming = naming or TopicNaming()
        self.allow_new_devices = allow_new_devices
        self.default_device_type_token = default_device_type_token
        self.default_area_token = default_area_token
        self.auto_assign = auto_assign
        self.command_delivery = command_delivery
        m = (metrics or MetricsRegistry()).scoped("registration")
        self.registered_counter = m.counter("registered")
        self.rejected_counter = m.counter("rejected")
        self._registration_host = ConsumerHost(
            bus, self.naming.inbound_device_registration_events(tenant),
            group_id=f"registration-{tenant}", handler=self._process)
        self._unregistered_host = ConsumerHost(
            bus, self.naming.inbound_unregistered_device_events(tenant),
            group_id=f"registration-unreg-{tenant}",
            handler=self._process_unregistered)

    def on_start(self, monitor) -> None:
        self._registration_host.start()
        self._unregistered_host.start()

    def on_stop(self, monitor) -> None:
        self._registration_host.stop()
        self._unregistered_host.stop()

    # -- registration topic ------------------------------------------------
    def _process(self, records: List[Record]) -> None:
        for record in records:
            try:
                data = msgpack.unpackb(record.value, raw=False)
                request = DeviceRegistrationRequest(**{
                    k: v for k, v in data["request"].items()
                    if k in DeviceRegistrationRequest.__dataclass_fields__})
                if not request.device_token:
                    request.device_token = data.get("deviceToken", "")
            except Exception:
                self.rejected_counter.inc()
                continue
            try:
                self.handle_registration(request)
            except Exception as exc:
                LOGGER.warning("registration failed for '%s': %s",
                               request.device_token, exc)
                self.rejected_counter.inc()
                self._ack(request.device_token,
                          RegistrationAckState.REGISTRATION_ERROR, str(exc))

    def handle_registration(self, request: DeviceRegistrationRequest
                            ) -> Device:
        """handleDeviceRegistration :81 — create-or-acknowledge."""
        existing = self.registry.get_device_by_token(request.device_token)
        if existing is not None:
            self._ack(request.device_token,
                      RegistrationAckState.ALREADY_REGISTERED)
            return existing
        if not self.allow_new_devices:
            # counting + error ack happen in _process's catch; direct callers
            # (REST, tests) see the raise
            raise SiteWhereError("new device registration is not allowed")
        type_token = (request.device_type_token
                      or self.default_device_type_token)
        if not type_token:
            raise SiteWhereError("no device type for registration")
        # Resolve everything BEFORE creating the device: a half-registered
        # device (no assignment) would ack ALREADY_REGISTERED on retry and
        # never become able to send events.
        device_type = self.registry.get_device_type_by_token(type_token)
        area_id = ""
        customer_id = ""
        if self.auto_assign:
            area_token = request.area_token or self.default_area_token
            if area_token:
                area_id = self.registry.get_area_by_token(area_token).id
            if request.customer_token:
                customer = self.registry.customers.get_by_token(
                    request.customer_token)
                customer_id = customer.id if customer else ""
        device = self.registry.create_device(Device(
            token=request.device_token, device_type_id=device_type.id,
            metadata=dict(request.metadata)))
        if self.auto_assign:
            self.registry.create_device_assignment(DeviceAssignment(
                device_id=device.id, area_id=area_id,
                customer_id=customer_id))
        self.registered_counter.inc()
        self._ack(request.device_token, RegistrationAckState.NEW_REGISTRATION)
        return device

    # -- unregistered-device events ---------------------------------------
    def _process_unregistered(self, records: List[Record]) -> None:
        """Devices that sent data without being registered: auto-register
        when a default device type is configured, else just count — the
        reference sends a RegistrationRequired prompt here."""
        for record in records:
            token = record.key.decode("utf-8", "replace")
            if not token or self.registry.get_device_by_token(token):
                continue
            if self.allow_new_devices and self.default_device_type_token:
                try:
                    self.handle_registration(
                        DeviceRegistrationRequest(device_token=token))
                except Exception:
                    self.rejected_counter.inc()
            else:
                self.rejected_counter.inc()

    # -- acks --------------------------------------------------------------
    def _ack(self, device_token: str, state: RegistrationAckState,
             reason: str = "") -> None:
        if self.command_delivery is None or not device_token:
            return
        from sitewhere_tpu_torch.commands.encoding import SystemCommand
        payload = WireCodec.encode_register_ack(device_token, state.value,
                                                reason)
        try:
            self.command_delivery.send_system_command(
                device_token, SystemCommand(MessageType.REGISTER_ACK, payload))
        except SiteWhereError:
            pass  # device may not exist on error acks; nothing to deliver to
