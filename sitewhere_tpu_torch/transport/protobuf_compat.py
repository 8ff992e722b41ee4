"""Reference device-SDK wire compatibility: the `sitewhere.proto` protocol.

A fleet of existing SiteWhere devices speaks the protobuf protocol defined in
the reference's sitewhere-communication module
(src/main/proto/sitewhere.proto:6-133): every payload is a varint-delimited
`SiteWhere.Header` (command + optional originator) followed by one
varint-delimited body message, decoded by ProtobufDeviceEventDecoder.java and
answered through per-device-type messages built dynamically by
ProtobufMessageBuilder.java / ProtobufSpecificationBuilder.java.

This module implements that wire format with a hand-rolled proto2 codec (no
protoc, no generated classes — the schema is tiny and frozen):

- `ProtobufCompatDecoder` — drop-in `sources.decoders.Decoder` for payloads
  produced by reference device SDKs (registration, acknowledge, measurements,
  location, alert, stream create/data/request).
- device->cloud `encode_*` helpers — a Python device SDK speaking the same
  bytes (also the test vectors: round-tripped against google.protobuf
  dynamic messages in tests/test_protobuf_compat.py).
- `encode_registration_ack` / `encode_device_stream_ack` — the cloud->device
  system messages (Device.Command in sitewhere.proto:111-147).
- `ProtobufSpecCommandEncoder` — the ProtobufMessageBuilder role: encodes a
  custom command invocation against the *device type's* dynamic schema
  (commands enum numbered by list order, per-command message with fields
  numbered by parameter order, typed per ParameterType).

Wire-format notes (proto2): varints little-endian 7-bit groups; field tag =
(field_number << 3) | wire_type; doubles/fixed64 are wire type 1 (8 bytes
LE); strings/bytes/sub-messages are wire type 2 (varint length + payload);
`parseDelimitedFrom` framing is a varint byte-length prefix per message.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sitewhere_tpu_torch.model.device import DeviceCommand, ParameterType
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert, DeviceCommandResponse,
    DeviceEventBatch, DeviceLocation, DeviceMeasurement,
    DeviceRegistrationRequest, DeviceStreamData)

# SiteWhere.Command (device -> cloud), sitewhere.proto:72-81
SEND_REGISTRATION = 1
SEND_ACKNOWLEDGEMENT = 2
SEND_DEVICE_LOCATION = 3
SEND_DEVICE_ALERT = 4
SEND_DEVICE_MEASUREMENTS = 5
SEND_DEVICE_STREAM = 6
SEND_DEVICE_STREAM_DATA = 7
REQUEST_DEVICE_STREAM_DATA = 8

# Device.Command (cloud -> device), sitewhere.proto:114-118
ACK_REGISTRATION = 1
ACK_DEVICE_STREAM = 2
RECEIVE_DEVICE_STREAM_DATA = 3


class RegistrationAckState(enum.IntEnum):
    """Device.RegistrationAckState, sitewhere.proto:129."""

    NEW_REGISTRATION = 1
    ALREADY_REGISTERED = 2
    REGISTRATION_ERROR = 3


class RegistrationAckError(enum.IntEnum):
    """Device.RegistrationAckError, sitewhere.proto:130."""

    INVALID_SPECIFICATION = 1
    SITE_TOKEN_REQUIRED = 2
    NEW_DEVICES_NOT_ALLOWED = 3


class ProtobufCompatError(Exception):
    """Malformed sitewhere.proto payload."""


# ---------------------------------------------------------------------------
# proto2 wire primitives
# ---------------------------------------------------------------------------

def _write_varint(value: int) -> bytes:
    if value < 0:  # proto2 int32/int64 negatives ride as 10-byte varints
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if off >= len(buf):
            raise ProtobufCompatError("truncated varint")
        byte = buf[off]
        off += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, off
        shift += 7
        if shift > 63:
            raise ProtobufCompatError("varint too long")


def _zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def _unzigzag(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _write_varint((field_number << 3) | wire_type)


class _Writer:
    """Accumulates one message's fields in write order."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def varint(self, num: int, value: int) -> "_Writer":
        self._parts.append(_tag(num, 0) + _write_varint(value))
        return self

    def bool(self, num: int, value: bool) -> "_Writer":
        return self.varint(num, 1 if value else 0)

    def sint(self, num: int, value: int) -> "_Writer":
        return self.varint(num, _zigzag(value))

    def fixed64(self, num: int, value: int) -> "_Writer":
        self._parts.append(_tag(num, 1) + struct.pack("<Q", value & (2**64 - 1)))
        return self

    def sfixed64(self, num: int, value: int) -> "_Writer":
        self._parts.append(_tag(num, 1) + struct.pack("<q", value))
        return self

    def double(self, num: int, value: float) -> "_Writer":
        self._parts.append(_tag(num, 1) + struct.pack("<d", value))
        return self

    def fixed32(self, num: int, value: int) -> "_Writer":
        self._parts.append(_tag(num, 5) + struct.pack("<I", value & (2**32 - 1)))
        return self

    def sfixed32(self, num: int, value: int) -> "_Writer":
        self._parts.append(_tag(num, 5) + struct.pack("<i", value))
        return self

    def float(self, num: int, value: float) -> "_Writer":
        self._parts.append(_tag(num, 5) + struct.pack("<f", value))
        return self

    def bytes(self, num: int, value: bytes) -> "_Writer":
        self._parts.append(_tag(num, 2) + _write_varint(len(value)) + value)
        return self

    def string(self, num: int, value: str) -> "_Writer":
        return self.bytes(num, value.encode("utf-8"))

    def message(self, num: int, sub: "_Writer") -> "_Writer":
        return self.bytes(num, sub.build())

    def build(self) -> bytes:
        return b"".join(self._parts)

    def delimited(self) -> bytes:
        body = self.build()
        return _write_varint(len(body)) + body


@dataclass
class _Fields:
    """Parsed message: field number -> list of raw values in wire order.
    wire type 0 -> int, 1 -> 8 raw bytes, 2 -> bytes, 5 -> 4 raw bytes."""

    raw: Dict[int, List[Any]] = field(default_factory=dict)

    @classmethod
    def parse(cls, buf: bytes) -> "_Fields":
        fields = cls()
        off = 0
        while off < len(buf):
            key, off = _read_varint(buf, off)
            num, wt = key >> 3, key & 7
            if wt == 0:
                value, off = _read_varint(buf, off)
            elif wt == 1:
                value, off = buf[off:off + 8], off + 8
            elif wt == 2:
                length, off = _read_varint(buf, off)
                value, off = buf[off:off + length], off + length
                if len(value) != length:
                    raise ProtobufCompatError("truncated length-delimited")
            elif wt == 5:
                value, off = buf[off:off + 4], off + 4
            else:
                raise ProtobufCompatError(f"unsupported wire type {wt}")
            if off > len(buf):
                raise ProtobufCompatError("truncated field")
            fields.raw.setdefault(num, []).append(value)
        return fields

    # typed getters (last-value-wins for scalars, as protobuf specifies)
    def int(self, num: int, default: int = 0) -> int:
        values = self.raw.get(num)
        if not values:
            return default
        value = int(values[-1])
        if value >= 1 << 63:  # proto2 int32/int64 negatives are 64-bit
            value -= 1 << 64  # two's-complement varints; restore the sign
        return value

    def str(self, num: int, default: str = "") -> str:
        values = self.raw.get(num)
        return values[-1].decode("utf-8") if values else default

    def bytes(self, num: int, default: bytes = b"") -> bytes:
        values = self.raw.get(num)
        return values[-1] if values else default

    def double(self, num: int, default: float = 0.0) -> float:
        values = self.raw.get(num)
        return struct.unpack("<d", values[-1])[0] if values else default

    def fixed64(self, num: int, default: int = 0) -> int:
        values = self.raw.get(num)
        return struct.unpack("<Q", values[-1])[0] if values else default

    def bool(self, num: int, default: bool = False) -> bool:
        values = self.raw.get(num)
        return bool(int(values[-1])) if values else default

    def messages(self, num: int) -> List["_Fields"]:
        return [_Fields.parse(v) for v in self.raw.get(num, [])]

    def has(self, num: int) -> bool:
        return num in self.raw


def read_delimited(buf: bytes, off: int = 0) -> Tuple[bytes, int]:
    """One `parseDelimitedFrom` frame: varint length + that many bytes."""
    length, off = _read_varint(buf, off)
    end = off + length
    if end > len(buf):
        raise ProtobufCompatError("truncated delimited message")
    return buf[off:end], end


def _metadata(fields: _Fields, num: int) -> Dict[str, str]:
    """repeated Model.Metadata {1: name, 2: value} (sitewhere.proto:9-12)."""
    return {m.str(1): m.str(2) for m in fields.messages(num)}


def _meta_writer(w: _Writer, num: int, metadata: Optional[Dict[str, str]]
                 ) -> None:
    for name, value in (metadata or {}).items():
        w.message(num, _Writer().string(1, name).string(2, value))


# ---------------------------------------------------------------------------
# device -> cloud: encode (the SDK side; also the decoder's test vectors)
# ---------------------------------------------------------------------------

def _with_header(command: int, body: _Writer,
                 originator: Optional[str] = None) -> bytes:
    header = _Writer().varint(1, command)
    if originator:
        header.string(2, originator)
    return header.delimited() + body.delimited()


def encode_registration(hardware_id: str, device_type_token: str,
                        metadata: Optional[Dict[str, str]] = None,
                        area_token: Optional[str] = None,
                        originator: Optional[str] = None) -> bytes:
    """SiteWhere.RegisterDevice (sitewhere.proto:90-95)."""
    w = _Writer().string(1, hardware_id).string(2, device_type_token)
    _meta_writer(w, 3, metadata)
    if area_token:
        w.string(4, area_token)
    return _with_header(SEND_REGISTRATION, w, originator)


def encode_acknowledge(hardware_id: str, message: str = "",
                       originator: Optional[str] = None) -> bytes:
    """SiteWhere.Acknowledge (sitewhere.proto:98-101)."""
    w = _Writer().string(1, hardware_id)
    if message:
        w.string(2, message)
    return _with_header(SEND_ACKNOWLEDGEMENT, w, originator)


def encode_measurements(hardware_id: str,
                        measurements: Sequence[Tuple[str, float]],
                        event_date_ms: Optional[int] = None,
                        metadata: Optional[Dict[str, str]] = None,
                        update_state: Optional[bool] = None,
                        originator: Optional[str] = None) -> bytes:
    """Model.DeviceMeasurements (sitewhere.proto:42-48)."""
    w = _Writer().string(1, hardware_id)
    for name, value in measurements:
        w.message(2, _Writer().string(1, name).double(2, float(value)))
    if event_date_ms is not None:
        w.fixed64(3, event_date_ms)
    _meta_writer(w, 4, metadata)
    if update_state is not None:
        w.bool(5, update_state)
    return _with_header(SEND_DEVICE_MEASUREMENTS, w, originator)


def encode_location(hardware_id: str, latitude: float, longitude: float,
                    elevation: Optional[float] = None,
                    event_date_ms: Optional[int] = None,
                    metadata: Optional[Dict[str, str]] = None,
                    update_state: Optional[bool] = None,
                    originator: Optional[str] = None) -> bytes:
    """Model.DeviceLocation (sitewhere.proto:15-23)."""
    w = (_Writer().string(1, hardware_id)
         .double(2, latitude).double(3, longitude))
    if elevation is not None:
        w.double(4, elevation)
    if event_date_ms is not None:
        w.fixed64(5, event_date_ms)
    _meta_writer(w, 6, metadata)
    if update_state is not None:
        w.bool(7, update_state)
    return _with_header(SEND_DEVICE_LOCATION, w, originator)


def encode_alert(hardware_id: str, alert_type: str, alert_message: str,
                 event_date_ms: Optional[int] = None,
                 metadata: Optional[Dict[str, str]] = None,
                 update_state: Optional[bool] = None,
                 originator: Optional[str] = None) -> bytes:
    """Model.DeviceAlert (sitewhere.proto:26-33)."""
    w = (_Writer().string(1, hardware_id).string(2, alert_type)
         .string(3, alert_message))
    if event_date_ms is not None:
        w.fixed64(4, event_date_ms)
    _meta_writer(w, 5, metadata)
    if update_state is not None:
        w.bool(6, update_state)
    return _with_header(SEND_DEVICE_ALERT, w, originator)


def encode_stream_create(hardware_id: str, stream_id: str, content_type: str,
                         metadata: Optional[Dict[str, str]] = None,
                         originator: Optional[str] = None) -> bytes:
    """Model.DeviceStream (sitewhere.proto:51-56)."""
    w = (_Writer().string(1, hardware_id).string(2, stream_id)
         .string(3, content_type))
    _meta_writer(w, 4, metadata)
    return _with_header(SEND_DEVICE_STREAM, w, originator)


def encode_stream_data(hardware_id: str, stream_id: str,
                       sequence_number: int, data: bytes,
                       event_date_ms: Optional[int] = None,
                       originator: Optional[str] = None) -> bytes:
    """Model.DeviceStreamData (sitewhere.proto:59-66)."""
    w = (_Writer().string(1, hardware_id).string(2, stream_id)
         .fixed64(3, sequence_number).bytes(4, data))
    if event_date_ms is not None:
        w.fixed64(5, event_date_ms)
    return _with_header(SEND_DEVICE_STREAM_DATA, w, originator)


def encode_stream_data_request(hardware_id: str, stream_id: str,
                               sequence_number: int,
                               originator: Optional[str] = None) -> bytes:
    """SiteWhere.DeviceStreamDataRequest (sitewhere.proto:104-108)."""
    w = (_Writer().string(1, hardware_id).string(2, stream_id)
         .fixed64(3, sequence_number))
    return _with_header(REQUEST_DEVICE_STREAM_DATA, w, originator)


# ---------------------------------------------------------------------------
# cloud -> device: decode in the device SDK / tests
# ---------------------------------------------------------------------------

@dataclass
class DeviceStreamCreateRequest:
    """Decoded SEND_DEVICE_STREAM (the reference maps it to
    DeviceStreamCreateRequest)."""

    device_token: str = ""
    stream_id: str = ""
    content_type: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class StreamDataRequest:
    """Decoded REQUEST_DEVICE_STREAM_DATA (SendDeviceStreamDataRequest)."""

    device_token: str = ""
    stream_id: str = ""
    sequence_number: int = 0


class ProtobufCompatDecoder:
    """`sources.decoders.Decoder` for reference-SDK payloads.

    Mirrors ProtobufDeviceEventDecoder.java's mapping: measurements fan out
    per Measurement entry; a missing eventDate means "now" (left as 0 here —
    the inbound pipeline stamps receive time); SEND_ACKNOWLEDGEMENT becomes
    a command response whose originating id is the header originator.
    """

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None):
        from sitewhere_tpu_torch.sources.decoders import DecodeError, DecodedRequest

        try:
            return self._decode(payload)
        except (ProtobufCompatError, UnicodeDecodeError,
                struct.error) as exc:
            # UnicodeDecodeError: corrupt bytes in a string field;
            # struct.error: short fixed32/64 slice. Both must route to the
            # failed-decode topic like any other undecodable payload.
            raise DecodeError(f"bad sitewhere.proto payload: {exc}") from exc

    def _decode(self, payload: bytes):
        from sitewhere_tpu_torch.sources.decoders import DecodedRequest

        header_buf, off = read_delimited(payload)
        header = _Fields.parse(header_buf)
        command = header.int(1)
        originator = header.str(2)
        body_buf, _ = read_delimited(payload, off)
        body = _Fields.parse(body_buf)
        token = body.str(1)
        if not token:
            raise ProtobufCompatError("missing hardwareId")
        meta = {}
        out: List[DecodedRequest] = []

        if command == SEND_REGISTRATION:
            out.append(DecodedRequest(token, DeviceRegistrationRequest(
                device_token=token, device_type_token=body.str(2),
                area_token=body.str(4), metadata=_metadata(body, 3))))
        elif command == SEND_ACKNOWLEDGEMENT:
            out.append(DecodedRequest(token, DeviceCommandResponse(
                originating_event_id=originator, response=body.str(2))))
        elif command == SEND_DEVICE_MEASUREMENTS:
            batch = DeviceEventBatch(device_token=token)
            meta = _metadata(body, 4)
            for m in body.messages(2):
                batch.measurements.append(DeviceMeasurement(
                    name=m.str(1), value=m.double(2),
                    event_date=body.fixed64(3), metadata=dict(meta)))
            out.append(DecodedRequest(token, batch, metadata=meta))
        elif command == SEND_DEVICE_LOCATION:
            batch = DeviceEventBatch(device_token=token)
            meta = _metadata(body, 6)
            batch.locations.append(DeviceLocation(
                latitude=body.double(2), longitude=body.double(3),
                elevation=body.double(4), event_date=body.fixed64(5),
                metadata=dict(meta)))
            out.append(DecodedRequest(token, batch, metadata=meta))
        elif command == SEND_DEVICE_ALERT:
            batch = DeviceEventBatch(device_token=token)
            meta = _metadata(body, 5)
            batch.alerts.append(DeviceAlert(
                type=body.str(2), message=body.str(3),
                level=AlertLevel.INFO, source=AlertSource.DEVICE,
                event_date=body.fixed64(4), metadata=dict(meta)))
            out.append(DecodedRequest(token, batch, metadata=meta))
        elif command == SEND_DEVICE_STREAM:
            out.append(DecodedRequest(token, DeviceStreamCreateRequest(
                device_token=token, stream_id=body.str(2),
                content_type=body.str(3), metadata=_metadata(body, 4))))
        elif command == SEND_DEVICE_STREAM_DATA:
            out.append(DecodedRequest(token, DeviceStreamData(
                stream_id=body.str(2), sequence_number=body.fixed64(3),
                data=body.bytes(4), event_date=body.fixed64(5))))
        elif command == REQUEST_DEVICE_STREAM_DATA:
            out.append(DecodedRequest(token, StreamDataRequest(
                device_token=token, stream_id=body.str(2),
                sequence_number=body.fixed64(3))))
        else:
            raise ProtobufCompatError(f"unknown command {command}")
        return out


# ---------------------------------------------------------------------------
# cloud -> device system messages (Device.Command)
# ---------------------------------------------------------------------------

def _device_header(command: int, originator: Optional[str] = None,
                   nested_path: Optional[str] = None,
                   nested_spec: Optional[str] = None) -> _Writer:
    header = _Writer().varint(1, command)
    if originator:
        header.string(2, originator)
    if nested_path:
        header.string(3, nested_path)
    if nested_spec:
        header.string(4, nested_spec)
    return header


def encode_registration_ack(state: RegistrationAckState,
                            error_type: Optional[RegistrationAckError] = None,
                            error_message: str = "",
                            originator: Optional[str] = None) -> bytes:
    """Device.RegistrationAck (sitewhere.proto:133-137), delimited after a
    Device.Header — what the reference's RegistrationManager sends back."""
    ack = _Writer().varint(1, int(state))
    if error_type is not None:
        ack.varint(2, int(error_type))
    if error_message:
        ack.string(3, error_message)
    return (_device_header(ACK_REGISTRATION, originator).delimited()
            + ack.delimited())


def encode_device_stream_ack(stream_id: str, state: int,
                             originator: Optional[str] = None) -> bytes:
    """Device.DeviceStreamAck (sitewhere.proto:143-146)."""
    ack = _Writer().string(1, stream_id).varint(2, state)
    return (_device_header(ACK_DEVICE_STREAM, originator).delimited()
            + ack.delimited())


def decode_device_payload(payload: bytes) -> Tuple[int, str, _Fields]:
    """Device-side helper (and test hook): returns (command, originator,
    parsed body fields) of a cloud->device payload."""
    header_buf, off = read_delimited(payload)
    header = _Fields.parse(header_buf)
    body_buf, _ = read_delimited(payload, off)
    return header.int(1), header.str(2), _Fields.parse(body_buf)


# ---------------------------------------------------------------------------
# per-device-type command encoding (ProtobufMessageBuilder role)
# ---------------------------------------------------------------------------

def _encode_parameter(w: _Writer, num: int, ptype: ParameterType,
                      value: str) -> None:
    """Encode one string-coerced parameter with the declared proto2 type —
    the dynamic-field mapping of ProtobufSpecificationBuilder.getType."""
    if ptype == ParameterType.DOUBLE:
        w.double(num, float(value))
    elif ptype == ParameterType.FLOAT:
        w.float(num, float(value))
    elif ptype in (ParameterType.INT32, ParameterType.INT64,
                   ParameterType.UINT32, ParameterType.UINT64):
        w.varint(num, int(value))
    elif ptype in (ParameterType.SINT32, ParameterType.SINT64):
        w.sint(num, int(value))
    elif ptype == ParameterType.FIXED32:
        w.fixed32(num, int(value))
    elif ptype == ParameterType.FIXED64:
        w.fixed64(num, int(value))
    elif ptype == ParameterType.SFIXED32:
        w.sfixed32(num, int(value))
    elif ptype == ParameterType.SFIXED64:
        w.sfixed64(num, int(value))
    elif ptype == ParameterType.BOOL:
        w.bool(num, value.lower() in ("1", "true", "yes", "on"))
    elif ptype == ParameterType.BYTES:
        w.bytes(num, bytes.fromhex(value))
    else:  # STRING
        w.string(num, value)


class ProtobufSpecCommandEncoder:
    """Command encoder speaking the per-device-type dynamic protobuf schema.

    ProtobufMessageBuilder.java builds, per device type: a `Command` enum
    whose values number the type's commands 1..N in listing order, a header
    message {1: command enum, 2: originator, 3: nestedPath, 4: nestedSpec},
    and one message per command whose fields number the command's parameters
    1..K in declaration order. The payload is delimited(header) +
    delimited(command message). Reproducing the numbering scheme (not the
    DynamicMessage machinery) is what keeps reference devices compatible.
    """

    def __init__(self, registry):
        self.registry = registry

    def _command_number(self, device, command: DeviceCommand) -> int:
        dtype = self.registry.device_types.get(device.device_type_id)
        if dtype is None:
            raise ValueError(f"device {device.token} has no device type")
        commands = self.registry.list_device_commands(dtype.token).results
        for i, candidate in enumerate(commands, start=1):
            if candidate.name == command.name:
                return i
        raise ValueError(
            f"command {command.name} not declared on type {dtype.token}")

    def encode(self, execution, device, assignment, nesting=None) -> bytes:
        number = self._command_number(device, execution.command)
        nested_path = nested_spec = None
        if nesting is not None and nesting.nested is not None:
            # gateway-framed message addressing a composite child: the
            # header carries the element-schema path and the nested
            # device's TYPE token (ProtobufMessageBuilder.java:76-82
            # setting nestedPath + nestedSpec from the mapping)
            nested_path = nesting.path
            nested_type = self.registry.device_types.get(
                nesting.nested.device_type_id)
            nested_spec = nested_type.token if nested_type else None
        header = _device_header(number,
                                originator=execution.invocation.id or None,
                                nested_path=nested_path,
                                nested_spec=nested_spec)
        body = _Writer()
        for num, parameter in enumerate(execution.command.parameters,
                                        start=1):
            value = execution.parameters.get(parameter.name)
            if value is None:
                continue
            _encode_parameter(body, num, parameter.type, value)
        return header.delimited() + body.delimited()

    def encode_system(self, command, device) -> bytes:
        """System messages for protobuf-SDK devices: re-encode the wire
        REGISTER_ACK payload as a Device.RegistrationAck."""
        from sitewhere_tpu_torch.transport.wire import MessageType, WireCodec

        if command.message_type == MessageType.REGISTER_ACK:
            doc = WireCodec.decode_control(command.payload)
            state = RegistrationAckState[doc.get(
                "status", "REGISTRATION_ERROR")]
            error = (RegistrationAckError.INVALID_SPECIFICATION
                     if state == RegistrationAckState.REGISTRATION_ERROR
                     else None)
            return encode_registration_ack(state, error_type=error,
                                           error_message=doc.get("reason", ""))
        raise ValueError(
            f"no sitewhere.proto mapping for system message "
            f"{MessageType(command.message_type).name}")
