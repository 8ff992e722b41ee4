"""Device<->cloud wire protocol: framing + payload codecs.

Reference: sitewhere-communication/src/main/proto/sitewhere.proto —
device->cloud `SiteWhere.Command` (SEND_REGISTRATION, SEND_ACKNOWLEDGEMENT,
SEND_DEVICE_MEASUREMENTS, SEND_DEVICE_LOCATION, SEND_DEVICE_ALERT,
SEND_DEVICE_STREAM, SEND_DEVICE_STREAM_DATA, REQUEST_DEVICE_STREAM_DATA) and
cloud->device `Device.Command` (ACK_REGISTRATION, RECEIVE_DEVICE_COMMAND...),
with event payloads Model.DeviceMeasurements/DeviceLocation/DeviceAlert.

Frame layout (little-endian):

    0..1   magic  b"SW"
    2      version (1)
    3      msg_type (MessageType)
    4..7   u32 payload length
    8..    payload

Hot event payloads (MEASUREMENT / LOCATION / ALERT) are fixed-layout binary —
decodable straight into SoA columns by `decode_event_frames_to_columns`
(and by the C++ batch decoder of native.py, which implements the same layout):

    u8 token_len, token, i64 event_ts_ms, then per type:
      MEASUREMENT: u8 name_len, name, f32 value
      LOCATION:    f32 lat, f32 lon, f32 elevation
      ALERT:       u8 type_len, type, u8 level, u16 msg_len, msg

Control payloads (REGISTER, REGISTER_ACK, COMMAND, COMMAND_RESPONSE, ACK,
STREAM_DATA) are msgpack maps — the flexibility protobuf gives the
reference, without a schema compiler in the device SDK.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import msgpack
import numpy as np

MAGIC = b"SW"
VERSION = 1
_HEADER = struct.Struct("<2sBBI")


class WireError(Exception):
    pass


class MessageType(enum.IntEnum):
    # device -> cloud (SiteWhere.Command in sitewhere.proto:10-21)
    REGISTER = 1
    ACK = 2
    MEASUREMENT = 3
    LOCATION = 4
    ALERT = 5
    STREAM_DATA = 6
    COMMAND_RESPONSE = 7
    # cloud -> device (Device.Command in sitewhere.proto:100-110)
    REGISTER_ACK = 16
    COMMAND = 17
    STREAM_ACK = 18


HOT_TYPES = (MessageType.MEASUREMENT, MessageType.LOCATION, MessageType.ALERT)


def encode_frame(msg_type: MessageType, payload: bytes) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, int(msg_type), len(payload)) + payload


# Upper bound on a single frame's payload: caps what a stream transport
# will buffer for one frame, so a corrupt/hostile length header can't grow
# RSS unboundedly (largest legitimate frame is a stream-data chunk).
MAX_FRAME_PAYLOAD = 16 * 1024 * 1024


def decode_frames(data: bytes) -> Tuple[List[Tuple[MessageType, bytes]], bytes]:
    """Parse as many complete frames as present; returns (frames, remainder)
    so stream transports can carry partial tails across reads."""
    frames: List[Tuple[MessageType, bytes]] = []
    pos = 0
    n = len(data)
    while pos + _HEADER.size <= n:
        magic, version, mtype, length = _HEADER.unpack_from(data, pos)
        if magic != MAGIC or version != VERSION:
            raise WireError(f"bad frame header at {pos}")
        if length > MAX_FRAME_PAYLOAD:
            raise WireError(f"frame payload {length} exceeds cap")
        if pos + _HEADER.size + length > n:
            break
        payload = data[pos + _HEADER.size:pos + _HEADER.size + length]
        frames.append((MessageType(mtype), payload))
        pos += _HEADER.size + length
    return frames, data[pos:]


class WireCodec:
    """Payload encode/decode for every MessageType."""

    # -- hot events: fixed binary layout -----------------------------------
    @staticmethod
    def encode_measurement(token: str, ts_ms: int, name: str,
                           value: float) -> bytes:
        tb, nb = token.encode(), name.encode()
        return (struct.pack("<B", len(tb)) + tb + struct.pack("<q", ts_ms)
                + struct.pack("<B", len(nb)) + nb + struct.pack("<f", value))

    @staticmethod
    def encode_location(token: str, ts_ms: int, lat: float, lon: float,
                        elevation: float = 0.0) -> bytes:
        tb = token.encode()
        return (struct.pack("<B", len(tb)) + tb
                + struct.pack("<qfff", ts_ms, lat, lon, elevation))

    @staticmethod
    def encode_alert(token: str, ts_ms: int, alert_type: str, level: int,
                     message: str = "") -> bytes:
        tb, ab, mb = token.encode(), alert_type.encode(), message.encode()
        return (struct.pack("<B", len(tb)) + tb + struct.pack("<q", ts_ms)
                + struct.pack("<B", len(ab)) + ab
                + struct.pack("<B", level)
                + struct.pack("<H", len(mb)) + mb)

    @staticmethod
    def decode_event(msg_type: MessageType, payload: bytes) -> Dict:
        """Single-event decode (slow path / tests). Bulk ingest uses
        decode_event_frames_to_columns instead."""
        tlen = payload[0]
        token = payload[1:1 + tlen].decode()
        pos = 1 + tlen
        (ts,) = struct.unpack_from("<q", payload, pos)
        pos += 8
        out: Dict = {"token": token, "ts_ms": ts}
        if msg_type == MessageType.MEASUREMENT:
            nlen = payload[pos]
            pos += 1
            out["name"] = payload[pos:pos + nlen].decode()
            pos += nlen
            (out["value"],) = struct.unpack_from("<f", payload, pos)
        elif msg_type == MessageType.LOCATION:
            out["lat"], out["lon"], out["elevation"] = struct.unpack_from(
                "<fff", payload, pos)
        elif msg_type == MessageType.ALERT:
            alen = payload[pos]
            pos += 1
            out["type"] = payload[pos:pos + alen].decode()
            pos += alen
            out["level"] = payload[pos]
            pos += 1
            (mlen,) = struct.unpack_from("<H", payload, pos)
            pos += 2
            out["message"] = payload[pos:pos + mlen].decode()
        else:
            raise WireError(f"not a hot event type: {msg_type}")
        return out

    # -- control messages: msgpack maps ------------------------------------
    @staticmethod
    def encode_register(token: str, device_type_token: str,
                        area_token: str = "", customer_token: str = "",
                        metadata: Optional[Dict[str, str]] = None) -> bytes:
        return msgpack.packb({
            "token": token, "deviceType": device_type_token,
            "area": area_token, "customer": customer_token,
            "metadata": metadata or {}}, use_bin_type=True)

    @staticmethod
    def encode_register_ack(token: str, status: str,
                            reason: str = "") -> bytes:
        # status mirrors RegistrationAckState: NEW_REGISTRATION,
        # ALREADY_REGISTERED, REGISTRATION_ERROR (sitewhere.proto:36-47)
        return msgpack.packb({"token": token, "status": status,
                              "reason": reason}, use_bin_type=True)

    @staticmethod
    def encode_command(token: str, command: str,
                       parameters: Optional[Dict[str, str]] = None,
                       invocation_id: str = "") -> bytes:
        return msgpack.packb({
            "token": token, "command": command,
            "parameters": parameters or {},
            "invocationId": invocation_id}, use_bin_type=True)

    @staticmethod
    def encode_command_response(token: str, invocation_id: str,
                                response: str) -> bytes:
        return msgpack.packb({"token": token, "invocationId": invocation_id,
                              "response": response}, use_bin_type=True)

    @staticmethod
    def encode_ack(token: str, message_id: str, response: str = "") -> bytes:
        return msgpack.packb({"token": token, "messageId": message_id,
                              "response": response}, use_bin_type=True)

    @staticmethod
    def encode_stream_data(token: str, stream_id: str, sequence: int,
                           data: bytes) -> bytes:
        return msgpack.packb({"token": token, "streamId": stream_id,
                              "sequence": sequence, "data": data},
                             use_bin_type=True)

    @staticmethod
    def decode_control(payload: bytes) -> Dict:
        return msgpack.unpackb(payload, raw=False)


def decode_event_frames_to_columns(frames: List[Tuple[MessageType, bytes]]
                                   ) -> Dict[str, np.ndarray]:
    """Bulk decode of hot-event frames into SoA columns (tokens stay a
    Python list for interning). This is the Python reference implementation
    of the native C++ decoder's contract: same input layout, same outputs.

    Non-hot frames are skipped (callers route them separately)."""
    hot = [(t, p) for t, p in frames if t in HOT_TYPES]
    n = len(hot)
    tokens: List[str] = [""] * n
    event_type = np.zeros(n, np.int32)
    ts = np.zeros(n, np.int64)
    names: List[str] = [""] * n
    value = np.zeros(n, np.float32)
    lat = np.zeros(n, np.float32)
    lon = np.zeros(n, np.float32)
    elevation = np.zeros(n, np.float32)
    alert_types: List[str] = [""] * n
    alert_level = np.zeros(n, np.int32)
    for i, (mtype, payload) in enumerate(hot):
        ev = WireCodec.decode_event(mtype, payload)
        tokens[i] = ev["token"]
        ts[i] = ev["ts_ms"]
        if mtype == MessageType.MEASUREMENT:
            event_type[i] = 0  # DeviceEventType.MEASUREMENT
            names[i] = ev["name"]
            value[i] = ev["value"]
        elif mtype == MessageType.LOCATION:
            event_type[i] = 1  # DeviceEventType.LOCATION
            lat[i], lon[i] = ev["lat"], ev["lon"]
            elevation[i] = ev["elevation"]
        else:
            event_type[i] = 2  # DeviceEventType.ALERT
            alert_types[i] = ev["type"]
            alert_level[i] = ev["level"]
    return {
        "tokens": tokens, "event_type": event_type, "ts_ms": ts,
        "names": names, "value": value, "lat": lat, "lon": lon,
        "elevation": elevation, "alert_types": alert_types,
        "alert_level": alert_level,
    }
