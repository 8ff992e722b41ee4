"""Inbound payload decoders: raw bytes -> decoded device requests.

Reference: IDeviceEventDecoder implementations in service-event-sources —
protobuf (decoder/protobuf/ProtobufDeviceEventDecoder.java), JSON batch +
JSON request (decoder/json/JsonBatchEventDecoder.java /
JsonDeviceRequestDecoder.java), Groovy scripted (GroovyEventDecoder.java),
and composite per-device-type routing (decoder/composite/*).

A decoder returns a list of `DecodedRequest`s: (device_token, request),
where request is a DeviceEventBatch, a DeviceRegistrationRequest, a
DeviceCommandResponse, or a DeviceStreamData chunk. The scripted decoder
takes a plain Python callable — the Groovy-script extension point without a
JVM.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol

from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert, DeviceCommandResponse,
    DeviceEventBatch, DeviceLocation, DeviceMeasurement,
    DeviceRegistrationRequest, DeviceStreamData)
from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireCodec, WireError, decode_frames)


class DecodeError(Exception):
    """Raised for undecodable payloads; routes to the failed-decode topic
    (EventSourcesManager.onFailedDecode)."""


@dataclass
class DecodedRequest:
    """One decoded unit (IDecodedDeviceRequest<?>)."""

    device_token: str
    request: Any  # DeviceEventBatch | DeviceRegistrationRequest | ...
    metadata: Dict[str, str] = field(default_factory=dict)


class Decoder(Protocol):
    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]: ...


class WireDecoder:
    """Decode wire-protocol frames (transport/wire.py) — the equivalent of
    ProtobufDeviceEventDecoder over sitewhere.proto messages. A payload may
    carry many frames; events group per device into DeviceEventBatches."""

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]:
        try:
            frames, rest = decode_frames(payload)
        except WireError as exc:
            raise DecodeError(str(exc)) from exc
        if rest:
            raise DecodeError(f"trailing {len(rest)} bytes after frames")
        if not frames:
            raise DecodeError("no frames in payload")
        out: List[DecodedRequest] = []
        batches: Dict[str, DeviceEventBatch] = {}
        for mtype, body in frames:
            try:
                self._one(mtype, body, out, batches)
            except (IndexError, KeyError, ValueError) as exc:
                raise DecodeError(f"bad {mtype.name} payload") from exc
        out.extend(DecodedRequest(tok, b) for tok, b in batches.items())
        return out

    @staticmethod
    def _one(mtype: MessageType, body: bytes, out: List[DecodedRequest],
             batches: Dict[str, DeviceEventBatch]) -> None:
        if mtype == MessageType.MEASUREMENT:
            ev = WireCodec.decode_event(mtype, body)
            batch = batches.setdefault(ev["token"],
                                       DeviceEventBatch(ev["token"]))
            batch.measurements.append(DeviceMeasurement(
                name=ev["name"], value=ev["value"], event_date=ev["ts_ms"]))
        elif mtype == MessageType.LOCATION:
            ev = WireCodec.decode_event(mtype, body)
            batch = batches.setdefault(ev["token"],
                                       DeviceEventBatch(ev["token"]))
            batch.locations.append(DeviceLocation(
                latitude=ev["lat"], longitude=ev["lon"],
                elevation=ev["elevation"], event_date=ev["ts_ms"]))
        elif mtype == MessageType.ALERT:
            ev = WireCodec.decode_event(mtype, body)
            batch = batches.setdefault(ev["token"],
                                       DeviceEventBatch(ev["token"]))
            batch.alerts.append(DeviceAlert(
                type=ev["type"], level=AlertLevel(ev["level"]),
                message=ev["message"], source=AlertSource.DEVICE,
                event_date=ev["ts_ms"]))
        elif mtype == MessageType.REGISTER:
            c = WireCodec.decode_control(body)
            out.append(DecodedRequest(c["token"], DeviceRegistrationRequest(
                device_token=c["token"], device_type_token=c["deviceType"],
                area_token=c.get("area", ""),
                customer_token=c.get("customer", ""),
                metadata=c.get("metadata", {}))))
        elif mtype == MessageType.COMMAND_RESPONSE:
            c = WireCodec.decode_control(body)
            out.append(DecodedRequest(c["token"], DeviceCommandResponse(
                originating_event_id=c["invocationId"],
                response=c["response"])))
        elif mtype == MessageType.STREAM_DATA:
            c = WireCodec.decode_control(body)
            out.append(DecodedRequest(c["token"], DeviceStreamData(
                stream_id=c["streamId"], sequence_number=c["sequence"],
                data=c["data"])))
        else:
            raise DecodeError(f"unexpected inbound type {mtype.name}")


class JsonBatchDecoder:
    """JSON event batch (JsonBatchEventDecoder):
    {"deviceToken": "...", "measurements": [{"name","value","eventDate"?}],
     "locations": [...], "alerts": [...]}"""

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]:
        try:
            doc = json.loads(payload)
            token = doc["deviceToken"]
            batch = DeviceEventBatch(device_token=token)
            for m in doc.get("measurements", []):
                batch.measurements.append(DeviceMeasurement(
                    name=m["name"], value=float(m["value"]),
                    **_dates(m)))
            for l in doc.get("locations", []):
                batch.locations.append(DeviceLocation(
                    latitude=float(l["latitude"]),
                    longitude=float(l["longitude"]),
                    elevation=float(l.get("elevation", 0.0)), **_dates(l)))
            for a in doc.get("alerts", []):
                batch.alerts.append(DeviceAlert(
                    type=a["type"], message=a.get("message", ""),
                    level=AlertLevel[a.get("level", "INFO").upper()],
                    **_dates(a)))
        except (ValueError, KeyError, TypeError) as exc:
            raise DecodeError(f"bad JSON batch: {exc}") from exc
        return [DecodedRequest(token, batch)]


def _dates(doc: Dict) -> Dict:
    out = {}
    if "eventDate" in doc:
        out["event_date"] = int(doc["eventDate"])
    if "alternateId" in doc:
        out["alternate_id"] = str(doc["alternateId"])
    return out


class JsonRequestDecoder:
    """Typed JSON request (JsonDeviceRequestDecoder):
    {"deviceToken": "...", "type": "RegisterDevice"|"DeviceMeasurement"|...,
     "request": {...}}"""

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]:
        try:
            doc = json.loads(payload)
            token = doc["deviceToken"]
            rtype = doc["type"]
            req = doc.get("request", {})
            if rtype == "RegisterDevice":
                return [DecodedRequest(token, DeviceRegistrationRequest(
                    device_token=token,
                    device_type_token=req.get("deviceTypeToken", ""),
                    area_token=req.get("areaToken", ""),
                    metadata=req.get("metadata", {})))]
            batch = DeviceEventBatch(device_token=token)
            if rtype == "DeviceMeasurement":
                batch.measurements.append(DeviceMeasurement(
                    name=req["name"], value=float(req["value"]),
                    **_dates(req)))
            elif rtype == "DeviceLocation":
                batch.locations.append(DeviceLocation(
                    latitude=float(req["latitude"]),
                    longitude=float(req["longitude"]),
                    elevation=float(req.get("elevation", 0.0)),
                    **_dates(req)))
            elif rtype == "DeviceAlert":
                batch.alerts.append(DeviceAlert(
                    type=req["type"], message=req.get("message", ""),
                    level=AlertLevel[req.get("level", "INFO").upper()],
                    **_dates(req)))
            else:
                raise DecodeError(f"unknown request type {rtype}")
            return [DecodedRequest(token, batch)]
        except DecodeError:
            raise
        except (ValueError, KeyError, TypeError) as exc:
            raise DecodeError(f"bad JSON request: {exc}") from exc


class ScriptedDecoder:
    """User-code decoder (GroovyEventDecoder equivalent): wraps a Python
    callable `(payload: bytes, metadata: dict) -> List[DecodedRequest]`.
    Registered scripts come from the script manager (runtime.scripts)."""

    def __init__(self, fn: Callable[[bytes, Dict[str, str]],
                                    List[DecodedRequest]]):
        self.fn = fn

    @classmethod
    def from_manager(cls, manager, script_id: str, scope: str = "global",
                     entry: str = "decode") -> "ScriptedDecoder":
        """Bind to a managed script's active version (hot-swaps on
        activation — runtime/scripts.py)."""
        return cls(manager.resolve(scope, script_id, entry))

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]:
        try:
            return self.fn(payload, metadata or {})
        except Exception as exc:
            raise DecodeError(f"script decoder failed: {exc}") from exc


class CompositeDecoder:
    """Per-device-type decoder routing (decoder/composite/*): a metadata
    extractor pulls the device token from the payload, the device's type
    selects the sub-decoder."""

    def __init__(self, registry,
                 extractor: Callable[[bytes], str],
                 choices: Dict[str, Decoder],
                 default: Optional[Decoder] = None):
        self.registry = registry
        self.extractor = extractor
        self.choices = choices
        self.default = default

    def decode(self, payload: bytes,
               metadata: Optional[Dict[str, str]] = None
               ) -> List[DecodedRequest]:
        token = self.extractor(payload)
        device = self.registry.get_device_by_token(token)
        decoder = self.default
        if device is not None:
            dtype = self.registry.device_types.get(device.device_type_id)
            if dtype is not None and dtype.token in self.choices:
                decoder = self.choices[dtype.token]
        if decoder is None:
            raise DecodeError(f"no decoder for device {token}")
        return decoder.decode(payload, metadata)
