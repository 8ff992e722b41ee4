"""Device-facing transports + the device<->cloud wire protocol (framing and
payload codecs; the plain Python decoder of the frames the native decoder
reads). The MQTT broker and CoAP server are in-process asyncio
implementations of the wire protocols themselves."""

from sitewhere_tpu_torch.transport.wire import (
    MessageType, WireCodec, WireError, decode_frames, encode_frame)
from sitewhere_tpu_torch.transport.mqtt import MqttBroker, MqttClient
from sitewhere_tpu_torch.transport.protobuf_compat import (
    ProtobufCompatDecoder, ProtobufSpecCommandEncoder)

__all__ = [
    "MessageType", "WireCodec", "WireError", "decode_frames", "encode_frame",
    "MqttBroker", "MqttClient",
    "ProtobufCompatDecoder", "ProtobufSpecCommandEncoder",
]
