"""Event sources: ingest + decode (reference service-event-sources), and
the bulk fast lane (wire bytes -> packed batches, `fastlane.py`).

An `InboundEventSource` binds receivers (transport listeners) to a decoder
chain and emits decoded requests onto the bus topics
(event-source-decoded-events / failed-decode / registration). The
`EventSourcesManager` hosts N sources per tenant.
"""

from sitewhere_tpu_torch.sources.decoders import (
    CompositeDecoder, DecodedRequest, DecodeError, JsonBatchDecoder,
    JsonRequestDecoder, ScriptedDecoder, WireDecoder)
from sitewhere_tpu_torch.transport.protobuf_compat import ProtobufCompatDecoder
from sitewhere_tpu_torch.sources.dedup import (
    AlternateIdDeduplicator, ScriptedDeduplicator,
    SequenceWatermarkDeduplicator)
from sitewhere_tpu_torch.sources.manager import (
    EventSourcesManager, InboundEventSource)
from sitewhere_tpu_torch.sources.receivers import (
    CoapEventReceiver, HttpEventReceiver, MqttEventReceiver,
    StompBrokerEventReceiver,
    SocketEventReceiver, WebSocketEventReceiver)

__all__ = [
    "CompositeDecoder", "DecodedRequest", "DecodeError", "JsonBatchDecoder",
    "JsonRequestDecoder", "ProtobufCompatDecoder", "ScriptedDecoder",
    "WireDecoder",
    "AlternateIdDeduplicator", "ScriptedDeduplicator",
    "SequenceWatermarkDeduplicator",
    "EventSourcesManager", "InboundEventSource",
    "CoapEventReceiver", "HttpEventReceiver", "MqttEventReceiver",
    "StompBrokerEventReceiver",
    "SocketEventReceiver", "WebSocketEventReceiver",
]
