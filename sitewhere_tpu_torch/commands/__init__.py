"""Cloud->device command delivery (reference: service-command-delivery)."""

from sitewhere_tpu_torch.commands.delivery import (
    CommandDeliveryService, CommandProcessingStrategy, TargetResolver)
from sitewhere_tpu_torch.commands.destinations import (
    CoapDeliveryProvider, CommandDestination, InProcDeliveryProvider,
    MetadataParameterExtractor, MqttDeliveryProvider, MqttParameterExtractor,
    SmsDeliveryProvider, SmsParameterExtractor)
from sitewhere_tpu_torch.commands.encoding import (
    CommandExecution, JsonCommandEncoder, ScriptedCommandEncoder,
    SystemCommand, WireCommandEncoder, coerce_parameters)
from sitewhere_tpu_torch.commands.routing import (
    BroadcastRouter, DeviceTypeMappingRouter, SingleDestinationRouter)

__all__ = [
    "BroadcastRouter", "CoapDeliveryProvider", "CommandDeliveryService",
    "CommandDestination", "CommandExecution", "CommandProcessingStrategy",
    "DeviceTypeMappingRouter", "InProcDeliveryProvider", "JsonCommandEncoder",
    "MetadataParameterExtractor", "MqttDeliveryProvider",
    "MqttParameterExtractor", "ScriptedCommandEncoder",
    "SingleDestinationRouter", "SmsDeliveryProvider",
    "SmsParameterExtractor", "SystemCommand", "TargetResolver",
    "WireCommandEncoder", "coerce_parameters",
]
