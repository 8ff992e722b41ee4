"""Domain model: the L0 API contract.

Python dataclass equivalents of the reference's com.sitewhere.spi.* surface
(reference: sitewhere-core-api, 519 files). Every persisted entity carries a
uuid `id`, a human `token`, timestamps and a metadata map, mirroring
IPersistentEntity / IMetadataProvider.
"""

from sitewhere_tpu_torch.model.common import (
    PersistentEntity,
    BrandedEntity,
    Pager,
    SearchCriteria,
    SearchResults,
    DateRangeCriteria,
    Location,
)
from sitewhere_tpu_torch.model.device import (
    Device,
    DeviceType,
    DeviceAssignment,
    DeviceAssignmentStatus,
    DeviceCommand,
    CommandParameter,
    ParameterType,
    DeviceStatus,
    DeviceGroup,
    DeviceGroupElement,
    DeviceAlarm,
    DeviceAlarmState,
    DeviceElementMapping,
    DeviceElementSchema,
    DeviceSlot,
    DeviceUnit,
    find_device_slot,
    DeviceStream,
)
from sitewhere_tpu_torch.model.area import (
    AreaType,
    Area,
    Zone,
    CustomerType,
    Customer,
)
from sitewhere_tpu_torch.model.event import (
    DeviceEvent,
    DeviceEventType,
    DeviceMeasurement,
    DeviceLocation,
    DeviceAlert,
    AlertLevel,
    AlertSource,
    DeviceCommandInvocation,
    CommandInitiator,
    CommandTarget,
    DeviceCommandResponse,
    DeviceStateChange,
    DeviceStreamData,
    DeviceEventBatch,
    DeviceEventContext,
    DeviceRegistrationRequest,
)
from sitewhere_tpu_torch.model.state import DeviceState, PresenceState
from sitewhere_tpu_torch.model.asset import Asset, AssetType, AssetCategory
from sitewhere_tpu_torch.model.batch import (
    BatchOperation,
    BatchOperationStatus,
    BatchElement,
    ElementProcessingStatus,
)
from sitewhere_tpu_torch.model.schedule import (
    Schedule,
    ScheduledJob,
    TriggerType,
    ScheduledJobType,
    ScheduledJobState,
)

__all__ = [name for name in dir() if not name.startswith("_")]
