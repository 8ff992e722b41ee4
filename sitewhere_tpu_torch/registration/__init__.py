"""Device auto-registration (reference: service-device-registration)."""

from sitewhere_tpu_torch.registration.manager import (
    RegistrationAckState, RegistrationManager)

__all__ = ["RegistrationAckState", "RegistrationManager"]
