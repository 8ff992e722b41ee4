"""Device binary streams (reference: service-streaming-media)."""

from sitewhere_tpu_torch.streams.manager import DeviceStreamManager

__all__ = ["DeviceStreamManager"]
