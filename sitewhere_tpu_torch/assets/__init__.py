"""Asset management (reference: service-asset-management)."""

from sitewhere_tpu_torch.assets.manager import AssetManagement

__all__ = ["AssetManagement"]
