"""Asset model (sitewhere-core-api spi/asset/IAsset.java, IAssetType.java).

Assets are the people/hardware/locations bound to device assignments."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from sitewhere_tpu_torch.model.common import BrandedEntity


class AssetCategory(enum.Enum):
    """Asset classification (reference AssetCategory)."""

    DEVICE = "Device"
    PERSON = "Person"
    HARDWARE = "Hardware"


@dataclass
class AssetType(BrandedEntity):
    """Class of assets (IAssetType)."""

    asset_category: AssetCategory = AssetCategory.DEVICE


@dataclass
class Asset(BrandedEntity):
    """Asset instance (IAsset)."""

    asset_type_id: str = ""
