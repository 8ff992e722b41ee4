"""Asset registry: people/hardware/locations bound to assignments.

Reference: service-asset-management — IAssetManagement CRUD over asset types
and assets (gRPC + Mongo/HBase persistence; the ~9k LoC of generated WSO2
SOAP stubs are a legacy identity-provider integration deliberately out of
scope — the extension point is the store-backed management API itself).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.asset import Asset, AssetType
from sitewhere_tpu_torch.model.common import SearchCriteria, SearchResults, page
from sitewhere_tpu_torch.registry.store import InMemoryStore, _Collection


class AssetManagement:
    """IAssetManagement for one tenant."""

    def __init__(self, store=None, tenant_id: str = "default"):
        store = store or InMemoryStore()
        self.tenant_id = tenant_id
        self.asset_types: _Collection[AssetType] = _Collection(
            "asset_type", AssetType, store, ErrorCode.INVALID_ASSET_TOKEN)
        self.assets: _Collection[Asset] = _Collection(
            "asset", Asset, store, ErrorCode.INVALID_ASSET_TOKEN)

    # -- asset types -------------------------------------------------------
    def create_asset_type(self, asset_type: AssetType) -> AssetType:
        return self.asset_types.create(asset_type)

    def get_asset_type_by_token(self, token: str) -> AssetType:
        return self.asset_types.require_by_token(token)

    def update_asset_type(self, token: str, updates: Dict) -> AssetType:
        entity = self.asset_types.require_by_token(token)
        return self.asset_types.update(entity.id, updates)

    def delete_asset_type(self, token: str) -> AssetType:
        entity = self.asset_types.require_by_token(token)
        in_use = [a for a in self.assets.all()
                  if a.asset_type_id == entity.id]
        if in_use:
            raise SiteWhereError(
                f"asset type '{token}' in use by {len(in_use)} assets")
        return self.asset_types.delete(entity.id)

    def list_asset_types(self, criteria: Optional[SearchCriteria] = None
                         ) -> SearchResults[AssetType]:
        return self.asset_types.list(criteria)

    # -- assets ------------------------------------------------------------
    def create_asset(self, asset: Asset) -> Asset:
        if asset.asset_type_id:
            self.asset_types.require(asset.asset_type_id)
        return self.assets.create(asset)

    def get_asset_by_token(self, token: str) -> Asset:
        return self.assets.require_by_token(token)

    def get_asset(self, asset_id: str) -> Optional[Asset]:
        return self.assets.get(asset_id)

    def update_asset(self, token: str, updates: Dict) -> Asset:
        entity = self.assets.require_by_token(token)
        return self.assets.update(entity.id, updates)

    def delete_asset(self, token: str) -> Asset:
        entity = self.assets.require_by_token(token)
        return self.assets.delete(entity.id)

    def list_assets(self, asset_type_token: Optional[str] = None,
                    criteria: Optional[SearchCriteria] = None
                    ) -> SearchResults[Asset]:
        items = self.assets.all()
        if asset_type_token:
            asset_type = self.asset_types.require_by_token(asset_type_token)
            items = [a for a in items if a.asset_type_id == asset_type.id]
        return page(items, criteria or SearchCriteria())
