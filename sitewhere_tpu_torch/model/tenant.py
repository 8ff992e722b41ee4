"""Tenant model (sitewhere-core-api spi/tenant/ITenant.java)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from sitewhere_tpu_torch.model.common import BrandedEntity


@dataclass
class Tenant(BrandedEntity):
    """Isolated customer account (ITenant). `authentication_token` is the
    tenant token clients pass per request; `authorized_user_ids` gates access;
    `tenant_template_id` selects the bootstrap template (dataset + scripts)."""

    authentication_token: str = ""
    logo_url: str = ""
    authorized_user_ids: List[str] = field(default_factory=list)
    tenant_template_id: str = "default"
    dataset_template_id: str = "empty"
