"""Multitenancy: tenant CRUD, per-tenant engines, instance bootstrap.

Reference: service-tenant-management, MultitenantMicroservice.java:54,
MicroserviceTenantEngine, service-instance-management.
"""

from sitewhere_tpu_torch.multitenant.tenants import TenantManagement
from sitewhere_tpu_torch.multitenant.engine import TenantEngine, TenantEngineManager
from sitewhere_tpu_torch.multitenant.instance import (
    InstanceBootstrap, TenantTemplate, builtin_templates)

__all__ = ["InstanceBootstrap", "TenantEngine", "TenantEngineManager",
           "TenantManagement", "TenantTemplate", "builtin_templates"]
