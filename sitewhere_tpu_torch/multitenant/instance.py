"""Instance bootstrap: templates + initializers.

Reference: service-instance-management — InstanceTemplateManager.java:32
copies instance templates (user + tenant init scripts) into ZooKeeper and
runs GroovyUserModelInitializer / GroovyTenantModelInitializer. Here a
template is declarative data plus optional Python initializer callables (the
Groovy extension point without a JVM), applied directly to the managements.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.model.area import Area, AreaType, Zone
from sitewhere_tpu_torch.model.common import Location
from sitewhere_tpu_torch.model.device import Device, DeviceAssignment, DeviceType
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.model.user import SiteWhereRoles, User

LOGGER = logging.getLogger("sitewhere.instance")


@dataclass
class TenantTemplate:
    """Declarative tenant bootstrap dataset (the reference's tenant
    templates: 'empty', 'construction', ... with Groovy initializers)."""

    template_id: str
    name: str = ""
    device_types: List[DeviceType] = field(default_factory=list)
    area_types: List[AreaType] = field(default_factory=list)
    areas: List[Area] = field(default_factory=list)
    zones: List[Zone] = field(default_factory=list)  # area token in area_id
    devices: List[Device] = field(default_factory=list)  # type token in device_type_id
    assign_all: bool = False  # auto-assign created devices
    initializers: List[Callable] = field(default_factory=list)  # (engine) -> None

    def apply(self, engine) -> None:
        """Materialize the dataset into a TenantEngine's registries.

        Entities are deep-copied and re-identified per tenant — a template is
        shared across every tenant that bootstraps from it, so handing the
        same instances to two registries would alias mutable state across
        tenants."""
        import copy

        from sitewhere_tpu_torch.model.common import new_id

        def fresh(entity):
            clone = copy.deepcopy(entity)
            clone.id = new_id()
            return clone

        registry = engine.registry
        for area_type in self.area_types:
            registry.create_area_type(fresh(area_type))
        area_ids: Dict[str, str] = {}
        for area in self.areas:
            created = registry.create_area(fresh(area))
            area_ids[created.token] = created.id
        for zone in self.zones:
            clone = fresh(zone)
            if clone.area_id in area_ids:  # token -> id
                clone.area_id = area_ids[clone.area_id]
            registry.create_zone(clone)
        type_ids: Dict[str, str] = {}
        for device_type in self.device_types:
            created = registry.create_device_type(fresh(device_type))
            type_ids[created.token] = created.id
        for device in self.devices:
            clone = fresh(device)
            if clone.device_type_id in type_ids:  # token -> id
                clone.device_type_id = type_ids[clone.device_type_id]
            created = registry.create_device(clone)
            if self.assign_all:
                registry.create_device_assignment(
                    DeviceAssignment(device_id=created.id))
        for initializer in self.initializers:
            initializer(engine)


def builtin_templates() -> Dict[str, TenantTemplate]:
    """'empty' + a small demo dataset (the reference ships template-empty
    and template-construction)."""
    demo = TenantTemplate(
        template_id="demo", name="Demo dataset",
        device_types=[DeviceType(token="gateway", name="Gateway"),
                      DeviceType(token="sensor", name="Sensor")],
        areas=[Area(token="site-1", name="Site 1")],
        zones=[Zone(token="perimeter", area_id="site-1", bounds=[
            Location(0.0, 0.0), Location(0.0, 1.0), Location(1.0, 1.0),
            Location(1.0, 0.0)])],
        devices=[Device(token=f"demo-{i}", device_type_id="sensor")
                 for i in range(4)],
        assign_all=True)
    return {
        "empty": TenantTemplate(template_id="empty", name="Empty"),
        "demo": demo,
    }


class InstanceBootstrap:
    """Instance-level bring-up (InstanceTemplateManager + user/tenant model
    initializers): default admin user + default tenant, then template
    application whenever an engine boots."""

    def __init__(self, user_management, tenant_management,
                 templates: Optional[Dict[str, TenantTemplate]] = None,
                 admin_username: str = "admin",
                 admin_password: str = "password"):
        self.users = user_management
        self.tenants = tenant_management
        self.templates = templates or builtin_templates()
        self.admin_username = admin_username
        self.admin_password = admin_password

    def bootstrap_users(self) -> None:
        if self.users.get_user_by_username(self.admin_username) is None:
            self.users.create_user(
                User(username=self.admin_username, first_name="Admin",
                     authorities=list(SiteWhereRoles.ALL)),
                password=self.admin_password)

    def bootstrap_default_tenant(self, token: str = "default",
                                 template_id: str = "empty") -> Tenant:
        tenant = self.tenants.get_tenant_by_token(token)
        if tenant is None:
            # deterministic authentication token: every cluster host
            # bootstraps this tenant independently, and identical content
            # means the replicated creates converge as no-ops instead of
            # LWW-merging a random per-host token (which would restart
            # the engine on every losing host at boot)
            tenant = self.tenants.create_tenant(Tenant(
                token=token, name=token.title(),
                authentication_token=f"{token}-auth",
                tenant_template_id=template_id))
        return tenant

    def apply_template(self, engine) -> None:
        """Run on tenant-engine boot (tenantInitialize in the reference)."""
        template = self.templates.get(engine.tenant.tenant_template_id)
        if template is None:
            LOGGER.warning("unknown tenant template '%s'",
                           engine.tenant.tenant_template_id)
            return
        template.apply(engine)
