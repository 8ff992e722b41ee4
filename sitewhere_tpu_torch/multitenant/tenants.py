"""Tenant management: CRUD + model-update notifications.

Reference: service-tenant-management — ITenantManagement CRUD and the
tenant-model-updates Kafka topic (KafkaTopicNaming.java:41) that
MultitenantMicroservices watch to boot/stop tenant engines.

Cluster story: the collection-level mutation feed (`add_mutation_listener`)
is what `multitenant/replication.py` broadcasts to peer hosts; replicated
applies run under `replication()` so stamps adopt the writer's instead of
re-touching (the registry-gossip contract, registry/store.py).
"""

from __future__ import annotations

import json
import logging
import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.model.common import SearchCriteria, SearchResults, new_id
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.registry.store import InMemoryStore, _Collection
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS

LOGGER = logging.getLogger("sitewhere.tenants")


class TenantManagement:
    """ITenantManagement. `bus`/`naming` optional: when present, every
    mutation publishes a tenant-model-update record."""

    def __init__(self, store=None, bus=None, naming=None):
        store = store or InMemoryStore()
        self._replication = threading.local()
        self._mutation_listeners: List[Callable] = []
        self.tenants: _Collection[Tenant] = _Collection(
            "tenant", Tenant, store, ErrorCode.INVALID_TENANT_TOKEN,
            replicating=self._replicating,
            on_mutation=self._emit_mutation)
        self.bus = bus
        self.naming = naming
        self.notify_dead_lettered = GLOBAL_METRICS.counter(
            "tenants.notify_dead_lettered")

    # -- replication context ----------------------------------------------
    def _replicating(self) -> bool:
        return getattr(self._replication, "active", False)

    @contextmanager
    def replication(self):
        """Mark this thread as applying peer-replicated mutations
        (multitenant/replication.py): creates become idempotent and
        updates adopt the writer's stamp instead of re-touching."""
        prev = getattr(self._replication, "active", False)
        self._replication.active = True
        try:
            yield
        finally:
            self._replication.active = prev

    # -- mutation feed (cluster replication publish side) -----------------
    def add_mutation_listener(self, callback: Callable) -> None:
        """Subscribe to the COMPLETE (kind, op, entity) mutation feed."""
        self._mutation_listeners.append(callback)

    def _emit_mutation(self, kind: str, op: str, entity) -> None:
        for callback in list(self._mutation_listeners):
            callback(kind, op, entity)

    def _notify(self, operation: str, tenant: Tenant) -> None:
        if self.bus is None or self.naming is None:
            return
        topic = self.naming.tenant_model_updates()
        key = tenant.token.encode()
        value = json.dumps({"operation": operation,
                            "tenant": tenant.token}).encode()
        try:
            self.bus.publish(topic, key, value)
        except Exception:
            # The store mutation already committed: raising here would
            # desync store vs. topic (the caller would see a failure for a
            # write that happened). Park the notification on the
            # dead-letter topic for operator replay instead, and count it.
            self.notify_dead_lettered.inc()
            LOGGER.exception(
                "tenant-model-update publish failed for %s %r — parked on "
                "%s.dead-letter", operation, tenant.token, topic)
            try:
                self.bus.publish(f"{topic}.dead-letter", key, value)
            except Exception:
                LOGGER.exception("dead-letter parking failed too; "
                                 "notification for %s %r lost",
                                 operation, tenant.token)

    def create_tenant(self, tenant: Tenant) -> Tenant:
        if not tenant.authentication_token:
            tenant.authentication_token = new_id()
        created = self.tenants.create(tenant)
        self._notify("create", created)
        return created

    def get_tenant_by_token(self, token: str) -> Optional[Tenant]:
        return self.tenants.get_by_token(token)

    def get_tenant_by_authentication_token(self, auth_token: str
                                           ) -> Optional[Tenant]:
        for tenant in self.tenants.all():
            if tenant.authentication_token == auth_token:
                return tenant
        return None

    def update_tenant(self, token: str, updates: Dict) -> Tenant:
        entity = self.tenants.require_by_token(token)
        updated = self.tenants.update(entity.id, updates)
        self._notify("update", updated)
        return updated

    def delete_tenant(self, token: str) -> Tenant:
        entity = self.tenants.require_by_token(token)
        deleted = self.tenants.delete(entity.id)
        self._notify("delete", deleted)
        return deleted

    def list_tenants(self, criteria: Optional[SearchCriteria] = None,
                     authorized_user_id: Optional[str] = None
                     ) -> SearchResults[Tenant]:
        if authorized_user_id is None:
            return self.tenants.list(criteria)
        from sitewhere_tpu_torch.model.common import page
        items = [t for t in self.tenants.all()
                 if authorized_user_id in t.authorized_user_ids]
        return page(items, criteria or SearchCriteria())
