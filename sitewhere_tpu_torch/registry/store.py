"""Registry CRUD store: the IDeviceManagement surface.

Reference: sitewhere-core-api spi/device/IDeviceManagement.java (device types,
commands, statuses, devices, assignments, areas/area types, zones, customers/
customer types, device groups, alarms — the 84-rpc device-management surface)
with pluggable persistence like the reference's mongodb/hbase choice
(service-device-management/persistence/*). Backends here: InMemoryStore
(dict-of-dicts) and SqliteStore (stdlib sqlite3, one row per entity, JSON
payload, token/id indexed) — write-through from the in-memory maps.

All reads the hot path needs are mirrored into RegistryTensors
(registry/tensors.py); this store is control-plane only.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generic, Iterable, List, Optional, Type, TypeVar

from sitewhere_tpu_torch.errors import DuplicateTokenError, ErrorCode, NotFoundError, SiteWhereError
from sitewhere_tpu_torch.model import (
    Area, AreaType, Customer, CustomerType, Device, DeviceAlarm, DeviceAssignment,
    DeviceAssignmentStatus, DeviceCommand, DeviceGroup, DeviceGroupElement,
    DeviceStatus, DeviceType, Zone,
)
from sitewhere_tpu_torch.model.common import (
    SearchCriteria, SearchResults, new_id, now_ms, page)
from sitewhere_tpu_torch.model.device import CommandParameter, DeviceElementMapping, ParameterType

T = TypeVar("T")


# ---------------------------------------------------------------------------
# (de)serialization helpers
# ---------------------------------------------------------------------------

def _entity_to_json(entity: Any) -> str:
    def default(obj: Any) -> Any:
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.asdict(obj)
        if hasattr(obj, "value"):
            return obj.value
        raise TypeError(type(obj))
    return json.dumps(dataclasses.asdict(entity), default=default)


def _element_schema_from_dict(data: dict):
    """Recursive unit/slot tree decode (IDeviceElementSchema)."""
    from sitewhere_tpu_torch.model.device import (
        DeviceElementSchema, DeviceSlot, DeviceUnit)

    def unit(d: dict, cls):
        return cls(
            name=d.get("name", ""), path=d.get("path", ""),
            device_slots=[DeviceSlot(name=s.get("name", ""),
                                     path=s.get("path", ""))
                          for s in d.get("device_slots", [])],
            device_units=[unit(u, DeviceUnit)
                          for u in d.get("device_units", [])])

    return unit(data, DeviceElementSchema)


_NESTED_FIELDS: Dict[Type, Dict[str, Callable[[dict], Any]]] = {
    Device: {"device_element_mappings": lambda d: DeviceElementMapping(**d)},
    DeviceCommand: {"parameters": lambda d: CommandParameter(
        name=d["name"], type=ParameterType(d["type"]), required=d["required"])},
    DeviceType: {"device_element_schema": _element_schema_from_dict},
}


def _entity_from_json(cls: Type[T], payload: str) -> T:
    data = json.loads(payload)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    nested = _NESTED_FIELDS.get(cls, {})
    for key, val in data.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        if key in nested and isinstance(val, list):
            val = [nested[key](v) for v in val]
        elif key in nested and isinstance(val, dict):
            val = nested[key](val)
        elif isinstance(ftype, str):
            # enum-typed fields are stored by value
            resolved = _ENUM_TYPES.get(ftype)
            if resolved is not None and val is not None:
                val = resolved(val)
        kwargs[key] = val
    # Location lists come back as dicts
    if cls in (Area, Zone) and "bounds" in kwargs:
        from sitewhere_tpu_torch.model.common import Location
        kwargs["bounds"] = [Location(**b) if isinstance(b, dict) else b
                            for b in kwargs["bounds"]]
    return cls(**kwargs)


from sitewhere_tpu_torch.model.device import DeviceContainerPolicy
from sitewhere_tpu_torch.model.device import DeviceAlarmState
from sitewhere_tpu_torch.model.asset import AssetCategory
from sitewhere_tpu_torch.model.batch import (
    BatchOperationStatus, ElementProcessingStatus)
from sitewhere_tpu_torch.model.schedule import (
    ScheduledJobState, ScheduledJobType, TriggerType)

_ENUM_TYPES = {
    "DeviceAssignmentStatus": DeviceAssignmentStatus,
    "DeviceContainerPolicy": DeviceContainerPolicy,
    "DeviceAlarmState": DeviceAlarmState,
    "AssetCategory": AssetCategory,
    "BatchOperationStatus": BatchOperationStatus,
    "ElementProcessingStatus": ElementProcessingStatus,
    "TriggerType": TriggerType,
    "ScheduledJobType": ScheduledJobType,
    "ScheduledJobState": ScheduledJobState,
}


# ---------------------------------------------------------------------------
# storage backends
# ---------------------------------------------------------------------------

class InMemoryStore:
    """No-op durable backend: everything lives in DeviceManagement's maps."""

    def save(self, kind: str, entity_id: str, token: str, payload: str) -> None:
        pass

    def delete(self, kind: str, entity_id: str) -> None:
        pass

    def load_all(self, kind: str) -> Iterable[tuple]:
        return []

    def close(self) -> None:
        pass


class SqliteStore:
    """Durable backend on stdlib sqlite3 (reference analogue: the MongoDB
    persistence tier, MongoDeviceManagement)."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS entities ("
            " kind TEXT NOT NULL, id TEXT NOT NULL, token TEXT NOT NULL,"
            " payload TEXT NOT NULL, PRIMARY KEY (kind, id))")
        self._conn.execute(
            "CREATE INDEX IF NOT EXISTS idx_entities_token ON entities (kind, token)")
        self._conn.commit()

    def save(self, kind: str, entity_id: str, token: str, payload: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO entities (kind, id, token, payload)"
                " VALUES (?, ?, ?, ?)", (kind, entity_id, token, payload))
            self._conn.commit()

    def delete(self, kind: str, entity_id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM entities WHERE kind=? AND id=?",
                               (kind, entity_id))
            self._conn.commit()

    def load_all(self, kind: str) -> Iterable[tuple]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, token, payload FROM entities WHERE kind=?", (kind,)
            ).fetchall()
        return rows

    def close(self) -> None:
        with self._lock:
            self._conn.close()


# ---------------------------------------------------------------------------
# generic collection
# ---------------------------------------------------------------------------

class _Collection(Generic[T]):
    """Token+id indexed entity map with write-through persistence.

    ``replicating`` (a nullary callable) marks threads applying
    PEER-REPLICATED mutations (parallel/cluster.py RegistryGossip): a
    replicated create of an existing token is idempotent (at-least-once
    redelivery), a fresh replicated create marks its token so a later
    IDENTICAL local create merges into it instead of raising — cluster
    hosts provision the same world in any order, the way the reference's
    shared store makes creates race-free across processes
    (service-device-management persistence/mongodb/MongoDeviceManagement.java).
    """

    # identity + provenance fields a local create never overwrites when
    # claiming a replicated entity
    _MERGE_SKIP = frozenset({"id", "token", "created_date", "created_by"})

    def __init__(self, kind: str, cls: Type[T], store: Any,
                 not_found: ErrorCode,
                 replicating: Optional[Callable[[], bool]] = None,
                 on_mutation: Optional[Callable[[str, str, T], None]] = None):
        self.kind = kind
        self.cls = cls
        self.store = store
        self.not_found = not_found
        self.by_id: Dict[str, T] = {}
        self.by_token: Dict[str, T] = {}
        self._lock = threading.RLock()
        self._is_replicating = replicating or (lambda: False)
        # complete (kind, op, entity) feed across every mutation path —
        # what the cluster replicates; fired OUTSIDE the collection lock
        # (the callback may do network I/O)
        self._on_mutation = on_mutation
        # unclaimed-replica markers persist under a reserved kind (load_all
        # is always kind-filtered) so the claim contract survives the gang
        # restarts that rebuild every host from durable state
        self._replica_kind = f"{kind}#replica"
        self._replicated_tokens: set = {
            tok for _, tok, _ in store.load_all(self._replica_kind)}
        for _id, _token, payload in store.load_all(kind):
            entity = _entity_from_json(cls, payload)
            self.by_id[_id] = entity
            if _token:
                self.by_token[_token] = entity

    def _emit(self, op: str, entity: T) -> None:
        if self._on_mutation is not None:
            self._on_mutation(self.kind, op, entity)

    def create(self, entity: T) -> T:
        with self._lock:
            token = getattr(entity, "token", "")
            if not token:
                # reference behavior: token auto-assigned when not provided
                # (Persistence.java entityCreateLogic UUID fallback)
                token = new_id()
                entity.token = token
            existing = self.by_token.get(token)
            if existing is not None:
                if self._is_replicating():
                    return existing  # peer redelivery: idempotent
                merged = self._merge_replicated_locked(entity, existing)
                if merged is None:
                    raise DuplicateTokenError(
                        f"{self.kind} token '{token}' already exists")
            else:
                if self._is_replicating():
                    self._replicated_tokens.add(token)
                    self.store.save(self._replica_kind, token, token, "{}")
                self.by_id[entity.id] = entity
                self.by_token[token] = entity
                self.store.save(self.kind, entity.id, token,
                                _entity_to_json(entity))
        if existing is not None:
            self._emit("update", existing)  # claimed replica
            return existing
        self._emit("create", entity)
        return entity

    def claimable_replica(self, token: str) -> bool:
        """True when `token` names an unclaimed replicated entity a local
        create may merge into (callers peek before mutating their input)."""
        with self._lock:
            return token in self._replicated_tokens

    def merge_replicated(self, entity: T) -> Optional[T]:
        """Claim an unclaimed replica for a colliding local create; None
        when the existing entity is a genuine duplicate (or absent)."""
        with self._lock:
            existing = self.by_token.get(getattr(entity, "token", ""))
            if existing is None:
                return None
            merged = self._merge_replicated_locked(entity, existing)
        if merged is not None:
            self._emit("update", merged)
        return merged

    def _merge_replicated_locked(self, entity: T, existing: T) -> Optional[T]:
        token = getattr(entity, "token", "")
        if token not in self._replicated_tokens:
            return None
        # the replica keeps its (peer-adopted) id so references already
        # bound to it stay valid; the local create intent wins the fields
        self._discard_replica_locked(token)
        for field in dataclasses.fields(existing):
            if field.name not in self._MERGE_SKIP:
                setattr(existing, field.name, getattr(entity, field.name))
        # the claim is a NEW write: stamp past the replica's so the
        # emitted update wins last-writer-wins on every peer (without
        # this, it would tie the original create's stamp and the digest
        # could keep the pre-claim content on other hosts)
        existing.touch()
        self.store.save(self.kind, existing.id, token,
                        _entity_to_json(existing))
        return existing

    def _discard_replica_locked(self, token: str) -> None:
        if token in self._replicated_tokens:
            self._replicated_tokens.discard(token)
            self.store.delete(self._replica_kind, token)

    def get(self, entity_id: str) -> Optional[T]:
        return self.by_id.get(entity_id)

    def get_by_token(self, token: str) -> Optional[T]:
        return self.by_token.get(token)

    def require(self, entity_id: str) -> T:
        entity = self.by_id.get(entity_id)
        if entity is None:
            raise NotFoundError(f"{self.kind} id '{entity_id}' not found",
                                self.not_found)
        return entity

    def require_by_token(self, token: str) -> T:
        entity = self.by_token.get(token)
        if entity is None:
            raise NotFoundError(f"{self.kind} token '{token}' not found",
                                self.not_found)
        return entity

    def update(self, entity_id: str, updates: Dict[str, Any],
               username: str = "") -> T:
        with self._lock:
            entity = self.require(entity_id)
            old_token = getattr(entity, "token", "")
            # validate every key before mutating, so a bad update leaves the
            # entity untouched (and in-memory state consistent with storage)
            for key in updates:
                if not hasattr(entity, key):
                    raise SiteWhereError(f"unknown field '{key}' on {self.kind}")
            nested = _NESTED_FIELDS.get(self.cls, {})
            for key, val in updates.items():
                # REST updates carry nested structures as plain dicts:
                # coerce through the same decoders the load path uses so
                # in-memory state always holds typed objects (internal
                # callers pass dataclasses and skip this)
                if key in nested:
                    if isinstance(val, dict):
                        val = nested[key](val)
                    elif isinstance(val, list):
                        val = [nested[key](v) if isinstance(v, dict) else v
                               for v in val]
                setattr(entity, key, val)
            if not self._is_replicating():
                entity.touch(username)
            # else: a replicated update carries the WRITER's updated_date in
            # `updates` — adopting it (not re-stamping) is what makes
            # last-writer-wins comparisons agree on every host
            # Any update ends the claim window: a late local create of this
            # token must now raise on EVERY host (the claim-merge contract
            # covers boot-time provisioning races only, not clobbering an
            # entity that has since moved on — e.g. a released assignment)
            self._discard_replica_locked(old_token)
            new_token = getattr(entity, "token", "")
            if new_token != old_token:
                if new_token in self.by_token:
                    raise DuplicateTokenError(
                        f"{self.kind} token '{new_token}' already exists")
                self.by_token.pop(old_token, None)
                self._discard_replica_locked(old_token)
                if new_token:
                    self.by_token[new_token] = entity
            self.store.save(self.kind, entity.id, new_token, _entity_to_json(entity))
        self._emit("update", entity)
        return entity

    def delete(self, entity_id: str) -> T:
        with self._lock:
            entity = self.require(entity_id)
            del self.by_id[entity_id]
            token = getattr(entity, "token", "")
            if token:
                self.by_token.pop(token, None)
                self._discard_replica_locked(token)
            self.store.delete(self.kind, entity_id)
        self._emit("delete", entity)
        return entity

    def save(self, entity: T) -> None:
        """Persist in-place mutations."""
        token = getattr(entity, "token", "")
        with self._lock:
            self.store.save(self.kind, entity.id, token,
                            _entity_to_json(entity))
            self._discard_replica_locked(token)  # mutation ends the claim
        self._emit("update", entity)

    def persist_quietly(self, entity: T) -> None:
        """Persist WITHOUT firing listeners or ending a claim window —
        for metadata-only normalization (the gossip publish side stamps a
        resurrecting create past its tombstone AFTER create() already
        saved; the durable row must carry the same stamp or a restart
        rehydrates a weaker one and a redelivered delete wins here
        alone)."""
        with self._lock:
            self.store.save(self.kind, entity.id,
                            getattr(entity, "token", ""),
                            _entity_to_json(entity))

    def list(self, criteria: Optional[SearchCriteria] = None,
             where: Optional[Callable[[T], bool]] = None) -> SearchResults[T]:
        with self._lock:
            items = [e for e in self.by_id.values() if where is None or where(e)]
        items.sort(key=lambda e: getattr(e, "created_date", 0))
        return page(items, criteria or SearchCriteria(page_size=10 ** 9))

    def all(self) -> List[T]:
        with self._lock:
            return list(self.by_id.values())

    def __len__(self) -> int:
        return len(self.by_id)


# ---------------------------------------------------------------------------
# the IDeviceManagement surface
# ---------------------------------------------------------------------------

class DeviceManagement:
    """Full registry API (IDeviceManagement.java). One instance per tenant
    engine, like the reference's per-tenant store delegates.

    Mutations invalidate listeners (pipeline mirrors subscribe via
    `add_listener` — the reference's DeviceManagementTriggers Kafka
    notifications, collapsed to an in-proc callback)."""

    def __init__(self, store: Any = None, tenant_id: str = "default"):
        store = store or InMemoryStore()
        self.tenant_id = tenant_id
        self.store = store
        self._replication = threading.local()
        E = ErrorCode

        def coll(kind: str, cls: Type, err: ErrorCode) -> _Collection:
            return _Collection(kind, cls, store, err,
                               replicating=self._replicating,
                               on_mutation=self._emit_mutation)

        self.device_types: _Collection[DeviceType] = coll(
            "device_type", DeviceType, E.INVALID_DEVICE_TYPE_TOKEN)
        self.device_commands: _Collection[DeviceCommand] = coll(
            "device_command", DeviceCommand, E.INVALID_COMMAND_TOKEN)
        self.device_statuses: _Collection[DeviceStatus] = coll(
            "device_status", DeviceStatus, E.INVALID_DEVICE_TOKEN)
        self.devices: _Collection[Device] = coll(
            "device", Device, E.INVALID_DEVICE_TOKEN)
        self.assignments: _Collection[DeviceAssignment] = coll(
            "assignment", DeviceAssignment, E.INVALID_ASSIGNMENT_TOKEN)
        self.area_types: _Collection[AreaType] = coll(
            "area_type", AreaType, E.INVALID_AREA_TOKEN)
        self.areas: _Collection[Area] = coll(
            "area", Area, E.INVALID_AREA_TOKEN)
        self.zones: _Collection[Zone] = coll(
            "zone", Zone, E.INVALID_ZONE_TOKEN)
        self.customer_types: _Collection[CustomerType] = coll(
            "customer_type", CustomerType, E.INVALID_CUSTOMER_TOKEN)
        self.customers: _Collection[Customer] = coll(
            "customer", Customer, E.INVALID_CUSTOMER_TOKEN)
        self.device_groups: _Collection[DeviceGroup] = coll(
            "device_group", DeviceGroup, E.INVALID_GROUP_TOKEN)
        self.group_elements: _Collection[DeviceGroupElement] = coll(
            "group_element", DeviceGroupElement, E.INVALID_GROUP_TOKEN)
        self.alarms: _Collection[DeviceAlarm] = coll(
            "alarm", DeviceAlarm, E.INVALID_DEVICE_TOKEN)
        self._listeners: List[Callable[[str, Any], None]] = []
        self._mutation_listeners: List[Callable[[str, str, Any], None]] = []
        # serializes composite-mapping create/delete: the validate + two-
        # update sequence must not interleave across threads (two
        # concurrent creates could both pass the unmapped/unparented
        # checks and double-map a child or a slot path)
        self._mapping_lock = threading.Lock()
        # device_id -> active assignment (the hot lookup of
        # InboundPayloadProcessingLogic.validateAssignment:179)
        self._active_assignment: Dict[str, DeviceAssignment] = {}
        for assignment in self.assignments.all():
            if assignment.status == DeviceAssignmentStatus.ACTIVE:
                self._active_assignment[assignment.device_id] = assignment

    # -- replication context --------------------------------------------------

    def _replicating(self) -> bool:
        return getattr(self._replication, "active", False)

    @contextmanager
    def replication(self):
        """Mark this thread as applying peer-replicated mutations
        (parallel/cluster.py RegistryGossip): creates become idempotent
        get-or-create and their entities stay claimable by a later
        identical local create, so cluster hosts can provision the same
        world in any order relative to gossip arrival. Reentrant: nested
        contexts restore the prior flag, not False."""
        prev = getattr(self._replication, "active", False)
        self._replication.active = True
        try:
            yield
        finally:
            self._replication.active = prev

    # -- change notification --------------------------------------------------

    def add_listener(self, callback: Callable[[str, Any], None]) -> None:
        self._listeners.append(callback)

    def _notify(self, kind: str, entity: Any) -> None:
        for callback in list(self._listeners):
            callback(kind, entity)

    def add_mutation_listener(
            self, callback: Callable[[str, str, Any], None]) -> None:
        """Subscribe to the COMPLETE (kind, op, entity) mutation feed —
        every create/update/delete on every collection, fired from the
        collections themselves so no wrapper can forget to notify. This is
        what cluster replication rides (parallel/cluster.py RegistryGossip,
        the role of the reference's DeviceManagementTriggers Kafka
        notifications, sitewhere-microservice DeviceManagementTriggers)."""
        self._mutation_listeners.append(callback)

    def _emit_mutation(self, kind: str, op: str, entity: Any) -> None:
        for callback in list(self._mutation_listeners):
            callback(kind, op, entity)

    # -- kind dispatch (replication appliers) ----------------------------------

    def collection_of(self, kind: str) -> _Collection:
        return {
            "device_type": self.device_types,
            "device_command": self.device_commands,
            "device_status": self.device_statuses,
            "device": self.devices,
            "assignment": self.assignments,
            "area_type": self.area_types,
            "area": self.areas,
            "zone": self.zones,
            "customer_type": self.customer_types,
            "customer": self.customers,
            "device_group": self.device_groups,
            "group_element": self.group_elements,
            "alarm": self.alarms,
        }[kind]

    def create_by_kind(self, kind: str, entity: Any) -> Any:
        """Create through the kind's wrapper (side effects: active-
        assignment index, mirror notifications) — the uniform entry the
        replication applier uses for every entity kind."""
        wrapper = {
            "device_type": self.create_device_type,
            "device_command": self.create_device_command,
            "device_status": self.create_device_status,
            "device": self.create_device,
            "assignment": self.create_device_assignment,
            "area_type": self.create_area_type,
            "area": self.create_area,
            "zone": self.create_zone,
            "customer_type": self.create_customer_type,
            "customer": self.create_customer,
            "device_group": self.create_device_group,
            "alarm": self.create_device_alarm,
        }.get(kind)
        if wrapper is not None:
            return wrapper(entity)
        return self.collection_of(kind).create(entity)

    def update_by_kind(self, kind: str, token: str, updates: Dict) -> Any:
        """Update by token through the kind's wrapper where one exists
        (mirror notifications), the collection otherwise."""
        wrapper = {
            "device_type": self.update_device_type,
            "device": self.update_device,
            "zone": self.update_zone,
        }.get(kind)
        if wrapper is not None:
            return wrapper(token, updates)
        collection = self.collection_of(kind)
        result = collection.update(collection.require_by_token(token).id,
                                   updates)
        self._notify(kind, result)
        return result

    def delete_by_kind(self, kind: str, token: str) -> Any:
        """Delete by token through the kind's wrapper where one exists
        (referential validation + index upkeep), the collection otherwise."""
        wrapper = {
            "device_type": self.delete_device_type,
            "device": self.delete_device,
            "zone": self.delete_zone,
            "assignment": self.delete_device_assignment,
        }.get(kind)
        if wrapper is not None:
            return wrapper(token)
        collection = self.collection_of(kind)
        result = collection.delete(collection.require_by_token(token).id)
        self._notify(kind, result)
        return result

    # -- device types / commands / statuses -----------------------------------

    def create_device_type(self, device_type: DeviceType) -> DeviceType:
        result = self.device_types.create(device_type)
        self._notify("device_type", result)
        return result

    def get_device_type(self, device_type_id: str) -> Optional[DeviceType]:
        return self.device_types.get(device_type_id)

    def get_device_type_by_token(self, token: str) -> DeviceType:
        return self.device_types.require_by_token(token)

    def update_device_type(self, token: str, updates: Dict) -> DeviceType:
        entity = self.device_types.require_by_token(token)
        result = self.device_types.update(entity.id, updates)
        self._notify("device_type", result)
        return result

    def delete_device_type(self, token: str) -> DeviceType:
        entity = self.device_types.require_by_token(token)
        in_use = any(d.device_type_id == entity.id for d in self.devices.all())
        if in_use:
            raise SiteWhereError("device type in use",
                                 ErrorCode.DEVICE_TYPE_IN_USE)
        result = self.device_types.delete(entity.id)
        self._notify("device_type", result)
        return result

    def list_device_types(self, criteria: Optional[SearchCriteria] = None
                          ) -> SearchResults[DeviceType]:
        return self.device_types.list(criteria)

    def create_device_command(self, command: DeviceCommand) -> DeviceCommand:
        return self.device_commands.create(command)

    def get_device_command_by_token(self, token: str) -> DeviceCommand:
        return self.device_commands.require_by_token(token)

    def list_device_commands(self, device_type_token: Optional[str] = None
                             ) -> SearchResults[DeviceCommand]:
        type_id = (self.device_types.require_by_token(device_type_token).id
                   if device_type_token else None)
        return self.device_commands.list(
            where=(lambda c: c.device_type_id == type_id) if type_id else None)

    def create_device_status(self, status: DeviceStatus) -> DeviceStatus:
        return self.device_statuses.create(status)

    def list_device_statuses(self, device_type_token: Optional[str] = None
                             ) -> SearchResults[DeviceStatus]:
        type_id = (self.device_types.require_by_token(device_type_token).id
                   if device_type_token else None)
        return self.device_statuses.list(
            where=(lambda s: s.device_type_id == type_id) if type_id else None)

    # -- devices ---------------------------------------------------------------

    def create_device(self, device: Device) -> Device:
        if device.device_type_id:
            self.device_types.require(device.device_type_id)
        result = self.devices.create(device)
        self._notify("device", result)
        return result

    def get_device(self, device_id: str) -> Device:
        return self.devices.require(device_id)

    def get_device_by_token(self, token: str) -> Optional[Device]:
        return self.devices.get_by_token(token)

    def update_device(self, token: str, updates: Dict) -> Device:
        entity = self.devices.require_by_token(token)
        result = self.devices.update(entity.id, updates)
        self._notify("device", result)
        return result

    def delete_device(self, token: str) -> Device:
        entity = self.devices.require_by_token(token)
        active = self._active_assignment.get(entity.id)
        if active is not None:
            raise SiteWhereError("device has an active assignment",
                                 ErrorCode.DEVICE_ALREADY_ASSIGNED)
        # deleting a composite gateway releases its children (clear the
        # parent backreferences so nesting lookups can't dangle); a
        # mapped CHILD must be unmapped first (the parent still lists
        # it). A DANGLING backreference — live parent gone or no longer
        # listing the mapping (replicated tombstone orderings) — must
        # not block deletion forever.
        if entity.parent_device_id:
            parent = self.devices.get(entity.parent_device_id)
            if parent is not None and any(
                    m.device_token == token
                    for m in parent.device_element_mappings):
                raise SiteWhereError(
                    f"device '{token}' is mapped into a composite "
                    f"parent; delete the mapping first", ErrorCode.GENERIC,
                    http_status=409)
        for mapping in entity.device_element_mappings:
            child = self.devices.get_by_token(mapping.device_token)
            if child is not None and child.parent_device_id == entity.id:
                self.update_device(child.token, {"parent_device_id": ""})
        result = self.devices.delete(entity.id)
        self._notify("device", result)
        return result

    def list_devices(self, criteria: Optional[SearchCriteria] = None,
                     device_type_token: Optional[str] = None,
                     assigned: Optional[bool] = None) -> SearchResults[Device]:
        type_id = (self.device_types.require_by_token(device_type_token).id
                   if device_type_token else None)

        def where(d: Device) -> bool:
            if type_id and d.device_type_id != type_id:
                return False
            if assigned is not None:
                if assigned != (d.id in self._active_assignment):
                    return False
            return True

        return self.devices.list(criteria, where)

    # -- composite-device element mappings -------------------------------------

    def create_device_element_mapping(self, device_token: str,
                                      mapping: "DeviceElementMapping"
                                      ) -> Device:
        """Map a child device into a slot of a composite parent
        (DeviceManagementPersistence.deviceElementMappingCreateLogic:657):
        the child must exist and be unparented, the path must resolve to a
        DeviceSlot in the parent TYPE's element schema, and the path must
        be unmapped. Sets the child's parent backreference; both updates
        ride the normal mutation feed (replicated, durable).

        The whole validate + two-update sequence runs under the registry
        mapping mutex (two concurrent creates must not both pass the
        unmapped checks), and a failure of the parent-list update rolls
        the child's parent backreference back — no half-applied mapping
        survives."""
        from sitewhere_tpu_torch.model.device import find_device_slot

        with self._mapping_lock:
            return self._create_device_element_mapping_locked(
                device_token, mapping, find_device_slot)

    def _create_device_element_mapping_locked(self, device_token: str,
                                              mapping, find_device_slot
                                              ) -> Device:
        device = self.devices.require_by_token(device_token)
        mapped = self.devices.get_by_token(mapping.device_token)
        if mapped is None:
            raise NotFoundError(
                f"mapping references unknown device "
                f"'{mapping.device_token}'", ErrorCode.INVALID_DEVICE_TOKEN)
        if mapped.parent_device_id:
            raise SiteWhereError(
                f"device '{mapped.token}' is already mapped into another "
                f"composite device", ErrorCode.GENERIC, http_status=409)
        # no self-mapping and no cycles: the child may not appear on the
        # gateway's own parent chain (A->A, or A->B when B is already an
        # ancestor of A, would make nesting resolution circular)
        ancestor = device
        while ancestor is not None:
            if ancestor.id == mapped.id:
                raise SiteWhereError(
                    f"mapping '{mapped.token}' into '{device.token}' "
                    f"would create a composite cycle", ErrorCode.GENERIC,
                    http_status=409)
            ancestor = (self.devices.get(ancestor.parent_device_id)
                        if ancestor.parent_device_id else None)
        dtype = self.device_types.get(device.device_type_id)
        slot = find_device_slot(
            dtype.device_element_schema if dtype else None,
            mapping.device_element_schema_path)
        if slot is None:
            raise SiteWhereError(
                f"path '{mapping.device_element_schema_path}' does not "
                f"name a device slot in type "
                f"'{dtype.token if dtype else '?'}'s element schema",
                ErrorCode.GENERIC, http_status=400)
        existing = device.device_element_mappings
        if any(m.device_element_schema_path ==
               mapping.device_element_schema_path for m in existing):
            raise SiteWhereError(
                f"path '{mapping.device_element_schema_path}' already has "
                f"a device mapped", ErrorCode.DUPLICATE_TOKEN,
                http_status=409)
        # parent backreference first (the reference's order, :688-694)
        self.update_device(mapped.token, {"parent_device_id": device.id})
        try:
            return self.update_device(device_token, {
                "device_element_mappings": existing + [mapping]})
        except BaseException:
            # second update failed (listener raise, replicated-tombstone
            # race, ...): un-parent the child so the failed mapping
            # leaves no dangling backreference
            try:
                self.update_device(mapped.token, {"parent_device_id": ""})
            except Exception:
                pass  # child row vanished mid-rollback: nothing dangles
            raise

    def delete_device_element_mapping(self, device_token: str,
                                      path: str) -> Device:
        """Remove the mapping at `path` and clear the child's parent
        backreference (deviceElementMappingDeleteLogic:709). Serialized
        under the same mapping mutex as create — a delete interleaving
        with a concurrent create's validate window could otherwise free a
        slot both see as mapped/unmapped at once."""
        with self._mapping_lock:
            device = self.devices.require_by_token(device_token)
            match = next((m for m in device.device_element_mappings
                          if m.device_element_schema_path == path), None)
            if match is None:
                raise NotFoundError(
                    f"no device mapping at path '{path}'", ErrorCode.GENERIC)
            mapped = self.devices.get_by_token(match.device_token)
            if mapped is not None and mapped.parent_device_id == device.id:
                self.update_device(mapped.token, {"parent_device_id": ""})
            remaining = [m for m in device.device_element_mappings
                         if m.device_element_schema_path != path]
            return self.update_device(device_token, {
                "device_element_mappings": remaining})

    # -- assignments -----------------------------------------------------------

    def create_device_assignment(self, assignment: DeviceAssignment
                                 ) -> DeviceAssignment:
        device = self.devices.require(assignment.device_id)
        if not assignment.device_type_id:
            assignment.device_type_id = device.device_type_id
        active = self._active_assignment.get(device.id)
        if active is not None:
            token = getattr(assignment, "token", "")
            if active.token == token:
                if self._replicating():
                    return active  # peer redelivery: idempotent
                # the replication applier may have installed this very
                # assignment before the operator's own provisioning ran:
                # claim it instead of refusing (peek first — the genuine-
                # duplicate path must raise without mutating the input)
                if self.assignments.claimable_replica(token):
                    assignment.status = DeviceAssignmentStatus.ACTIVE
                    assignment.active_date = active.active_date
                    merged = self.assignments.merge_replicated(assignment)
                    if merged is not None:
                        self._notify("assignment", merged)
                        return merged
            raise SiteWhereError(
                f"device '{device.token}' already has an active assignment",
                ErrorCode.DEVICE_ALREADY_ASSIGNED)
        assignment.status = DeviceAssignmentStatus.ACTIVE
        # a replicated create carries the CREATING host's activation time —
        # keep it so replicas agree on active_date
        if not (self._replicating() and assignment.active_date):
            assignment.active_date = now_ms()
        result = self.assignments.create(assignment)
        self._active_assignment[device.id] = result
        self._notify("assignment", result)
        return result

    def get_device_assignment(self, assignment_id: str) -> DeviceAssignment:
        return self.assignments.require(assignment_id)

    def get_device_assignment_by_token(self, token: str) -> Optional[DeviceAssignment]:
        return self.assignments.get_by_token(token)

    def get_active_assignment(self, device_id: str) -> Optional[DeviceAssignment]:
        """The per-event validation lookup (hot in the reference, tensorized
        here via RegistryTensors)."""
        return self._active_assignment.get(device_id)

    def release_device_assignment(self, token: str) -> DeviceAssignment:
        assignment = self.assignments.require_by_token(token)
        assignment.status = DeviceAssignmentStatus.RELEASED
        assignment.released_date = now_ms()
        assignment.touch()
        self.assignments.save(assignment)
        if self._active_assignment.get(assignment.device_id) is assignment:
            del self._active_assignment[assignment.device_id]
        self._notify("assignment", assignment)
        return assignment

    def reconcile_active_assignment(self, assignment: DeviceAssignment) -> None:
        """Re-derive the active-assignment index entry for one assignment
        after a replicated field update (the replication applier mutates
        status through the generic diff path, not the lifecycle methods)."""
        if assignment.status == DeviceAssignmentStatus.ACTIVE:
            self._active_assignment[assignment.device_id] = assignment
        elif self._active_assignment.get(assignment.device_id) is assignment:
            del self._active_assignment[assignment.device_id]

    def delete_device_assignment(self, token: str) -> DeviceAssignment:
        assignment = self.assignments.require_by_token(token)
        result = self.assignments.delete(assignment.id)
        if self._active_assignment.get(assignment.device_id) is assignment:
            del self._active_assignment[assignment.device_id]
        self._notify("assignment", result)
        return result

    def mark_assignment_missing(self, assignment_id: str) -> DeviceAssignment:
        assignment = self.assignments.require(assignment_id)
        assignment.status = DeviceAssignmentStatus.MISSING
        assignment.touch()
        self.assignments.save(assignment)
        self._notify("assignment", assignment)
        return assignment

    def list_assignments(self, criteria: Optional[SearchCriteria] = None,
                         device_token: Optional[str] = None,
                         customer_token: Optional[str] = None,
                         area_token: Optional[str] = None
                         ) -> SearchResults[DeviceAssignment]:
        device_id = (self.devices.require_by_token(device_token).id
                     if device_token else None)
        customer_id = (self.customers.require_by_token(customer_token).id
                       if customer_token else None)
        area_id = (self.areas.require_by_token(area_token).id
                   if area_token else None)

        def where(a: DeviceAssignment) -> bool:
            if device_id and a.device_id != device_id:
                return False
            if customer_id and a.customer_id != customer_id:
                return False
            if area_id and a.area_id != area_id:
                return False
            return True

        return self.assignments.list(criteria, where)

    # -- areas / zones / customers --------------------------------------------

    def create_area_type(self, area_type: AreaType) -> AreaType:
        return self.area_types.create(area_type)

    def create_area(self, area: Area) -> Area:
        result = self.areas.create(area)
        self._notify("area", result)
        return result

    def get_area_by_token(self, token: str) -> Area:
        return self.areas.require_by_token(token)

    def list_areas(self, criteria: Optional[SearchCriteria] = None
                   ) -> SearchResults[Area]:
        return self.areas.list(criteria)

    def create_zone(self, zone: Zone) -> Zone:
        result = self.zones.create(zone)
        self._notify("zone", result)
        return result

    def get_zone_by_token(self, token: str) -> Zone:
        return self.zones.require_by_token(token)

    def update_zone(self, token: str, updates: Dict) -> Zone:
        entity = self.zones.require_by_token(token)
        result = self.zones.update(entity.id, updates)
        self._notify("zone", result)
        return result

    def delete_zone(self, token: str) -> Zone:
        entity = self.zones.require_by_token(token)
        result = self.zones.delete(entity.id)
        self._notify("zone", result)
        return result

    def list_zones(self, area_token: Optional[str] = None,
                   criteria: Optional[SearchCriteria] = None
                   ) -> SearchResults[Zone]:
        area_id = self.areas.require_by_token(area_token).id if area_token else None
        return self.zones.list(
            criteria, (lambda z: z.area_id == area_id) if area_id else None)

    def create_customer_type(self, customer_type: CustomerType) -> CustomerType:
        return self.customer_types.create(customer_type)

    def create_customer(self, customer: Customer) -> Customer:
        return self.customers.create(customer)

    def get_customer_by_token(self, token: str) -> Customer:
        return self.customers.require_by_token(token)

    def list_customers(self, criteria: Optional[SearchCriteria] = None
                       ) -> SearchResults[Customer]:
        return self.customers.list(criteria)

    # -- device groups ---------------------------------------------------------

    def create_device_group(self, group: DeviceGroup) -> DeviceGroup:
        return self.device_groups.create(group)

    def get_device_group_by_token(self, token: str) -> DeviceGroup:
        return self.device_groups.require_by_token(token)

    def add_device_group_elements(self, group_token: str,
                                  elements: List[DeviceGroupElement]
                                  ) -> List[DeviceGroupElement]:
        group = self.device_groups.require_by_token(group_token)
        out = []
        for element in elements:
            element.group_id = group.id
            out.append(self.group_elements.create(element))
        return out

    def list_device_group_elements(self, group_token: str
                                   ) -> SearchResults[DeviceGroupElement]:
        group = self.device_groups.require_by_token(group_token)
        return self.group_elements.list(where=lambda e: e.group_id == group.id)

    def expand_group_devices(self, group_token: str) -> List[Device]:
        """Recursively resolve a group to its device list (used by batch ops)."""
        seen_groups: set = set()
        devices: Dict[str, Device] = {}

        def walk(token: str) -> None:
            group = self.device_groups.require_by_token(token)
            if group.id in seen_groups:
                return
            seen_groups.add(group.id)
            for element in self.group_elements.all():
                if element.group_id != group.id:
                    continue
                if element.device_id:
                    device = self.devices.get(element.device_id)
                    if device:
                        devices[device.id] = device
                elif element.nested_group_id:
                    nested = self.device_groups.get(element.nested_group_id)
                    if nested:
                        walk(nested.token)

        walk(group_token)
        return list(devices.values())

    # -- alarms ----------------------------------------------------------------

    def create_device_alarm(self, alarm: DeviceAlarm) -> DeviceAlarm:
        alarm.triggered_date = alarm.triggered_date or now_ms()
        return self.alarms.create(alarm)

    def list_device_alarms(self, device_token: Optional[str] = None,
                           criteria: Optional[SearchCriteria] = None
                           ) -> SearchResults[DeviceAlarm]:
        device_id = (self.devices.require_by_token(device_token).id
                     if device_token else None)
        return self.alarms.list(
            criteria, (lambda a: a.device_id == device_id) if device_id else None)

    def get_device_alarm(self, alarm_id: str) -> Optional[DeviceAlarm]:
        return self.alarms.get(alarm_id)

    def update_device_alarm(self, alarm_id: str,
                            updates: Dict) -> DeviceAlarm:
        """State transitions stamp their dates (the reference's
        DeviceAlarmMarshalHelper behavior for acknowledge/resolve)."""
        from sitewhere_tpu_torch.model.device import DeviceAlarmState

        updates = dict(updates)
        state = updates.get("state")
        if state is not None and not isinstance(state, DeviceAlarmState):
            updates["state"] = state = DeviceAlarmState(state)
        if state == DeviceAlarmState.ACKNOWLEDGED:
            updates.setdefault("acknowledged_date", now_ms())
        elif state == DeviceAlarmState.RESOLVED:
            updates.setdefault("resolved_date", now_ms())
        return self.alarms.update(alarm_id, updates)

    def delete_device_alarm(self, alarm_id: str) -> DeviceAlarm:
        return self.alarms.delete(alarm_id)
