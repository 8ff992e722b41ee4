"""Provisioning state in the instance checkpoint (tenants, users,
authorities and their tombstones), and the last-writer-wins core it
shares with cross-host replication.

`export_provisioning` / `apply_provisioning` carry the whole provisioning
state inside the instance checkpoint manifest, so a restart rebuilds the
same tenant set from durable state, not boot templates. The cross-host
`ProvisioningReplicator` (busnet broadcast of tenant/user mutations) comes
with the cluster modes (ROADMAP A4b); `replicator_of` finds none on a
single host, and the REST gateway reports mode "local".
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Dict, Optional, Tuple

from sitewhere_tpu_torch.errors import DuplicateTokenError
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.model.user import GrantedAuthority, User

LOGGER = logging.getLogger("sitewhere.provisioning")

# per-kind PER-HOST observation fields: excluded from LWW diffs and the
# content digest the same way created_date is (a host's own login
# bookkeeping must not churn replicated content)
_OBSERVED_FIELDS = {"user": ("last_login_date",)}

_MODEL_CLASSES = {"tenant": Tenant, "user": User}


# ---------------------------------------------------------------------------
# LWW + content-digest core (shared with parallel/cluster.py RegistryGossip)
# ---------------------------------------------------------------------------

def lww_stamp(data: Dict) -> int:
    """Last-writer-wins timestamp of a serialized entity."""
    return int(data.get("updated_date") or data.get("created_date") or 0)


def content_digest(data: Dict,
                   ref_tokens: Optional[Dict[str, str]] = None,
                   drop_fields: Tuple[str, ...] = ()) -> str:
    """Deterministic tiebreak for equal-stamp concurrent writes: a digest
    over the entity's HOST-INDEPENDENT content — per-host UUID ids and
    per-host observations (`created_date`, `drop_fields`) are dropped,
    replicated references appear by token, and `updated_date` normalizes
    to the LWW stamp — so every host hashing its local copy and the
    incoming copy computes the same pair of keys and picks the same
    winner."""
    content = {k: v for k, v in data.items()
               if k not in ("id", "created_date") and k not in drop_fields}
    content["updated_date"] = lww_stamp(data)
    content["_refs"] = dict(sorted((ref_tokens or {}).items()))
    blob = json.dumps(content, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def _digest(kind: str, data: Dict) -> str:
    return content_digest(data, drop_fields=_OBSERVED_FIELDS.get(kind, ()))


# ---------------------------------------------------------------------------
# checkpoint payload (gang-restart durability)
# ---------------------------------------------------------------------------

def export_provisioning(instance) -> Dict:
    """Whole-state provisioning snapshot for the instance checkpoint
    manifest: tenants + users + authorities, plus the replicator's known
    tombstones (a replayed stale create must stay dead after restart)."""
    from sitewhere_tpu_torch.web.marshal import to_jsonable

    replicator = replicator_of(instance)
    return {
        "tenants": [to_jsonable(t)
                    for t in instance.tenant_management.tenants.all()],
        "users": [to_jsonable(u)
                  for u in instance.user_management.users.all()],
        "authorities": [to_jsonable(a) for a in
                        instance.user_management.list_granted_authorities()],
        "tombstones": ([[k, t, s] for (k, t), s in
                        sorted(replicator._tombstones.items())]
                       if replicator is not None else []),
    }


def apply_provisioning(instance, state: Optional[Dict]) -> int:
    """Merge a checkpointed provisioning snapshot into the live
    managements, last-writer-wins (local durable stores may be newer).
    Runs at boot restore BEFORE the tenant engine manager starts, so the
    restored tenant set — not the boot templates — decides which engines
    boot. Returns the number of applied records."""
    if not state:
        return 0
    replicator = replicator_of(instance)
    tombstones: Dict[Tuple[str, str], int] = {}
    for kind, token, stamp in state.get("tombstones", []):
        tombstones[(str(kind), str(token))] = int(stamp)
        if replicator is not None:
            key = (str(kind), str(token))
            replicator._tombstones[key] = max(
                replicator._tombstones.get(key, 0), int(stamp))
    applied = 0
    for data in state.get("tenants", []):
        tomb = tombstones.get(("tenant", data.get("token", "")))
        if tomb is not None and lww_stamp(data) <= tomb:
            continue
        applied += _apply_entity(instance, "tenant", dict(data))
    for data in state.get("users", []):
        tomb = tombstones.get(("user", data.get("token", "")))
        if tomb is not None and lww_stamp(data) <= tomb:
            continue
        applied += _apply_entity(instance, "user", dict(data))
    users = instance.user_management
    for data in state.get("authorities", []):
        name = data.get("authority", "")
        if name and users.get_granted_authority(name) is None:
            users.create_granted_authority(
                GrantedAuthority(**{k: data[k] for k in
                                    ("authority", "description", "parent",
                                     "group") if k in data}))
            applied += 1
    return applied


def replicator_of(instance):
    replicator = getattr(instance, "provisioning_replicator", None)
    if replicator is not None:
        return replicator
    hooks = getattr(instance, "cluster_hooks", None)
    return getattr(hooks, "provisioning", None) if hooks is not None else None


def _apply_entity(instance, kind: str, entity_data: Dict) -> int:
    """Idempotent LWW create-or-update of one tenant/user record through
    the management surface (shared by the gossip applier and the
    checkpoint restore). Returns 1 when local state changed."""
    from sitewhere_tpu_torch.web.marshal import entity_from_payload, to_jsonable

    token = entity_data.get("token", "")
    if not token:
        return 0
    mgmt = (instance.tenant_management if kind == "tenant"
            else instance.user_management)
    coll = mgmt.tenants if kind == "tenant" else mgmt.users
    existing = coll.get_by_token(token)
    if existing is None:
        entity = entity_from_payload(_MODEL_CLASSES[kind], entity_data)
        try:
            with mgmt.replication():
                if kind == "tenant":
                    mgmt.create_tenant(entity)
                else:
                    coll.create(entity)
        except DuplicateTokenError:
            pass  # raced another replica of the same create
        return 1
    # LWW: stamps first, host-independent digest on exact ties
    import dataclasses as _dc

    current = to_jsonable(existing)
    inc_ts, loc_ts = lww_stamp(entity_data), lww_stamp(current)
    if inc_ts < loc_ts:
        return 0  # stale: the local copy already won
    if inc_ts == loc_ts and _digest(kind, entity_data) <= _digest(kind,
                                                                  current):
        return 0  # identical, or the local copy wins the tiebreak
    coerced = entity_from_payload(type(existing), entity_data)
    inc_json = to_jsonable(coerced)
    fields = ({f.name for f in _dc.fields(type(existing))}
              - {"id", "token", "created_date"}
              - set(_OBSERVED_FIELDS.get(kind, ())))
    diff = {name: getattr(coerced, name) for name in fields
            if current.get(name) != inc_json.get(name)}
    if not diff:
        return 0
    with mgmt.replication():
        if kind == "tenant":
            # fires the local tenant-model-updates record too -> the
            # engine manager restarts the live engine (reactive update)
            mgmt.update_tenant(token, diff)
        else:
            mgmt.update_user(token, diff)
    return 1
