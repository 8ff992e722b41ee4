"""Cluster-wide control-plane provisioning: tenant/user/authority
replication with reactive engine lifecycle.

Reference: the tenant-model-updates topic (KafkaTopicNaming.java:41) that
every MultitenantMicroservice watches to boot/stop tenant engines
reactively (MultitenantMicroservice.java:64-70,:238), plus the shared
user store every service authenticates against. Counterpart of
`sitewhere_tpu/multitenant/replication.py`, envelope for envelope: the
control-plane cluster (parallel/cluster.py ControlPlaneCluster) replicates
the registry via leaderless gossip and tenant/user provisioning through
this module, so a tenant created over REST on host A exists on B.

This module closes that gap with the same replication algebra the
registry gossip uses (and the gossip now imports ITS core from here —
one LWW + tombstone + content-digest implementation, two consumers):

- **Publish side** — `TenantManagement` / `UserManagement` mutations
  (complete collection-level feeds, so no wrapper can forget to
  replicate) are stamped (explicit `updated_date`, resurrection bumps
  past known tombstones, deletes stamp past the entity's last write)
  and broadcast to every peer's bus edge. A peer publish failure parks
  the payload on the local dead-letter topic for operator replay.
- **Apply side** — idempotent last-writer-wins: the stamp orders
  writers, a host-independent content digest breaks exact ties, and
  tombstones make deletes beat stale creates while a NEWER write
  resurrects. Applies run through the regular management surface under
  its `replication()` context, so the store mutation also publishes the
  LOCAL `tenant-model-updates` record — which is exactly what makes the
  applier *reactive*: the TenantEngineManager watching that topic boots
  the tenant engine (registering its registry with the cluster gossip)
  on a replicated `create`, restarts it on `update`, and retires it on
  `delete`. A tenant delete additionally parks the tenant's in-flight
  decoded-event rows on the dead-letter topic instead of dropping them,
  and user mutations invalidate the JWT auth-state cache
  (`security/tokens.py`) — a deleted user's tokens are rejected
  cluster-wide.
- **Durability** — `export_provisioning` / `apply_provisioning` carry
  the whole provisioning state (plus tombstones) inside the instance
  checkpoint manifest, so a gang restart rebuilds the same tenant set
  from durable state, not boot templates.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from typing import Dict, List, Optional, Tuple

import msgpack

from sitewhere_tpu_torch.errors import (
    DuplicateTokenError, NotFoundError, SiteWhereError)
from sitewhere_tpu_torch.model.common import now_ms
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.model.user import GrantedAuthority, User
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, Record, TopicNaming
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.runtime.recovery import EpochFence

LOGGER = logging.getLogger("sitewhere.provisioning")

PROVISIONING_SUFFIX = "provisioning-model-updates"

# per-kind PER-HOST observation fields: excluded from LWW diffs and the
# content digest the same way created_date is (a host's own login
# bookkeeping must not churn replicated content)
_OBSERVED_FIELDS = {"user": ("last_login_date",)}

_MODEL_CLASSES = {"tenant": Tenant, "user": User}


def provisioning_topic(naming: TopicNaming) -> str:
    return naming.provisioning_model_updates()


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


# ---------------------------------------------------------------------------
# the replicator
# ---------------------------------------------------------------------------

class ProvisioningReplicator:
    """Leaderless cross-host tenant/user/authority replication
    (module docstring). Construct with the instance BEFORE
    `instance.start()` so the bootstrap mutations replicate too; `start()`
    after the instance is up (the ConsumerHost applies peer records)."""

    def __init__(self, process_id: int, peers: Dict[int, object],
                 instance, naming: TopicNaming):
        self.process_id = process_id
        self.peers = peers
        self.instance = instance
        self.topic = provisioning_topic(naming)
        self.published = 0
        self.applied = 0
        self.conflicts = 0
        self.publish_errors = 0
        self.parked_rows = 0
        # recovery-epoch fencing (runtime/recovery.py): every envelope is
        # stamped with this host's origin identity + current epoch, and
        # the apply side keeps per-origin floors — a fenced (taken-over)
        # peer's stale envelopes are rejected instead of resurrecting
        # pre-takeover provisioning state. Epochs only compare within one
        # origin; envelopes without a stamp (older peers) always admit.
        self.origin = f"proc:{process_id}"
        self.epoch = 0
        self._fence = EpochFence()
        self._applying = threading.local()
        # (kind, token) -> delete stamp; seeded from the checkpoint at
        # boot restore (apply_provisioning) so replayed stale creates
        # stay dead across gang restarts
        self._tombstones: Dict[Tuple[str, str], int] = {}
        self._host = ConsumerHost(
            instance.bus, self.topic,
            group_id=f"provisioning-replication-{process_id}",
            handler=self._handle)
        instance.tenant_management.add_mutation_listener(
            lambda kind, op, entity: self._on_mutation("tenant", op, entity))
        instance.user_management.add_mutation_listener(self._on_user_mutation)
        # discoverable from the instance (checkpoint export, REST status)
        # even before/without cluster hooks installation
        instance.provisioning_replicator = self

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._host.start()

    def stop(self) -> None:
        self._host.stop()

    # -- publish side ------------------------------------------------------
    def _on_user_mutation(self, kind: str, op: str, entity) -> None:
        # kind is "user" (collection feed) or "authority" (explicit emit)
        self._on_mutation(kind, op, entity)

    def _on_mutation(self, kind: str, op: str, entity) -> None:
        if getattr(self._applying, "active", False):
            return  # echo of an applied peer mutation
        if not self.peers:
            return
        from sitewhere_tpu_torch.web.marshal import to_jsonable

        token = getattr(entity, "token", "") or getattr(
            entity, "authority", "")
        try:
            if op == "delete":
                data = to_jsonable(entity)
                stamp = max(now_ms(), lww_stamp(data) + 1)
                # the deleting host never consumes its own publish:
                # record the tombstone HERE too, or an in-flight
                # concurrent peer update would resurrect locally
                key = (kind, token)
                self._tombstones[key] = max(self._tombstones.get(key, 0),
                                            stamp)
                payload = self._envelope(
                    {"kind": kind, "op": "delete", "token": token,
                     "stamp": stamp})
                if kind == "tenant":
                    # the local host parks its own in-flight rows; each
                    # peer parks its own on apply
                    self._park_inflight(token)
            elif kind == "authority":
                payload = self._envelope(
                    {"kind": kind, "op": op, "entity": to_jsonable(entity),
                     "stamp": now_ms()})
            else:
                self._stamp_live_entity(kind, entity)
                payload = self._envelope(
                    {"kind": kind, "op": op,
                     "entity": to_jsonable(entity)})
        except Exception:
            LOGGER.exception("provisioning encode failed (%s %s)", kind, op)
            return
        self._publish(f"{kind}:{token}".encode(), payload)

    def _stamp_live_entity(self, kind: str, entity) -> None:
        """Make the LWW stamp explicit on the live entity (a create's
        stamp implicitly rides created_date, which deliberately does not
        converge), and bump a resurrection past any known tombstone so
        every replica compares the same winning pair."""
        from sitewhere_tpu_torch.web.marshal import to_jsonable

        if entity.updated_date is None:
            entity.updated_date = entity.created_date
        tomb = self._tombstones.get((kind, entity.token))
        if tomb is not None and lww_stamp(to_jsonable(entity)) <= tomb:
            entity.updated_date = tomb + 1
            coll = (self.instance.tenant_management.tenants
                    if kind == "tenant"
                    else self.instance.user_management.users)
            try:
                # the row was already saved before this listener fired:
                # persist the bumped stamp too (no re-emit)
                coll.persist_quietly(entity)
            except Exception:
                LOGGER.exception("could not persist resurrection stamp "
                                 "for %s %r", kind, entity.token)

    def _envelope(self, body: Dict) -> bytes:
        body["origin"] = self.origin
        body["epoch"] = int(self.epoch)
        return msgpack.packb(body, use_bin_type=True)

    def set_epoch(self, epoch: int) -> None:
        """Adopt the instance's minted recovery epoch (instance boot /
        takeover re-mint); outgoing envelopes carry it from here on."""
        self.epoch = int(epoch)

    def fence(self, origin: str, epoch: int) -> int:
        """Raise the apply-side floor for `origin` (takeover broadcast):
        envelopes it stamped below `epoch` are rejected from now on."""
        return self._fence.fence(str(origin), int(epoch))

    def _publish(self, key: bytes, payload: bytes) -> None:
        from sitewhere_tpu_torch.runtime.busnet import BusNetError

        for pid, client in self.peers.items():
            try:
                client.publish(self.topic, key, payload)
                self.published += 1
            except BusNetError:
                self.publish_errors += 1
                # park for operator replay toward the peer
                self.instance.bus.publish(f"{self.topic}.dead-letter",
                                          key, payload)

    # -- apply side --------------------------------------------------------
    def _handle(self, records: List[Record]) -> None:
        self._applying.active = True
        try:
            for record in records:
                try:
                    data = msgpack.unpackb(record.value, raw=False)
                except Exception:
                    continue
                try:
                    self._apply(dict(data))
                except SiteWhereError:
                    self.conflicts += 1
                    raise  # retry budget -> dead-letter surface
        finally:
            self._applying.active = False

    def _apply(self, data: Dict) -> None:
        origin = data.get("origin")
        if origin is not None and not self._fence.admit(
                str(origin), int(data.get("epoch", 0))):
            # stale-epoch envelope from a fenced (taken-over) writer:
            # admit() already counted it on `fencing.rejected`
            LOGGER.warning(
                "rejected stale provisioning envelope from %s "
                "(epoch %s < floor %d)", origin, data.get("epoch"),
                self._fence.floor(str(origin)))
            return
        kind = data.get("kind")
        if kind == "authority":
            self._apply_authority(data)
            return
        if kind not in _MODEL_CLASSES:
            return
        if data.get("op") == "delete":
            self._apply_delete(kind, data)
            return
        entity_data = dict(data.get("entity") or {})
        token = entity_data.get("token", "")
        tomb = self._tombstones.get((kind, token))
        if tomb is not None and lww_stamp(entity_data) <= tomb:
            return  # a write that lost to an applied deletion stays dead
        if _apply_entity(self.instance, kind, entity_data):
            self.applied += 1

    def _apply_delete(self, kind: str, data: Dict) -> None:
        from sitewhere_tpu_torch.web.marshal import to_jsonable

        token = data.get("token", "")
        stamp = int(data.get("stamp") or 0)
        key = (kind, token)
        self._tombstones[key] = max(self._tombstones.get(key, 0), stamp)
        mgmt = (self.instance.tenant_management if kind == "tenant"
                else self.instance.user_management)
        coll = mgmt.tenants if kind == "tenant" else mgmt.users
        existing = coll.get_by_token(token)
        if existing is None:
            return  # idempotent redelivery, or the entity never arrived
        if lww_stamp(to_jsonable(existing)) > stamp:
            return  # a concurrent write outranked the delete: keep it
        try:
            if kind == "tenant":
                # reactive: drain + retire the engine FIRST so its
                # consumers stop pulling, then delete (which also fires
                # the local tenant-model-updates delete record)
                self.instance.engine_manager.retire_engine(token)
                with mgmt.replication():
                    mgmt.delete_tenant(token)
                self._park_inflight(token)
            else:
                with mgmt.replication():
                    mgmt.delete_user(token)
        except NotFoundError:
            return
        self.applied += 1

    def _apply_authority(self, data: Dict) -> None:
        users = self.instance.user_management
        entity = dict(data.get("entity") or {})
        name = entity.get("authority", "")
        if not name or users.get_granted_authority(name) is not None:
            return
        users.create_granted_authority(GrantedAuthority(
            **{k: entity[k] for k in ("authority", "description", "parent",
                                      "group") if k in entity}))
        self.applied += 1

    # -- tenant-delete drain ----------------------------------------------
    def _park_inflight(self, tenant_token: str) -> None:
        """Rows already published for the deleted tenant but not yet
        consumed park on the dead-letter topic instead of silently dying
        with the topic (the engine is already stopped, so its consumer
        group is not competing for the cursor)."""
        bus = self.instance.bus
        naming = self.instance.naming
        topic = naming.event_source_decoded_events(tenant_token)
        consumer = bus.consumer(topic, f"inbound-processing-{tenant_token}")
        parked = 0
        while True:
            batch = consumer.poll(4096)
            if not batch:
                break
            bus.topic(f"{topic}.dead-letter").publish_many(
                [(r.key, r.value) for r in batch])
            bus.commit(consumer)
            parked += len(batch)
        if parked:
            self.parked_rows += parked
            GLOBAL_METRICS.counter("provisioning.parked_rows").inc(parked)
            LOGGER.warning("tenant %r deleted with %d in-flight rows — "
                           "parked on %s.dead-letter", tenant_token, parked,
                           topic)

    # -- status ------------------------------------------------------------
    def status(self) -> Dict:
        return {
            "mode": "replicated",
            "peers": len(self.peers),
            "published": self.published,
            "applied": self.applied,
            "conflicts": self.conflicts,
            "publishErrors": self.publish_errors,
            "parkedRows": self.parked_rows,
            "tombstones": len(self._tombstones),
            "origin": self.origin,
            "epoch": self.epoch,
            "fencedOrigins": self._fence.snapshot(),
        }
