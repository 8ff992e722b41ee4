"""The control-plane cluster: N single-card hosts whose control plane
converges over the networked bus edge.

Counterpart of the mesh-free half of `sitewhere_tpu/parallel/cluster.py`,
envelope for envelope (a JAX host and a port host gossip with each other).
Reference deployment story: N OS processes (one per microservice replica)
joined by a Kafka broker — boot in Microservice.java:182-236, cross-process
consumption in kafka/MicroserviceKafkaConsumer.java:115-121, 20 s state
heartbeats aggregated into an instance topology (Microservice.java:734-753,
TopologyStateAggregator.java).

- **Heartbeats + topology** — every process publishes periodic state to
  every peer's `microservice-state-updates` topic; an aggregator folds
  them into the instance topology with staleness.
- **Registry gossip** (`RegistryGossip`) — leaderless replication of every
  registry kind (device types/commands/statuses, devices, assignments,
  area types/areas/zones, customer types/customers, groups/elements,
  alarms), deletions (tombstones), fused-rule mutations, scripts,
  scripted rules, rule programs, anomaly models and actuation policies:
  broadcast to every peer's bus edge and applied idempotently with
  last-writer-wins ordering (update stamp, host-independent content-digest
  tiebreak). References travel by token; a multi-pass applier plus
  at-least-once redelivery absorbs cross-entity reordering.
- **Provisioning** — tenants, users and authorities replicate through
  `multitenant/replication.py` ProvisioningReplicator: a tenant created
  over REST on any host boots its engine (and registers its registry with
  this gossip) on every peer; deletes retire engines cluster-wide.
- **Leases + takeover** (`TakeoverMonitor`) — leases ride the heartbeats;
  a lapsed or failed peer is fenced and taken over by the deterministic
  successor.
- **Telemetry fan-in** — the busnet `telemetry` op and
  GET /api/cluster/telemetry merge every peer's metrics.

`ControlPlaneCluster` composes them around one instance. Each host runs
its OWN engine on its own card and owns every device it ingests; a killed
host restarts alone (its supervisor) and rebuilds from durable state while
the survivors keep serving. The multi-host SPMD cluster (lockstep step
loop, foreign-row forwarding, ClusterService) is the multi-host data
plane, ROADMAP A6d.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import msgpack

from sitewhere_tpu_torch.model.common import now_ms
# the LWW stamp + host-independent content digest are the shared
# replication core — ONE implementation (multitenant/replication.py)
# serves both the registry gossip and the provisioning replicator
from sitewhere_tpu_torch.multitenant.replication import (
    ProvisioningReplicator, content_digest as _content_digest,
    lww_stamp as _gossip_stamp)
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, Record, TopicNaming
from sitewhere_tpu_torch.runtime.busnet import BusClient, BusNetError
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.runtime.recovery import (
    EpochFence, LeaseTable, elect_successor)

LOGGER = logging.getLogger("sitewhere.cluster")


# ---------------------------------------------------------------------------
# heartbeats + topology
# ---------------------------------------------------------------------------

class ProcessStateReporter:
    """Publish this process's state to the local AND every peer's
    `microservice-state-updates` topic on a fixed cadence (the reference's
    20 s heartbeat, Microservice.java:734-753). Peer publish failures are
    counted, not fatal — staleness detection on the other side is the
    real liveness signal."""

    def __init__(self, process_id, bus, naming: TopicNaming,
                 peers: Dict[int, BusClient],
                 build_state: Callable[[], Dict],
                 interval_s: float = 2.0):
        self.process_id = process_id
        self.bus = bus
        self.topic = naming.microservice_state_updates()
        self.peers = peers
        self.build_state = build_state
        self.interval_s = interval_s
        self.publish_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="cluster-heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def beat_once(self) -> None:
        state = dict(self.build_state())
        state["process_id"] = self.process_id
        state["sent_at_ms"] = int(time.time() * 1000)
        payload = json.dumps(state).encode()
        key = str(self.process_id).encode()
        self.bus.publish(self.topic, key, payload)
        for pid, client in self.peers.items():
            try:
                client.publish(self.topic, key, payload)
            except BusNetError:
                self.publish_errors += 1

    def _run(self) -> None:
        while True:
            try:
                self.beat_once()
            except Exception:
                LOGGER.exception("heartbeat publish failed")
            if self._stop.wait(self.interval_s):
                return


class TopologyAggregator:
    """Fold state heartbeats from the local `microservice-state-updates`
    topic into a process map with liveness (TopologyStateAggregator.java's
    role). Remote processes appear/refresh via their forwarded heartbeats;
    staleness is computed against receive time so clock skew between
    hosts cannot fake liveness."""

    def __init__(self, bus, naming: TopicNaming,
                 stale_after_s: float = 10.0,
                 group_id: str = "topology-aggregator"):
        self.stale_after_s = stale_after_s
        self._states: Dict[str, Dict] = {}
        self._received_mono: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._host = ConsumerHost(
            bus, naming.microservice_state_updates(), group_id=group_id,
            handler=self._handle)

    def start(self) -> None:
        self._host.start()

    def stop(self) -> None:
        self._host.stop()

    def _handle(self, records: List[Record]) -> None:
        now = time.monotonic()
        with self._lock:
            for record in records:
                try:
                    state = json.loads(record.value)
                except Exception:
                    continue
                pid = str(state.get("process_id", record.key.decode()))
                self._states[pid] = state
                self._received_mono[pid] = now

    def snapshot(self) -> Dict[str, Dict]:
        now = time.monotonic()
        with self._lock:
            out = {}
            for pid, state in self._states.items():
                age = now - self._received_mono[pid]
                entry = dict(state)
                entry["age_s"] = round(age, 3)
                entry["stale"] = age > self.stale_after_s
                out[pid] = entry
            return out

    def stale_processes(self, expected: List[str],
                        grace_s: float = 0.0) -> List[str]:
        """Expected process ids that are stale or were never seen. A
        never-seen process counts only after `grace_s` of observation
        (tracked from aggregator start)."""
        snap = self.snapshot()
        if not hasattr(self, "_started_mono"):
            self._started_mono = time.monotonic()
        out = []
        for pid in expected:
            entry = snap.get(str(pid))
            if entry is None:
                if time.monotonic() - self._started_mono > grace_s:
                    out.append(str(pid))
            elif entry["stale"]:
                out.append(str(pid))
        return out


class PeerWatchdog:
    """Turn a stale peer into a deliberate, loud gang exit instead of a
    hung collective (gang-restart failure model — module docstring)."""

    def __init__(self, aggregator: TopologyAggregator,
                 expected: List[str], fail_after_s: float = 15.0,
                 check_interval_s: float = 1.0,
                 on_peer_loss: Optional[Callable[[List[str]], None]] = None):
        self.aggregator = aggregator
        self.expected = [str(p) for p in expected]
        self.fail_after_s = fail_after_s
        self.check_interval_s = check_interval_s
        self.on_peer_loss = on_peer_loss
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None or not self.expected:
            return
        self.aggregator._started_mono = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="cluster-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            stale = self.aggregator.stale_processes(
                self.expected, grace_s=self.fail_after_s)
            hard = [p for p in stale
                    if self._stale_age(p) > self.fail_after_s]
            if hard:
                LOGGER.critical(
                    "peer process(es) %s unresponsive > %.1fs — gang "
                    "restart required", hard, self.fail_after_s)
                if self.on_peer_loss is not None:
                    self.on_peer_loss(hard)
                return

    def _stale_age(self, pid: str) -> float:
        with self.aggregator._lock:
            seen = self.aggregator._received_mono.get(pid)
        if seen is None:
            started = getattr(self.aggregator, "_started_mono",
                              time.monotonic())
            return time.monotonic() - started
        return time.monotonic() - seen


# ---------------------------------------------------------------------------
# gossip registry replication
# ---------------------------------------------------------------------------

REGISTRY_GOSSIP_SUFFIX = "registry-model-updates"

# Every registry kind replicates. Reference fields are resolved by TOKEN
# on the wire (entity ids are per-host UUIDs except when the creating
# host's id is adopted at create time): (id_field, collection). Fields
# NOT listed here (asset_id, triggering_event_id) travel verbatim — they
# reference managers outside the replicated registry.
_GOSSIP_REFS = {
    "device_type": [],
    "device_command": [("device_type_id", "device_types")],
    "device_status": [("device_type_id", "device_types")],
    "device": [("device_type_id", "device_types"),
               ("parent_device_id", "devices")],
    "assignment": [("device_id", "devices"),
                   ("device_type_id", "device_types"),
                   ("area_id", "areas"), ("customer_id", "customers")],
    "area_type": [],
    "area": [("area_type_id", "area_types"), ("parent_area_id", "areas")],
    "zone": [("area_id", "areas")],
    "customer_type": [],
    "customer": [("customer_type_id", "customer_types"),
                 ("parent_customer_id", "customers")],
    "device_group": [],
    "group_element": [("group_id", "device_groups"),
                      ("device_id", "devices"),
                      ("nested_group_id", "device_groups")],
    "alarm": [("device_id", "devices"),
              ("device_assignment_id", "assignments"),
              ("customer_id", "customers"), ("area_id", "areas")],
}
_GOSSIP_CLASSES = {}  # kind -> model class, resolved lazily


def _gossip_class(kind: str):
    if not _GOSSIP_CLASSES:
        from sitewhere_tpu_torch.model import (
            Area, AreaType, Customer, CustomerType, Device, DeviceAlarm,
            DeviceAssignment, DeviceCommand, DeviceGroup, DeviceGroupElement,
            DeviceStatus, DeviceType, Zone)

        _GOSSIP_CLASSES.update({
            "device_type": DeviceType, "device_command": DeviceCommand,
            "device_status": DeviceStatus, "device": Device,
            "assignment": DeviceAssignment, "area_type": AreaType,
            "area": Area, "zone": Zone, "customer_type": CustomerType,
            "customer": Customer, "device_group": DeviceGroup,
            "group_element": DeviceGroupElement, "alarm": DeviceAlarm})
    return _GOSSIP_CLASSES.get(kind)


def _gossip_content_key(kind: str, data: Dict,
                        ref_tokens: Dict[str, str]) -> str:
    """Deterministic tiebreak for equal-stamp concurrent writes: the
    shared content digest with this kind's replicated-reference fields
    dropped (they appear by token in `_refs` instead — ids are per-host
    UUIDs). created_date is a per-host observation and updated_date
    normalizes to the LWW stamp, so an origin copy whose stamp rides
    created_date hashes identically to replicas carrying it explicitly."""
    ref_fields = tuple(field for field, _ in _GOSSIP_REFS.get(kind, ()))
    return _content_digest(data, ref_tokens=ref_tokens,
                           drop_fields=ref_fields)


def registry_gossip_topic(naming: TopicNaming) -> str:
    return naming._global(REGISTRY_GOSSIP_SUFFIX)


class RegistryGossip:
    """Leaderless cross-host registry replication.

    The reference gets cross-process registry consistency from a shared
    database; here every host broadcasts its registry mutations to its
    peers' bus edges and applies incoming ones idempotently. No
    sequencer is needed because shard OWNERSHIP no longer depends on
    creation order (shard-congruent interning, registry/interning.py) —
    hosts only need to converge on CONTENT, and the misroute guards
    cover the convergence window.

    Mechanics: EVERY registry kind replicates, including deletions.
    Entity references travel by TOKEN (ids are per-host UUIDs; a
    brand-new entity adopts the creating host's id, an existing one
    keeps its local id). An applier whose dependency has not arrived
    yet raises — the consumer's at-least-once redelivery retries until
    the dependency converges, and a genuine conflict parks on the
    dead-letter surface for the operator.

    Conflict order: last-writer-wins on the entity's updated/created
    stamp (local touch() is monotonic past any applied stamp), with a
    host-independent content digest breaking exact ties — every host
    compares the same pair of (stamp, digest) keys and picks the same
    winner, so concurrent updates converge identically everywhere.
    Deletes stamp past the entity's last write and leave a tombstone:
    a LATER write resurrects the entity (and the same comparison makes
    the delete a no-op on hosts that already applied that write), an
    EARLIER one stays dead. Same-token operations ride one partition in
    order; only cross-entity reordering needs the multi-pass applier.
    """

    def __init__(self, process_id: int, peers: Dict[int, BusClient],
                 instance, naming: TopicNaming):
        self.process_id = process_id
        self.peers = peers
        self.instance = instance
        self.topic = registry_gossip_topic(naming)
        self.published = 0
        self.applied = 0
        self.conflicts = 0
        self.publish_errors = 0
        # recovery-epoch fencing (runtime/recovery.py): outgoing gossip
        # carries this host's origin identity + epoch; the apply side
        # keeps per-origin floors so a fenced (taken-over) peer's stale
        # envelopes cannot resurrect pre-takeover registry state.
        # Unstamped envelopes (older peers) always admit.
        self.origin = f"proc:{process_id}"
        self.epoch = 0
        self._fence = EpochFence()
        self._applying = threading.local()
        self._registries: Dict[str, object] = {}
        # (tenant, kind, token) -> delete stamp; in-memory (a restarted
        # host re-learns deletions from the durable store, which the
        # delete already mutated)
        self._tombstones: Dict[tuple, int] = {}
        self._host = ConsumerHost(instance.bus, self.topic,
                                  group_id=f"registry-gossip-{process_id}",
                                  handler=self._handle)

    # -- publish side ------------------------------------------------------
    def register_tenant_registry(self, tenant_token: str, registry) -> None:
        """Called by TenantEngine construction: subscribe to this
        tenant's registry mutations (the complete collection-level feed —
        no wrapper can forget to replicate)."""
        self._registries[tenant_token] = registry
        registry.add_mutation_listener(
            lambda kind, op, entity, _t=tenant_token, _r=registry:
            self._on_mutation(_t, _r, kind, op, entity))

    def _on_mutation(self, tenant: str, registry, kind, op, entity) -> None:
        if getattr(self._applying, "active", False):
            return  # echo of an applied peer mutation
        if _gossip_class(kind) is None or not self.peers:
            return
        from sitewhere_tpu_torch.web.marshal import to_jsonable

        if op != "delete":
            # A write to a token this host knows a tombstone for is a
            # RESURRECTION: its stamp must outrank the delete, or the
            # same-millisecond case diverges — receiving hosts keep the
            # token dead (ties favor the delete) while this host keeps
            # its local copy alive. Stamp the live entity past the
            # tombstone so every replica compares the same winning pair.
            key = (tenant, kind, getattr(entity, "token", ""))
            tomb = self._tombstones.get(key)
            if tomb is not None and \
                    _gossip_stamp(to_jsonable(entity)) <= tomb:
                entity.updated_date = tomb + 1
                # the row was already saved before this listener fired:
                # persist the bumped stamp too, or a restart rehydrates
                # the weaker one and a redelivered delete (same stamp)
                # kills the entity on this host alone
                try:
                    registry.collection_of(kind).persist_quietly(entity)
                except Exception:
                    LOGGER.exception("could not persist resurrection "
                                     "stamp for %s %r", kind, key[2])
            # A create's LWW stamp implicitly rides created_date — which
            # deliberately does NOT converge (a host that content-merges
            # this create keeps its own creation stamp). Make the stamp
            # EXPLICIT on the live entity so the payload replicates it and
            # every copy — origin included — compares the same stamp:
            # without this, a host that adopted the winning create's
            # content keeps a LOWER stamp (its own created_date) and an
            # in-flight older create re-wins there alone (observed
            # divergence in the 3-host storm test).
            if entity.updated_date is None:
                entity.updated_date = entity.created_date
        try:
            if op == "delete":
                # the delete is a write AFTER the entity's last one: stamp
                # past it so LWW orders it against concurrent updates
                data = to_jsonable(entity)
                stamp = max(now_ms(), _gossip_stamp(data) + 1)
                token = getattr(entity, "token", "")
                # the deleting host never consumes its own publish: record
                # the tombstone HERE too, or an in-flight concurrent peer
                # update would resurrect the entity on this host only
                key = (tenant, kind, token)
                self._tombstones[key] = max(self._tombstones.get(key, 0),
                                            stamp)
                payload = {"tenant": tenant, "kind": kind, "op": "delete",
                           "token": token, "stamp": stamp}
            else:
                refs = {}
                for field, coll_name in _GOSSIP_REFS.get(kind, []):
                    ref_id = getattr(entity, field, None)
                    if ref_id:
                        ref = getattr(registry, coll_name).get(ref_id)
                        if ref is not None:
                            refs[field] = ref.token
                payload = {"tenant": tenant, "kind": kind, "op": op,
                           "entity": to_jsonable(entity), "refs": refs}
        except Exception:
            LOGGER.exception("registry gossip encode failed (%s)", kind)
            return
        self._publish(getattr(entity, "token", "").encode(), payload)

    def set_epoch(self, epoch: int) -> None:
        """Adopt the instance's minted recovery epoch; outgoing gossip
        carries it from here on."""
        self.epoch = int(epoch)

    def fence(self, origin: str, epoch: int) -> int:
        """Raise the apply-side floor for `origin` (takeover broadcast)."""
        return self._fence.fence(str(origin), int(epoch))

    def _publish(self, key: bytes, data: Dict) -> None:
        data["origin"] = self.origin
        data["epoch"] = int(self.epoch)
        payload = msgpack.packb(data, use_bin_type=True)
        for pid, client in self.peers.items():
            try:
                client.publish(self.topic, key, payload)
                self.published += 1
            except BusNetError:
                self.publish_errors += 1
                # park for operator replay toward the peer
                self.instance.bus.publish(f"{self.topic}.dead-letter",
                                          key, payload)

    # -- fused-rule replication --------------------------------------------
    def register_rules_engine(self, engine) -> None:
        """Replicate fused-rule mutations (pipeline/engine.py rule feed):
        a rule added or removed on any host applies on every host, so the
        42M ev/s rule engine has ONE cluster-wide rule set (the reference
        re-configures every microservice instance from shared tenant
        config; here the mutation itself travels)."""
        engine.add_rules_listener(self._on_rule_mutation)

    def _on_rule_mutation(self, op: str, kind: str, payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        from sitewhere_tpu_torch.pipeline.engine import rule_to_dict

        if op == "remove":
            token = str(payload)
            data = {"kind": "_rule", "op": "remove", "token": token}
        else:
            token = payload.token
            data = {"kind": "_rule", "op": "add",
                    "rule": rule_to_dict(kind, payload)}
        self._publish(token.encode(), data)

    def _apply_rule(self, data: Dict) -> None:
        engine = self.instance.pipeline_engine
        if engine is None:
            return
        if data.get("op") == "remove":
            if engine.remove_rule(data.get("token", "")):
                self.applied += 1
            return
        from sitewhere_tpu_torch.pipeline.engine import rule_from_dict

        kind, rule = rule_from_dict(dict(data.get("rule") or {}))
        # replace-on-add: idempotent under redelivery and under every
        # host applying the same boot config
        engine.upsert_rule(kind, rule)
        self.applied += 1

    # -- script + scripted-rule replication --------------------------------
    def register_scripts(self, instance) -> None:
        """Replicate the script store and scripted-rule installs
        (reference: ZK-backed ScriptSynchronizer.java:32 gives every node
        the same scripts; here the mutation itself travels). Script
        payloads are whole-state (metadata + every version's content) so
        the applier is idempotent and order-free; scripted-rule installs
        are (token -> script, stamp) with tombstoned removals. A rule
        install arriving before its script replays via the dependency-miss
        retry path, like any registry reference."""
        instance.script_manager.add_listener(self._on_script_mutation)
        instance.scripted_rules.add_listener(
            self._on_scripted_rule_mutation)
        rule_programs = getattr(instance, "rule_programs", None)
        if rule_programs is not None:
            # rule-program installs replicate the same way: LWW payloads
            # (the spec IS the identity) with tombstoned removals
            rule_programs.add_listener(self._on_rule_program_mutation)
        anomaly_models = getattr(instance, "anomaly_models", None)
        if anomaly_models is not None:
            # anomaly-model installs share the rule-program algebra
            anomaly_models.add_listener(self._on_anomaly_model_mutation)
        actuation_policies = getattr(instance, "actuation_policies", None)
        if actuation_policies is not None:
            # alert->command policies replicate the same way: a policy
            # installed on one peer fires on every peer's shard of the
            # fleet
            actuation_policies.add_listener(
                self._on_actuation_policy_mutation)

    def _on_script_mutation(self, op: str, scope: str, script_id: str,
                            payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        data = {"kind": "_script", "op": op, "scope": scope,
                "scriptId": script_id, "payload": payload}
        self._publish(f"script:{scope}:{script_id}".encode(), data)

    def _on_scripted_rule_mutation(self, op: str, tenant: str, token: str,
                                   payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        data = {"kind": "_scripted_rule", "op": op, "tenant": tenant,
                "token": token, "payload": payload}
        self._publish(token.encode(), data)

    def _apply_script(self, data: Dict) -> None:
        scripts = self.instance.script_manager
        if data.get("op") == "delete":
            if scripts.apply_delete(data.get("scope", ""),
                                    data.get("scriptId", ""),
                                    int(data.get("payload") or 0)):
                self.applied += 1
            return
        if scripts.apply_replicated(dict(data.get("payload") or {})):
            self.applied += 1

    def _apply_scripted_rule(self, data: Dict) -> None:
        if self.instance.apply_replicated_scripted_rule(
                data.get("op", ""), data.get("tenant", ""),
                data.get("token", ""), data.get("payload")):
            self.applied += 1

    def _on_rule_program_mutation(self, op: str, tenant: str, token: str,
                                  payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        data = {"kind": "_rule_program", "op": op, "tenant": tenant,
                "token": token, "payload": payload}
        self._publish(token.encode(), data)

    def _apply_rule_program(self, data: Dict) -> None:
        # an invalid spec raises the structured RuleProgramError (409,
        # names the offending node) out of apply_replicated_rule_program
        # BEFORE any local mutation — _handle treats it as a
        # non-retryable conflict toward the retry budget / dead letter,
        # never a stack-trace crash of the applier
        if self.instance.apply_replicated_rule_program(
                data.get("op", ""), data.get("tenant", ""),
                data.get("token", ""), data.get("payload")):
            self.applied += 1

    def _on_anomaly_model_mutation(self, op: str, tenant: str, token: str,
                                   payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        data = {"kind": "_model", "op": op, "tenant": tenant,
                "token": token, "payload": payload}
        self._publish(token.encode(), data)

    def _apply_anomaly_model(self, data: Dict) -> None:
        # invalid specs raise the structured AnomalyModelError (409,
        # names the offending field) BEFORE any local mutation — a
        # non-retryable conflict, same contract as _apply_rule_program
        if self.instance.apply_replicated_anomaly_model(
                data.get("op", ""), data.get("tenant", ""),
                data.get("token", ""), data.get("payload")):
            self.applied += 1

    def _on_actuation_policy_mutation(self, op: str, tenant: str,
                                      token: str, payload) -> None:
        if getattr(self._applying, "active", False) or not self.peers:
            return
        data = {"kind": "_actuation_policy", "op": op, "tenant": tenant,
                "token": token, "payload": payload}
        self._publish(token.encode(), data)

    def _apply_actuation_policy(self, data: Dict) -> None:
        # invalid specs raise the structured ActuationPolicyError (409,
        # names the offending field) BEFORE any local mutation — a
        # non-retryable conflict, same contract as _apply_anomaly_model
        if self.instance.apply_replicated_actuation_policy(
                data.get("op", ""), data.get("tenant", ""),
                data.get("token", ""), data.get("payload")):
            self.applied += 1

    # -- apply side --------------------------------------------------------
    def start(self) -> None:
        self._host.start()

    def stop(self) -> None:
        self._host.stop()

    def _handle(self, records: List[Record]) -> None:
        # The topic is partitioned by entity token, so a poll can hand us a
        # dependent entity BEFORE its dependency (a device ahead of its
        # device type). Multi-pass over the DEPENDENCY misses until a full
        # pass makes no progress: any topological order inside the batch
        # resolves without relying on redelivery (which would replay the
        # batch in the same order and fail deterministically). A dependency
        # in a LATER batch still resolves via the consumer's at-least-once
        # retry. Non-dependency failures (genuine conflicts) never succeed
        # on a later pass, so they are applied once and re-raised at the
        # end — toward the retry budget and the dead-letter surface.
        pending = [msgpack.unpackb(r.value, raw=False) for r in records]
        conflict: Optional[BaseException] = None
        self._applying.active = True
        try:
            while pending:
                missing: List[Dict] = []
                dep_error: Optional[BaseException] = None
                for data in pending:
                    try:
                        self._apply(data)
                    except Exception as exc:
                        if self._retryable(exc):
                            missing.append(data)
                            if dep_error is None:
                                dep_error = exc
                        elif conflict is None:
                            conflict = exc
                if len(missing) == len(pending):
                    raise dep_error  # no progress: retry budget applies
                pending = missing
            if conflict is not None:
                raise conflict
        finally:
            self._applying.active = False

    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        """Failures that a LATER record in the same batch can clear:
        missing dependencies, plus referential-ordering refusals (a type
        delete ahead of its devices' deletes, an assignment create ahead
        of the prior assignment's release — cross-entity records ride
        different partitions, so order is not guaranteed)."""
        from sitewhere_tpu_torch.errors import (
            ErrorCode, NotFoundError, SiteWhereError)

        if isinstance(exc, NotFoundError):
            return True
        return isinstance(exc, SiteWhereError) and exc.code in (
            ErrorCode.DEVICE_TYPE_IN_USE, ErrorCode.DEVICE_ALREADY_ASSIGNED)

    def _apply(self, data: Dict) -> None:
        from sitewhere_tpu_torch.errors import (
            DuplicateTokenError, ErrorCode, NotFoundError, SiteWhereError)
        from sitewhere_tpu_torch.web.marshal import entity_from_payload

        origin = data.get("origin")
        if origin is not None and not self._fence.admit(
                str(origin), int(data.get("epoch", 0))):
            # stale-epoch gossip from a fenced (taken-over) writer:
            # admit() already counted it on `fencing.rejected`
            LOGGER.warning(
                "rejected stale registry gossip from %s (epoch %s < "
                "floor %d)", origin, data.get("epoch"),
                self._fence.floor(str(origin)))
            return
        kind = data.get("kind")
        if kind == "_rule":
            self._apply_rule(data)
            return
        if kind == "_script":
            self._apply_script(data)
            return
        if kind == "_scripted_rule":
            self._apply_scripted_rule(data)
            return
        if kind == "_rule_program":
            self._apply_rule_program(data)
            return
        if kind == "_model":
            self._apply_anomaly_model(data)
            return
        if kind == "_actuation_policy":
            self._apply_actuation_policy(data)
            return
        cls = _gossip_class(kind)
        if cls is None:
            return
        engine = self.instance.get_tenant_engine(data.get("tenant", ""))
        if engine is None:
            raise NotFoundError(
                f"gossip for unknown tenant {data.get('tenant')!r}",
                ErrorCode.INVALID_TENANT_TOKEN)
        registry = engine.registry
        tenant = data.get("tenant", "")
        if data.get("op") == "delete":
            self._apply_delete(registry, tenant, kind, data)
            return
        entity_data = dict(data.get("entity") or {})
        token = entity_data.get("token", "")
        # a write that lost to an applied deletion stays dead; a NEWER
        # write resurrects the entity (the winning side of the LWW pair —
        # hosts that saw the write first make the delete a no-op instead)
        tomb = self._tombstones.get((tenant, kind, token))
        if tomb is not None and _gossip_stamp(entity_data) <= tomb:
            return
        # remap reference ids through tokens; a missing dependency raises
        # -> the batch redelivers until the dependency gossip arrives
        ref_tokens = dict(data.get("refs") or {})
        for field, coll_name in _GOSSIP_REFS.get(kind, []):
            ref_token = ref_tokens.get(field)
            if ref_token:
                local = getattr(registry, coll_name).get_by_token(ref_token)
                if local is None:
                    raise NotFoundError(
                        f"gossip dependency {coll_name}:{ref_token!r} not "
                        f"yet replicated", ErrorCode.GENERIC)
                entity_data[field] = local.id
        with registry.replication():
            # replication context: creates are idempotent get-or-create,
            # and stay claimable by a later identical local create
            # (registry/store.py _Collection) — the contract that lets
            # every host provision the same world in any order
            existing = registry.collection_of(kind).get_by_token(token)
            if existing is None:
                entity = entity_from_payload(cls, entity_data)
                try:
                    registry.create_by_kind(kind, entity)
                    self.applied += 1
                except DuplicateTokenError:
                    pass  # raced another replica of the same create
                except SiteWhereError:
                    # genuine conflict (e.g. device already actively
                    # assigned): re-raise -> retry budget -> dead-letter
                    self.conflicts += 1
                    raise
            else:
                self._update_existing(registry, kind, token, existing,
                                      entity_data, ref_tokens)

    def _apply_delete(self, registry, tenant: str, kind: str,
                      data: Dict) -> None:
        from sitewhere_tpu_torch.web.marshal import to_jsonable

        token = data.get("token", "")
        stamp = int(data.get("stamp") or 0)
        key = (tenant, kind, token)
        self._tombstones[key] = max(self._tombstones.get(key, 0), stamp)
        existing = registry.collection_of(kind).get_by_token(token)
        if existing is None:
            return  # idempotent redelivery, or the entity never arrived
        if _gossip_stamp(to_jsonable(existing)) > stamp:
            return  # a concurrent write outranked the delete: keep it
        with registry.replication():
            registry.delete_by_kind(kind, token)
        self.applied += 1

    def _local_ref_tokens(self, registry, kind: str, entity) -> Dict[str, str]:
        """The entity's replicated references by token — the local half of
        the host-independent content digest."""
        out: Dict[str, str] = {}
        for field, coll_name in _GOSSIP_REFS.get(kind, []):
            ref_id = getattr(entity, field, None)
            if ref_id:
                ref = getattr(registry, coll_name).get(ref_id)
                if ref is not None:
                    out[field] = ref.token
        return out

    def _update_existing(self, registry, kind: str, token: str, existing,
                         entity_data: Dict, ref_tokens: Dict) -> None:
        import dataclasses as _dc

        from sitewhere_tpu_torch.web.marshal import entity_from_payload, to_jsonable

        # created_date is a PER-HOST observation and deliberately does
        # not converge: it is excluded from the LWW diff (a later write
        # must not move it), so entities created concurrently on two
        # hosts keep each host's own creation stamp (differing by the
        # race window). Any mutation of it here would also mutate the
        # live LWW stamp of a never-updated entity (stamp == created
        # then), which two independent review passes showed lets
        # at-least-once redeliveries flip strict verdicts into digest
        # ties and diverge CONTENT — the actual contract. Content
        # convergence is what the storm test pins; creation stamps are
        # like per-replica writetimes.
        current = to_jsonable(existing)
        # last-writer-wins: stamps first, host-independent digest on exact
        # ties — every host compares the same (stamp, digest) pair, so
        # concurrent updates converge to the same winner everywhere. The
        # digests (json + sha1 over the full entity) are only computed on
        # a tie, the rare case.
        inc_ts, loc_ts = _gossip_stamp(entity_data), _gossip_stamp(current)
        if inc_ts < loc_ts:
            return  # stale: the local copy already won
        if inc_ts == loc_ts:
            inc_key = _gossip_content_key(kind, entity_data, ref_tokens)
            loc_key = _gossip_content_key(
                kind, current,
                self._local_ref_tokens(registry, kind, existing))
            if inc_key <= loc_key:
                return  # identical, or the local copy wins the tiebreak
        # coerce through the marshal layer so enum/location fields apply
        # with model types, not raw wire values
        coerced = entity_from_payload(type(existing), entity_data)
        inc_json = to_jsonable(coerced)
        # the writer's updated_date is part of the diff: adopting the
        # winning stamp is what keeps later comparisons consistent
        fields = {f.name for f in _dc.fields(type(existing))} \
            - {"id", "token", "created_date"}
        diff = {name: getattr(coerced, name) for name in fields
                if current.get(name) != inc_json.get(name)}
        if not diff:
            return
        try:
            with registry.replication():
                result = registry.update_by_kind(kind, token, diff)
                if kind == "assignment":
                    # status may have moved through the generic diff path:
                    # re-derive the active-assignment index entry
                    registry.reconcile_active_assignment(result)
            self.applied += 1
        except Exception:
            self.conflicts += 1
            LOGGER.exception("gossip update of %s %r failed", kind, token)


# ---------------------------------------------------------------------------
# leased ownership + automated takeover
# ---------------------------------------------------------------------------

class TakeoverMonitor:
    """Leased ownership + automated takeover (runtime/recovery.py).

    Every host leases its own shard group and renews it through the
    existing heartbeat edges — each ProcessStateReporter state carries
    `{"leases": {resource: epoch}}`, so the lease protocol adds no new
    transport. Every host mirrors the leases it hears into a local
    LeaseTable (a stale heartbeat does NOT refresh, so the mirrored TTL
    lapses exactly when the heartbeats stop).

    When a peer's lease lapses — or its heartbeat reports a `failed`
    health ladder — every surviving host computes the same deterministic
    successor (lowest healthy rank, elect_successor); ONLY the successor
    acts. It fences the failed owner's epoch (local appliers via
    `fence_hooks`, cluster-wide via the busnet `fence` broadcast — from
    then on the zombie's stale-epoch writes are rejected and counted),
    steals the lease at the fenced epoch, runs `on_takeover` (checkpoint
    restore + retained-log replay on the wired instance), and counts
    `takeover.count`. No operator in the loop.

    When the fenced owner comes back (a restart mints epoch = floor, so
    its traffic re-admits automatically), the successor releases the
    stolen lease and the owner's own renewal takes over again.

    `check_once()` is the whole state machine; the background thread
    just calls it on a cadence. Deterministic tests drive it directly
    with an injectable clock and peer-state snapshots."""

    def __init__(self, process_id: int,
                 peer_states: Callable[[], Dict[str, Dict]],
                 epoch_of: Callable[[], int],
                 on_takeover: Optional[Callable[[str, Dict], None]] = None,
                 fence_hooks: Optional[List[Callable[[str, int], None]]]
                 = None,
                 fence_broadcast: Optional[Callable[[str, int], None]]
                 = None,
                 leases: Optional[LeaseTable] = None,
                 ttl_s: float = 6.0, check_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.process_id = int(process_id)
        self.owner = f"proc:{process_id}"
        self.resource = f"shard-group:{process_id}"
        self.peer_states = peer_states
        self.epoch_of = epoch_of
        self.on_takeover = on_takeover
        self.fence_hooks = list(fence_hooks or [])
        self.fence_broadcast = fence_broadcast
        self.ttl_s = float(ttl_s)
        self.check_interval_s = float(check_interval_s)
        self._clock = clock
        self.leases = leases if leases is not None else LeaseTable(
            clock=clock)
        self.taken: set = set()  # resources this host took over and holds
        self.events: deque = deque(maxlen=32)
        self._takeovers = GLOBAL_METRICS.counter("takeover.count")
        self._local_takeovers = 0  # this monitor's share of the counter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="takeover-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.check_once()
            except Exception:
                LOGGER.exception("takeover check failed")

    # -- heartbeat ride-along ---------------------------------------------
    def lease_advertisement(self) -> Dict[str, int]:
        """The `leases` block this host's heartbeat carries: its own
        shard group plus anything it took over, at its current epoch."""
        epoch = int(self.epoch_of())
        out = {self.resource: epoch}
        for resource in list(self.taken):
            out[resource] = epoch
        return out

    # -- the state machine -------------------------------------------------
    def check_once(self) -> List[Dict]:
        """One tick: renew own lease, mirror peers' leases, detect lapses
        and failed-health owners, take over as the deterministic
        successor. Returns the takeover events performed this tick."""
        now = self._clock()
        epoch = int(self.epoch_of())
        if not self.leases.renew(self.resource, self.owner, epoch,
                                 now=now):
            self.leases.acquire(self.resource, self.owner, epoch,
                                self.ttl_s, now=now)
        states = dict(self.peer_states() or {})
        healthy: Dict[int, bool] = {self.process_id: True}
        owner_failed: Dict[str, bool] = {}
        for pid, state in states.items():
            try:
                rank = int(state.get("process_id", pid))
            except (TypeError, ValueError):
                continue
            if rank == self.process_id:
                continue
            stale = bool(state.get("stale"))
            failed = state.get("health") == "failed"
            healthy[rank] = not stale and not failed
            owner_failed[f"proc:{rank}"] = failed
            if stale or failed:
                # a stale heartbeat must not refresh leases, and a host
                # reporting `failed` gets no mirror/handback either — a
                # zombie advertising its old lease would otherwise flap
                # ownership back and forth every tick
                continue
            advertised = state.get("leases") or {}
            for resource, lease_epoch in advertised.items():
                owner = f"proc:{rank}"
                if resource in self.taken:
                    # the fenced owner is back and advertising again:
                    # hand the lease back (its restart minted an epoch
                    # at the fenced floor, so its writes already
                    # re-admit) and let its renewal take over
                    self.leases.release(resource, self.owner)
                    self.taken.discard(resource)
                    self.events.append({
                        "resource": resource, "op": "handback",
                        "to": owner, "at_ms": int(time.time() * 1000)})
                    LOGGER.info("lease %s handed back to %s", resource,
                                owner)
                if not self.leases.renew(resource, owner,
                                         int(lease_epoch), now=now):
                    self.leases.acquire(resource, owner, int(lease_epoch),
                                        self.ttl_s, now=now)
        performed: List[Dict] = []
        for resource, info in self.leases.snapshot(now=now).items():
            owner = info["owner"]
            if owner == self.owner:
                continue
            lapsed = info["expired"] or owner_failed.get(owner, False)
            if not lapsed:
                continue
            try:
                owner_rank = int(owner.rpartition(":")[2])
            except ValueError:
                owner_rank = None
            successor = elect_successor(healthy, exclude=owner_rank)
            if successor != self.process_id:
                continue
            performed.append(
                self._take_over(resource, owner, int(info["epoch"]),
                                now=now))
        return performed

    def _take_over(self, resource: str, owner: str, last_epoch: int,
                   now: float) -> Dict:
        fence_epoch = last_epoch + 1
        for hook in self.fence_hooks:
            try:
                hook(owner, fence_epoch)
            except Exception:
                LOGGER.exception("fence hook failed for %s", owner)
        if self.fence_broadcast is not None:
            try:
                self.fence_broadcast(owner, fence_epoch)
            except Exception:
                LOGGER.exception("fence broadcast failed for %s", owner)
        # the steal and the fence are one decision: the lease is taken
        # at the FENCED epoch, so even a still-live lease record yields
        # (LeaseTable.acquire's strictly-higher-epoch rule)
        self.leases.acquire(resource, self.owner, fence_epoch, self.ttl_s,
                            now=now)
        self.taken.add(resource)
        self._takeovers.inc()
        self._local_takeovers += 1
        event = {"resource": resource, "op": "takeover", "from": owner,
                 "to": self.owner, "fenced_epoch": fence_epoch,
                 "at_ms": int(time.time() * 1000)}
        self.events.append(event)
        LOGGER.warning("took over %s from %s (fenced at epoch %d)",
                       resource, owner, fence_epoch)
        if self.on_takeover is not None:
            try:
                self.on_takeover(resource, event)
            except Exception:
                LOGGER.exception("takeover callback failed for %s",
                                 resource)
        return event

    def snapshot(self) -> Dict:
        return {
            "leases": self.leases.snapshot(),
            "taken_over": sorted(self.taken),
            "takeovers": self._local_takeovers,
            "takeover_events": list(self.events),
        }


def _annotate_recovery_state(cluster, state: Dict) -> None:
    """Failover fields every heartbeat carries (runtime/recovery.py):
    the host's recovery epoch + fence-key origin, its lease
    advertisement (peers mirror these into their lease tables), and the
    engine health-ladder state (a `failed` report triggers takeover
    without waiting for the heartbeat TTL to lapse)."""
    epoch = int(getattr(cluster.instance, "recovery_epoch", 0))
    state["epoch"] = epoch
    state["origin"] = f"proc:{cluster.process_id}"
    monitor = getattr(cluster, "takeover_monitor", None)
    if monitor is not None:
        state["leases"] = monitor.lease_advertisement()
    else:
        state["leases"] = {f"shard-group:{cluster.process_id}": epoch}
    health = getattr(cluster.instance.pipeline_engine, "health", None)
    if health is not None:
        state["health"] = health.state


# ---------------------------------------------------------------------------
# cluster telemetry fan-in (busnet `telemetry` op + /api/cluster/telemetry)
# ---------------------------------------------------------------------------

def _telemetry_snapshot(instance, process_id: int) -> Dict:
    """One process's telemetry payload: metrics report + full Prometheus
    exposition (instance.extra_gauges families included), the flight
    recorder's window rollups, and the event-age waterfall when the
    window saw stamped batches. This is what the busnet `telemetry` op
    serves to peers — all host-side reads, no device sync, so a peer's
    scrape never perturbs this host's step loop."""
    from sitewhere_tpu_torch.runtime.flight import GLOBAL_FLIGHT

    rollups = GLOBAL_FLIGHT.export(last_n=64).get("rollups", {})
    out = {
        "process_id": int(process_id),
        "instance_id": instance.instance_id,
        "status": instance.status.name,
        "metrics": instance.metrics.report(),
        "prometheus_text": instance.prometheus_text(),
        "flight_rollups": rollups,
    }
    age = rollups.get("event_age")
    if age:
        out["event_age"] = age
    return out


def _inject_peer_label(line: str, pid: str) -> str:
    """`name{edge="x"} 1` -> `name{edge="x",peer="<pid>"} 1` (and bare
    `name 1` grows a label block). Label VALUES in this codebase are
    tokens (engine names, table names, edges) — never contain spaces —
    so splitting on the first space is safe."""
    name_part, _, rest = line.partition(" ")
    if not rest:
        return line
    if name_part.endswith("}") and "{" in name_part:
        base, _, labels = name_part.partition("{")
        labels = labels[:-1]
        name_part = (f'{base}{{{labels},peer="{pid}"}}' if labels
                     else f'{base}{{peer="{pid}"}}')
    else:
        name_part = f'{name_part}{{peer="{pid}"}}'
    return f"{name_part} {rest}"


def _cluster_telemetry(cluster) -> Dict:
    """Fan out over busnet and merge: local snapshot + every reachable
    peer's, keyed by process id, plus one merged Prometheus exposition
    with a peer="<pid>" label injected into every sample (header lines
    deduplicated across peers). Unreachable peers land in `stale_peers`
    instead of failing the whole view — during an incident a partial
    waterfall is exactly what the operator needs."""
    processes: Dict[str, Dict] = {
        str(cluster.process_id): _telemetry_snapshot(cluster.instance,
                                                     cluster.process_id)}
    stale: List[str] = []
    for pid, client in sorted(cluster.peers.items()):
        try:
            processes[str(pid)] = client.telemetry()
        except (BusNetError, OSError) as exc:
            LOGGER.warning("telemetry fan-in: peer %d unreachable (%s)",
                           pid, exc)
            stale.append(str(pid))
    merged: List[str] = []
    seen_headers = set()
    for pid in sorted(processes, key=int):
        for line in (processes[pid].get("prometheus_text") or
                     "").splitlines():
            if line.startswith("#"):
                if line not in seen_headers:
                    seen_headers.add(line)
                    merged.append(line)
            elif line:
                merged.append(_inject_peer_label(line, pid))
    return {
        "process_id": cluster.process_id,
        "num_processes": cluster.num_processes,
        "processes": processes,
        "stale_peers": stale,
        "prometheus_text": "\n".join(merged) + ("\n" if merged else ""),
    }


# ---------------------------------------------------------------------------
# control-plane-only cluster (no SPMD mesh)
# ---------------------------------------------------------------------------

class ControlPlaneCluster:
    """N INDEPENDENT single-host instances joined by busnet edges: the
    control plane — registry gossip, tenant/user/authority provisioning
    with reactive engine lifecycle, script + scripted-rule replication,
    heartbeats/topology — converges cluster-wide while each host runs its
    OWN pipeline engine and owns every device it ingests locally.

    This is the deployable shape for environments without
    multi-controller collectives (and the composition the provisioning
    drill runs at N=3): no collective gang, no lockstep loop, no
    foreign-row forwarding — `data_plane = False` tells TenantEngine to
    keep the direct single-host submit path. A killed host restarts alone
    (its supervisor) and rebuilds from its durable state; survivors keep
    serving — there are no collectives to hang.

    Install on a SiteWhereInstance BEFORE `instance.start()` (the
    constructor sets `instance.cluster_hooks`, which tenant engines read
    to register their registries with the gossip), then `start()`.
    """

    data_plane = False

    def __init__(self, instance, process_id: int, num_processes: int,
                 peer_bus_addrs: Optional[Dict[int, tuple]] = None,
                 bus_host: str = "127.0.0.1", bus_port: int = 0,
                 heartbeat_s: float = 1.0, stale_after_s: float = 5.0):
        from sitewhere_tpu_torch.runtime.busnet import BusServer

        self.instance = instance
        self.process_id = process_id
        self.num_processes = num_processes
        self.degraded: List[str] = []
        naming = instance.naming
        self.bus_server = BusServer(instance.bus, host=bus_host,
                                    port=bus_port)
        # peer telemetry for GET /api/cluster/telemetry (same fan-in as
        # the SPMD cluster — the control plane has a bus edge too)
        self.bus_server.telemetry_provider = (
            lambda: _telemetry_snapshot(instance, process_id))
        self.peers: Dict[int, BusClient] = {}
        for pid, addr in (peer_bus_addrs or {}).items():
            if int(pid) != process_id:
                self.peers[int(pid)] = BusClient(addr[0], int(addr[1]))
        self.gossip = RegistryGossip(process_id, self.peers, instance,
                                     naming)
        self.gossip.register_scripts(instance)
        if instance.pipeline_engine is not None:
            self.gossip.register_rules_engine(instance.pipeline_engine)
        self.provisioning = ProvisioningReplicator(
            process_id, self.peers, instance, naming)
        self.reporter = ProcessStateReporter(
            process_id, instance.bus, naming, self.peers,
            build_state=self._build_state, interval_s=heartbeat_s)
        self.aggregator = TopologyAggregator(
            instance.bus, naming, stale_after_s=stale_after_s)
        # epoch-fenced failover (runtime/recovery.py): stamp this host's
        # recovery epoch into every gossip/provisioning envelope and
        # busnet RPC, and run the lease/takeover state machine over the
        # heartbeat topology. The lease TTL tracks the staleness window
        # so a lapse and a stale heartbeat mean the same thing.
        epoch = int(getattr(instance, "recovery_epoch", 0))
        self.gossip.set_epoch(epoch)
        self.provisioning.set_epoch(epoch)
        for client in self.peers.values():
            client.set_epoch(f"proc:{process_id}", epoch)
        self.takeover_monitor = TakeoverMonitor(
            process_id,
            peer_states=self.aggregator.snapshot,
            epoch_of=lambda: int(getattr(self.instance,
                                         "recovery_epoch", 0)),
            on_takeover=self._perform_takeover,
            fence_hooks=[self.gossip.fence, self.provisioning.fence],
            fence_broadcast=self._broadcast_fence,
            ttl_s=stale_after_s, check_interval_s=heartbeat_s)
        instance.cluster_hooks = self

    def _build_state(self) -> Dict:
        state = {
            "instance_id": self.instance.instance_id,
            "status": self.instance.status.name,
            "mode": "control-plane",
            "gossip_published": self.gossip.published,
            "gossip_applied": self.gossip.applied,
            "provisioning_published": self.provisioning.published,
            "provisioning_applied": self.provisioning.applied,
        }
        _annotate_recovery_state(self, state)
        return state

    def _broadcast_fence(self, origin: str, epoch: int) -> None:
        """Raise the fence floor for `origin` on every reachable peer —
        the cluster-wide half of a takeover (local appliers are fenced
        via fence_hooks). Unreachable peers are skipped: they learn the
        floor from admitted successor traffic (EpochFence.observe)."""
        for pid, client in self.peers.items():
            try:
                client.fence(origin, epoch)
            except BusNetError:
                LOGGER.warning("fence broadcast to process %d failed "
                               "(will learn floor from traffic)", pid)

    def _perform_takeover(self, resource: str, event: Dict) -> None:
        """Successor-side recovery: restore the last-good checkpoint and
        replay the retained log past its saved offsets (the replay
        barrier keeps the replayed records' effects suppressed). Traffic
        admits as soon as this returns — no operator action."""
        manager = getattr(self.instance, "checkpoint_manager", None)
        if manager is None:
            return
        try:
            manager.restore_on_boot()
        except Exception:
            LOGGER.exception("takeover restore failed for %s", resource)

    @property
    def bus_port(self) -> int:
        return self.bus_server.port

    def start(self) -> None:
        self.bus_server.start()
        self.aggregator.start()
        self.instance.start()
        self.gossip.start()
        self.provisioning.start()
        self.reporter.start()
        self.takeover_monitor.start()

    def stop(self) -> None:
        self.takeover_monitor.stop()
        self.reporter.stop()
        self.provisioning.stop()
        self.gossip.stop()
        self.instance.stop()
        self.aggregator.stop()
        for client in self.peers.values():
            client.close()
        self.bus_server.stop()

    def processes(self) -> Dict[str, Dict]:
        out = self.aggregator.snapshot()
        me = str(self.process_id)
        if me not in out:
            state = self._build_state()
            state["process_id"] = self.process_id
            state["age_s"] = 0.0
            state["stale"] = False
            out[me] = state
        return out

    def cluster_telemetry(self) -> Dict:
        """Cluster-wide telemetry fan-in (GET /api/cluster/telemetry)."""
        return _cluster_telemetry(self)
