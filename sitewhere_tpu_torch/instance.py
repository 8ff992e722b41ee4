"""Top-level instance: the whole platform composed as one component tree.

Counterpart of `sitewhere_tpu/instance.py`. Reference: in SiteWhere an
"instance" is ~20 separate Spring Boot processes (service-* dirs, SURVEY.md
§2.4) bootstrapped by service-instance-management
(InstanceTemplateManager.java:32) and coordinated through ZooKeeper + Kafka.
Here the instance is ONE process: shared event bus + columnar log + the
pipeline engine on one card (`device`, "cuda" unless the caller asks for
the CPU), per-tenant engines managed by TenantEngineManager, user/tenant
managements, JWT token service, and instance bootstrap — all under a
single lifecycle root so `start()`/`stop()` brings the platform up/down
deterministically.

`shards > 1` (or a `ShardMesh`) selects the sharded engine
(parallel/engine.py): S shards of the device population in card blocks
over every visible card (`device` "cuda"; a card index pins one card),
with shard-congruent device interning, as the reference builds it. A
multi-process mesh (parallel/distributed.py `make_global_mesh`) makes this
instance one host of the multi-host data plane: its engine holds this
process's shards over this process's cards, and `ClusterService`
(parallel/cluster.py) installs itself as `cluster_hooks` before start(),
so tenant engines route inbound records to their owner host and feed the
lockstep step loop. The control-plane cluster (`ControlPlaneCluster`)
installs itself the same way: tenant engines then register their
registries with its gossip.

The query planner's mesh provider answers the sharded engine's mesh on one
controller, so a sharded instance's large window queries take the mesh
route over its cards (parallel/distributed.py); an instance of the single
engine on a card takes the live mesh over every visible card when there
are two or more, as the reference's does. A cluster host's provider
answers None:
a query there would enter a collective the other hosts do not (the
reference's host waits out its collectives' timeout and raises), so its
queries take the host route.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, Optional

import torch

from sitewhere_tpu_torch.device import resolve_device
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.multitenant.engine import TenantEngine, TenantEngineManager
from sitewhere_tpu_torch.multitenant.instance import InstanceBootstrap
from sitewhere_tpu_torch.multitenant.tenants import TenantManagement
from sitewhere_tpu_torch.persist.eventlog import ColumnarEventLog
from sitewhere_tpu_torch.registry.store import SqliteStore
from sitewhere_tpu_torch.runtime.bus import EventBus, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.security.tokens import TokenManagement
from sitewhere_tpu_torch.security.users import UserManagement

LOGGER = logging.getLogger("sitewhere.instance")


class SiteWhereInstance(LifecycleComponent):
    """Single-process platform instance.

    Parameters mirror the reference's instance settings
    (instance/InstanceSettings.java): instance id, data directory (replaces
    the ZK/Mongo split), and pipeline sizing knobs. With ``enable_pipeline``
    the fused TPU hot path is attached; without it the control plane still
    runs fully (useful for API-only deployments and tests).
    """

    def __init__(self, instance_id: str = "default",
                 data_dir: Optional[str] = None,
                 enable_pipeline: bool = False,
                 max_devices: int = 8192, max_zones: int = 64,
                 max_zone_vertices: int = 16, batch_size: int = 2048,
                 measurement_slots: int = 8, max_tenants: int = 16,
                 bus_partitions: int = 8,
                 default_tenant: Optional[str] = "default",
                 admin_username: str = "admin",
                 admin_password: str = "password",
                 shards: int = 1,
                 mesh=None,
                 device_routing: Optional[bool] = None,
                 tenant_datastores: Optional[Dict] = None,
                 checkpoint_interval_s: Optional[float] = None,
                 latency_linger_ms: Optional[float] = None,
                 latency_adaptive: bool = True,
                 allow_fault_drills: bool = False,
                 fault_plan: Optional[Dict] = None,
                 admission_step_budget_ms: Optional[float] = None,
                 admission_queue_depth_budget: Optional[int] = None,
                 trace_sample_n: int = 0,
                 h2d_buffer_depth: int = 3,
                 serving_workers: int = 4,
                 serving_queue_depth_budget: int = 64,
                 serving_latency_budget_ms: float = 0.0,
                 serving_cache_mb: float = 64.0,
                 serving_mesh_row_threshold: Optional[int] = None,
                 refit_interval_s: Optional[float] = None,
                 device="cuda"):
        super().__init__(f"instance:{instance_id}")
        # raises without CUDA: never falls back to the CPU
        self.device = device = resolve_device(device)
        from sitewhere_tpu_torch.parallel.mesh import (
            ShardMesh, shard_axis_size)
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise TypeError(f"mesh must be a ShardMesh (parallel/mesh.py "
                            f"or parallel/distributed.py), got "
                            f"{type(mesh).__name__}")
        self.instance_id = instance_id
        self.data_dir = data_dir
        # observability.trace_sample_n: sample 1 in N ingest deliveries
        # into a journey span stitched across busnet hops (0 disables);
        # ingest services read this at construction (sources/fastlane.py)
        self.trace_sample_n = int(trace_sample_n or 0)
        # multi-host deployment hooks (parallel/cluster.py ClusterService
        # or ControlPlaneCluster installs itself here BEFORE start(); tenant
        # engines wire them into their inbound processors and register
        # their registries with the gossip)
        self.cluster_hooks = None
        self.naming = TopicNaming(instance=instance_id)
        self.metrics = GLOBAL_METRICS
        # recovery epoch (runtime/recovery.py): minted once per boot,
        # durable under data_dir — stamps checkpoint manifests, gossip/
        # provisioning envelopes, and busnet RPCs so anything this
        # incarnation wrote can be fenced after a takeover, and a
        # restarted host always comes back above its fenced floor
        from sitewhere_tpu_torch.runtime.recovery import mint_epoch
        self.recovery_epoch = mint_epoch(data_dir)

        bus_dir = os.path.join(data_dir, "bus") if data_dir else None
        log_dir = os.path.join(data_dir, "events") if data_dir else None
        self.bus = EventBus(partitions=bus_partitions, data_dir=bus_dir)
        self.event_log = ColumnarEventLog(data_dir=log_dir)
        # per-tenant datastore choices (reference: tenants select their
        # store via DatastoreConfigurationParser) — overrides come from the
        # operator (config model) or `datastore.*` tenant metadata; tenants
        # without one share self.event_log
        from sitewhere_tpu_torch.persist.datastore import TenantDatastoreManager
        self.datastores = TenantDatastoreManager(
            self.event_log, base_dir=data_dir,
            overrides=tenant_datastores)

        self.registry_tensors = None
        self.pipeline_engine = None
        if enable_pipeline:
            from sitewhere_tpu_torch.registry.tensors import RegistryTensors
            n_shards = (shard_axis_size(mesh) if mesh is not None
                        else max(1, shards))
            if max_devices % n_shards:
                raise ValueError(
                    f"max_devices {max_devices} must be divisible by "
                    f"{n_shards} shards")
            # shard-congruent device interning: ownership (idx % S) is a
            # pure function of the token (registry/interning.py)
            self.registry_tensors = RegistryTensors(
                max_devices=max_devices, max_zones=max_zones,
                max_zone_vertices=max_zone_vertices,
                shard_classes=n_shards)
            if shards > 1 or mesh is not None:
                # the sharded step over S shards in card blocks
                from sitewhere_tpu_torch.parallel import (
                    ShardedPipelineEngine, make_mesh)
                self.pipeline_engine = ShardedPipelineEngine(
                    self.registry_tensors,
                    mesh=(mesh if mesh is not None
                          else make_mesh(shards, device=device)),
                    per_shard_batch=batch_size,
                    measurement_slots=measurement_slots,
                    max_tenants=max_tenants,
                    device_routing=device_routing,
                    h2d_buffer_depth=h2d_buffer_depth)
            else:
                from sitewhere_tpu_torch.pipeline.engine import \
                    PipelineEngine
                self.pipeline_engine = PipelineEngine(
                    self.registry_tensors, batch_size=batch_size,
                    measurement_slots=measurement_slots,
                    max_tenants=max_tenants,
                    h2d_buffer_depth=h2d_buffer_depth, device=device)
        # latency tier (pipeline.mode="latency"): one shared adaptive
        # batcher coalesces every tenant's hot events and flushes on fill
        # or linger (pipeline/feed.py) — inbound consumers offer to it
        # instead of packing per-poll batches. Adaptive linger (default)
        # dispatches a complete offered burst immediately; linger_ms then
        # only bounds coalescing behind an in-flight flush
        # (pipeline.adaptive_linger turns the classic fixed linger back on)
        self.latency_batcher = None
        if latency_linger_ms is not None and self.pipeline_engine is not None:
            from sitewhere_tpu_torch.pipeline.feed import AdaptiveBatcher
            self.latency_batcher = AdaptiveBatcher(
                self.pipeline_engine, linger_ms=latency_linger_ms,
                adaptive=latency_adaptive)

        # concurrent query serving tier (serving/, docs/SERVING.md):
        # planner-routed measurement-window reads — host kernel for small
        # scans on `device` — behind an incremental [K, W] grid cache and
        # bounded read admission, so dashboard pollers never stall ingest.
        # Large scans of a sharded instance take its mesh (_serving_mesh).
        from sitewhere_tpu_torch.analytics.engine import WindowedAnalyticsEngine
        from sitewhere_tpu_torch.serving import (
            QueryExecutor, QueryPlanner, WindowGridCache)
        from sitewhere_tpu_torch.serving.planner import DEFAULT_MESH_ROW_THRESHOLD
        self.analytics_planner = QueryPlanner(
            self.event_log, mesh_provider=self._serving_mesh,
            mesh_row_threshold=(serving_mesh_row_threshold
                                if serving_mesh_row_threshold is not None
                                else DEFAULT_MESH_ROW_THRESHOLD))
        self.analytics_engine = WindowedAnalyticsEngine(
            self.event_log, planner=self.analytics_planner, device=device)
        self.window_cache = WindowGridCache(
            max_bytes=int(float(serving_cache_mb) * (1 << 20)))
        self.serving = QueryExecutor(
            self.analytics_engine, self.analytics_planner, self.window_cache,
            workers=serving_workers,
            queue_depth_budget=serving_queue_depth_budget,
            latency_budget_ms=serving_latency_budget_ms or 0.0)
        # unattended drift-refit sweeps (actuation/refit.py): when set, a
        # SIMPLE-trigger schedule + DRIFT_REFIT job is installed on every
        # tenant engine at boot (_make_engine). Off by default: refits
        # rewrite live model constants, so autonomy is an operator opt-in.
        self.refit_interval_s = (float(refit_interval_s)
                                 if refit_interval_s else None)

        # robustness plane (runtime/faults.py, sources/manager.py):
        # `allow_fault_drills` gates the POST /api/instance/faults drill
        # endpoint (403 otherwise — drills are an operator action, never
        # ambient); `fault_plan` arms a seeded schedule at boot (config
        # model faults.*); admission budgets turn on front-door overload
        # shedding fed by the flight recorder + decoded-events backlog
        self.allow_fault_drills = bool(allow_fault_drills)
        if fault_plan:
            from sitewhere_tpu_torch.runtime.faults import FaultPlan, arm
            arm(FaultPlan.from_json(fault_plan))
        if (admission_step_budget_ms is not None
                or admission_queue_depth_budget is not None):
            from sitewhere_tpu_torch.sources.manager import GLOBAL_ADMISSION
            GLOBAL_ADMISSION.configure(
                step_budget_ms=admission_step_budget_ms,
                queue_depth_budget=admission_queue_depth_budget,
                queue_depth=self._ingest_backlog)

        # global (non-multitenant) managements — reference:
        # service-user-management / service-tenant-management
        self.user_management = UserManagement(self._make_store("users"))
        self.tenant_management = TenantManagement(
            self._make_store("tenants"), bus=self.bus, naming=self.naming)
        self.token_management = TokenManagement()
        # user mutations (local REST or cluster-replicated applies —
        # multitenant/replication.py) invalidate cached JWT auth state:
        # an update drops the claims cache, a delete revokes every token
        # the user already holds
        self.user_management.add_mutation_listener(self._on_user_mutation)
        self.bootstrap = InstanceBootstrap(
            self.user_management, self.tenant_management,
            admin_username=admin_username, admin_password=admin_password)

        self.engine_manager = TenantEngineManager(
            self.tenant_management, self._make_engine, bus=self.bus,
            naming=self.naming)
        self._default_tenant = default_tenant

        # label generation (reference: service-label-generation) — generators
        # are stateless, so one manager serves every tenant
        from sitewhere_tpu_torch.labels import LabelGeneratorManager
        self.label_generators = LabelGeneratorManager()

        # versioned user scripts (reference: Groovy scripting + ZK script
        # management), synced under data_dir when persistent
        from sitewhere_tpu_torch.runtime.scripts import ScriptManager
        self.script_manager = ScriptManager(data_dir=self.data_dir)
        # durable scripted-rule installs (reference: ZK-synced script
        # config, ScriptSynchronizer.java:32): survives restarts, rides
        # the instance checkpoint, and replicates via cluster gossip —
        # tenant engines re-install from it at boot (_make_engine)
        from sitewhere_tpu_torch.rules.store import (
            RuleProgramStore, ScriptedRuleStore)
        self.scripted_rules = ScriptedRuleStore(data_dir=self.data_dir)
        # durable rule-program installs (the CEP-lite compiler's control
        # plane — rules/compiler.py): tenant-scoped CRUD persisted with
        # the ScriptedRuleStore pattern, replicated cluster-wide with the
        # LWW/tombstone algebra, re-installed into the pipeline engine at
        # boot below
        self.rule_programs = RuleProgramStore(data_dir=self.data_dir)
        self._rule_program_lock = threading.Lock()
        if self.pipeline_engine is not None:
            for row in self.rule_programs.all_installs():
                try:
                    self.pipeline_engine.upsert_rule_program(row["spec"])
                except Exception:
                    logging.getLogger("sitewhere.instance").exception(
                        "could not restore rule program %r for tenant %s",
                        row["token"], row["tenant"])
        # durable anomaly-model installs (on-TPU inference — ml/): same
        # store pattern as the rule programs, re-installed into the
        # engine's weight tables at boot
        from sitewhere_tpu_torch.ml import ModelStore
        self.anomaly_models = ModelStore(data_dir=self.data_dir)
        self._anomaly_model_lock = threading.Lock()
        if self.pipeline_engine is not None:
            for row in self.anomaly_models.all_installs():
                try:
                    self.pipeline_engine.upsert_anomaly_model(row["spec"])
                except Exception:
                    logging.getLogger("sitewhere.instance").exception(
                        "could not restore anomaly model %r for tenant %s",
                        row["token"], row["tenant"])
        # durable actuation-policy installs (alert -> command policies —
        # actuation/): same store pattern as the anomaly models,
        # re-installed into the engine's policy table at boot so
        # in-flight debounce windows resume against the same slots
        from sitewhere_tpu_torch.actuation import ActuationPolicyStore, CommandFanout
        self.actuation_policies = ActuationPolicyStore(data_dir=self.data_dir)
        self._actuation_policy_lock = threading.Lock()
        self.command_fanout = None
        if self.pipeline_engine is not None:
            for row in self.actuation_policies.all_installs():
                try:
                    self.pipeline_engine.upsert_actuation_policy(row["spec"])
                except Exception:
                    logging.getLogger("sitewhere.instance").exception(
                        "could not restore actuation policy %r for tenant %s",
                        row["token"], row["tenant"])
            # delivery fan-out: lane fires route through the firing
            # tenant's command-delivery stack (resolve + route + encode);
            # bounded retry then dead-letter, replay-barrier suppression
            self.command_fanout = CommandFanout(self._deliver_command_fire)
            self.pipeline_engine.command_dispatcher = self.command_fanout
        # serializes scripted-rule check+attach+commit sequences: a gossip
        # apply that passed its LWW pre-check must not interleave with a
        # local install, or the loser's attach could replace the winner's
        # live processor while the store keeps the winner (silent
        # live/durable divergence on this host)
        self._scripted_rule_lock = threading.Lock()

        # centralized logging over the bus (reference:
        # MicroserviceLogProducer -> instance-logging topic). The handler
        # attaches to the process-global "sitewhere" logger: with several
        # instances in one process (tests), each captures the shared stream
        # under its own source label — matching the reference, where one
        # process is one microservice instance.
        from sitewhere_tpu_torch.runtime.logs import BusLogHandler, LogAggregator
        self.log_handler = BusLogHandler(self.bus, self.naming,
                                         source=instance_id)
        self.log_aggregator = LogAggregator(self.bus, self.naming)

        # checkpoint manager: restore-at-boot + periodic saves. Nested
        # AFTER the pipeline engine (whose state it restores) and BEFORE
        # the tenant engine manager (whose inbound consumers must not
        # start polling until the cursors are rewound to the checkpoint).
        self.checkpoint_manager = None
        if self.pipeline_engine is not None and data_dir is not None:
            from sitewhere_tpu_torch.persist.checkpoint import (
                InstanceCheckpointManager)
            self.checkpoint_manager = InstanceCheckpointManager(
                self, os.path.join(data_dir, "checkpoints"),
                interval_s=checkpoint_interval_s)
            # manifests carry this boot's epoch; a zombie writer (taken
            # over elsewhere) is refused by the stale-save fence
            self.checkpoint_manager.checkpointer.recovery_epoch = \
                self.recovery_epoch

        # scripts load from disk FIRST so the checkpoint restore's
        # last-writer-wins apply sees the local copies (and tenant
        # engines, built later, can resolve script-backed rules)
        self.add_nested(self.script_manager)
        if self.pipeline_engine is not None:
            self.add_nested(self.pipeline_engine)
        if self.checkpoint_manager is not None:
            self.add_nested(self.checkpoint_manager.component)
        self.add_nested(self.engine_manager)
        self.add_nested(self.label_generators)

    # -- wiring ------------------------------------------------------------
    def _on_user_mutation(self, kind: str, op: str, entity) -> None:
        if kind != "user" or op == "create":
            return
        username = getattr(entity, "username", "") or getattr(
            entity, "token", "")
        self.token_management.invalidate_user(username,
                                              revoke=(op == "delete"))

    def _make_store(self, kind: str):
        if self.data_dir is None:
            return None
        return SqliteStore(os.path.join(self.data_dir, f"{kind}.db"))

    def _serving_mesh(self):
        """Planner mesh provider: the pipeline's own mesh when the hot path
        runs sharded on one controller (its shard axis is the replay axis
        too, over its cards), else, for an instance on a card, the
        process-wide `live_mesh` (every visible card when there are two or
        more), else None. A multi-process mesh (a cluster host's, or the
        live mesh of a joined world) is never answered: the query would
        enter its collective on this host alone."""
        mesh = getattr(self.pipeline_engine, "mesh", None)
        if mesh is None and self.device.type == "cuda":
            from sitewhere_tpu_torch.parallel.distributed import live_mesh
            mesh = live_mesh()
        if mesh is not None and not mesh.is_multiprocess:
            return mesh
        return None

    def _make_engine(self, tenant: Tenant) -> TenantEngine:
        store_factory: Optional[Callable] = None
        if self.data_dir is not None:
            tenant_dir = os.path.join(self.data_dir, "tenants", tenant.token)
            os.makedirs(tenant_dir, exist_ok=True)
            store_factory = lambda kind: SqliteStore(
                os.path.join(tenant_dir, f"{kind}.db"))
        engine = TenantEngine(
            tenant, self.bus, self.datastores.event_log_for(tenant),
            pipeline_engine=self.pipeline_engine,
            registry_tensors=self.registry_tensors,
            store_factory=store_factory, naming=self.naming,
            cluster=self.cluster_hooks, batcher=self.latency_batcher)
        self.bootstrap.apply_template(engine)
        # re-install this tenant's durable scripted rules (they start with
        # the engine's rule_processors manager)
        for row in self.scripted_rules.installs_for(tenant.token):
            try:
                self._install_scripted_processor(
                    engine, tenant.token, row["token"], row["script"])
            except Exception:
                logging.getLogger("sitewhere.instance").exception(
                    "could not restore scripted rule %r (script %r) for "
                    "tenant %s", row["token"], row["script"], tenant.token)
        if self.refit_interval_s and engine.drift_refitter is not None:
            try:
                self._install_refit_schedule(engine)
            except Exception:
                logging.getLogger("sitewhere.instance").exception(
                    "could not install drift-refit schedule for tenant %s",
                    tenant.token)
        return engine

    # fixed tokens: the install is idempotent across restarts (durable
    # per-tenant schedule stores would otherwise accrete one job per boot)
    REFIT_SCHEDULE_TOKEN = "drift-refit-interval"
    REFIT_JOB_TOKEN = "drift-refit-sweep"

    def _install_refit_schedule(self, engine: TenantEngine) -> None:
        """Arm the unattended refit loop on one tenant engine: a
        SIMPLE-trigger schedule at `actuation.refit_interval_s` plus an
        ACTIVE DRIFT_REFIT job. Created before engine.start(), so the
        schedule manager's on_start resubmit picks the job up exactly
        like any job that survived a restart."""
        from sitewhere_tpu_torch.model.schedule import (
            Schedule, ScheduledJob, ScheduledJobState, ScheduledJobType,
            TriggerConstants, TriggerType)
        management = engine.schedule_management
        interval_ms = max(1, int(self.refit_interval_s * 1000.0))
        existing = management.schedules.get_by_token(self.REFIT_SCHEDULE_TOKEN)
        if existing is None:
            management.create_schedule(Schedule(
                token=self.REFIT_SCHEDULE_TOKEN, name="drift refit interval",
                trigger_type=TriggerType.SIMPLE,
                trigger_configuration={
                    TriggerConstants.REPEAT_INTERVAL: str(interval_ms)}))
        elif existing.trigger_configuration.get(
                TriggerConstants.REPEAT_INTERVAL) != str(interval_ms):
            # config changed between boots: durable schedule follows it
            management.schedules.update(existing.id, {
                "trigger_configuration": {
                    TriggerConstants.REPEAT_INTERVAL: str(interval_ms)}})
        if management.jobs.get_by_token(self.REFIT_JOB_TOKEN) is None:
            management.create_scheduled_job(ScheduledJob(
                token=self.REFIT_JOB_TOKEN,
                schedule_token=self.REFIT_SCHEDULE_TOKEN,
                job_type=ScheduledJobType.DRIFT_REFIT,
                job_state=ScheduledJobState.ACTIVE))

    # -- scripted rules (durable + replicated) -----------------------------
    def _install_scripted_processor(self, engine, tenant: str, token: str,
                                    script_id: str,
                                    replace: bool = True) -> None:
        """Resolve + attach the processor on an engine. With `replace`
        (boot restore, gossip apply — LWW semantics) an existing processor
        for the token is swapped when its backing script differs; without
        it (REST create) `add_processor`'s atomic duplicate check raises,
        so two concurrent installs of one token cannot both succeed."""
        from sitewhere_tpu_torch.errors import ErrorCode, NotFoundError
        from sitewhere_tpu_torch.rules import ScriptedRuleProcessor
        from sitewhere_tpu_torch.runtime.scripts import GLOBAL_SCOPE

        if replace:
            existing = engine.rule_processors.get_processor(token)
            if existing is not None:
                if getattr(existing, "script_id", None) == script_id:
                    return
                engine.rule_processors.remove_processor(token)
        else:
            # duplicate BEFORE resolve: a conflicting token must 409 even
            # when its script id is unresolvable (and skip the wasted
            # resolve). Race-free: every mutation path holds
            # _scripted_rule_lock; add_processor's atomic check remains
            # the backstop.
            if engine.rule_processors.get_processor(token) is not None:
                from sitewhere_tpu_torch.errors import DuplicateTokenError
                raise DuplicateTokenError(f"rule '{token}' already exists")
        try:
            try:
                handler = self.script_manager.resolve(
                    tenant, script_id, "process", require_entry=True)
            except Exception:
                handler = self.script_manager.resolve(
                    GLOBAL_SCOPE, script_id, "process", require_entry=True)
        except Exception as exc:
            # normalized for the gossip applier: a not-yet-replicated
            # script is a retryable dependency miss, not a hard failure
            raise NotFoundError(
                f"script '{script_id}' not resolvable for rule '{token}': "
                f"{exc}", ErrorCode.GENERIC) from exc
        engine.rule_processors.add_processor(
            ScriptedRuleProcessor(token, handler, script_id=script_id))

    def install_scripted_rule(self, tenant: str, token: str,
                              script_id: str,
                              replace: bool = False) -> None:
        """Install a script-backed rule processor on `tenant`: live attach
        + durable record (+ gossip via the store's listeners). The default
        is create semantics (duplicate token raises, atomically); config
        boot passes `replace=True` because config declares desired state."""
        engine = self.get_tenant_engine(tenant)
        if engine is None:
            from sitewhere_tpu_torch.errors import ErrorCode, NotFoundError
            raise NotFoundError(f"unknown tenant '{tenant}'",
                                ErrorCode.INVALID_TENANT_TOKEN)
        with self._scripted_rule_lock:
            self._install_scripted_processor(engine, tenant, token,
                                             script_id, replace=replace)
            # notify deferred: the listener publishes to peer bus edges,
            # which must not run inside the critical section (one slow
            # peer socket would stall every install AND the gossip
            # applier blocked on this lock)
            payload = self.scripted_rules.record(tenant, token, script_id,
                                                 notify=False)
        self.scripted_rules.emit("add", tenant, token, payload)

    def remove_scripted_rule(self, tenant: str, token: str) -> bool:
        """Live detach + durable tombstone (+ gossip). True if removed."""
        engine = self.get_tenant_engine(tenant)
        with self._scripted_rule_lock:
            removed = bool(
                engine is not None
                and engine.rule_processors.remove_processor(token))
            stamp = self.scripted_rules.erase(tenant, token, notify=False)
        if stamp is not None:
            self.scripted_rules.emit("remove", tenant, token, stamp)
        return stamp is not None or removed

    def apply_replicated_scripted_rule(self, op: str, tenant: str,
                                       token: str, payload) -> bool:
        """Gossip receive side (parallel/cluster.py): converge the durable
        store, then mirror the live processor state. Raises NotFoundError
        while the backing script has not replicated yet — the caller's
        at-least-once redelivery retries until it has. Returns True when
        local state actually changed (the caller's applied counter)."""
        if op == "add":
            script_id, stamp = payload["script"], payload["stamp"]
            with self._scripted_rule_lock:
                if not self.scripted_rules.would_apply_add(
                        tenant, token, script_id, stamp):
                    return False  # older than local state: no-op
                # live attach FIRST: if the backing script has not
                # replicated yet this raises NotFoundError and the store
                # stays unchanged, so the redelivered record retries the
                # whole apply. The lock keeps check+attach+commit atomic
                # vs local installs (see _scripted_rule_lock).
                engine = self.get_tenant_engine(tenant)
                if engine is not None:
                    self._install_scripted_processor(engine, tenant, token,
                                                     script_id)
                return self.scripted_rules.apply_add(tenant, token,
                                                     script_id, stamp)
        if op == "remove":
            with self._scripted_rule_lock:
                if self.scripted_rules.apply_remove(tenant, token,
                                                    int(payload)):
                    engine = self.engine_manager.get_engine(tenant)
                    if engine is not None:
                        engine.rule_processors.remove_processor(token)
                    return True
        return False

    # -- rule programs (durable + replicated; the CEP-lite fused rules) ----
    def install_rule_program(self, tenant: str, spec: Dict,
                             replace: bool = False) -> Dict:
        """Validate + install a rule program on the fused pipeline: live
        engine install (the dry-run compile 409s with the offending node
        BEFORE any mutation), durable record, gossip via the store's
        listeners. Program tokens are instance-global (the engine is);
        the store scopes listing and removal by tenant."""
        from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError

        engine = self.pipeline_engine
        if engine is None:
            raise SiteWhereError(
                "rule programs require a pipeline engine (pipeline.enabled)",
                ErrorCode.GENERIC, http_status=409)
        spec = dict(spec or {})
        spec["tenant_token"] = tenant  # force the request tenant's scope
        with self._rule_program_lock:
            if replace:
                entry = engine.upsert_rule_program(spec)
            else:
                entry = engine.create_rule_program(spec)
            payload = self.rule_programs.record(
                tenant, entry["spec"]["token"], entry["spec"], notify=False)
        self.rule_programs.emit("add", tenant, entry["spec"]["token"],
                                payload)
        return dict(entry["spec"])

    def remove_rule_program(self, tenant: str, token: str) -> bool:
        engine = self.pipeline_engine
        with self._rule_program_lock:
            removed = bool(engine is not None
                           and self.rule_programs.get(tenant, token)
                           is not None
                           and engine.remove_rule_program(token))
            stamp = self.rule_programs.erase(tenant, token, notify=False)
        if stamp is not None:
            self.rule_programs.emit("remove", tenant, token, stamp)
        return stamp is not None or removed

    def apply_replicated_rule_program(self, op: str, tenant: str,
                                      token: str, payload) -> bool:
        """Gossip receive side: converge the durable store, then mirror
        the live engine. An invalid spec raises RuleProgramError — the
        structured 409 naming the offending node — BEFORE any store
        mutation, so the gossip handler surfaces it as a conflict, not a
        stack trace, and the loser's state stays untouched."""
        engine = self.pipeline_engine
        if op == "add":
            spec, stamp = dict(payload["spec"]), int(payload["stamp"])
            with self._rule_program_lock:
                if not self.rule_programs.would_apply_add(
                        tenant, token, spec, stamp):
                    return False
                if engine is not None:
                    # validate + live install FIRST: a spec this engine's
                    # static buckets cannot hold must leave the store
                    # unchanged (RuleProgramError propagates, structured)
                    engine.upsert_rule_program(spec)
                return self.rule_programs.apply_add(tenant, token, spec,
                                                    stamp)
        if op == "remove":
            with self._rule_program_lock:
                if self.rule_programs.apply_remove(tenant, token,
                                                   int(payload)):
                    if engine is not None:
                        engine.remove_rule_program(token)
                    return True
        return False

    # -- anomaly models (durable + replicated; on-TPU inference) -----------
    def install_anomaly_model(self, tenant: str, spec: Dict,
                              replace: bool = False) -> Dict:
        """Validate + install an anomaly model on the fused pipeline:
        live engine install (the dry-run compile 409s naming the
        offending field BEFORE any mutation), durable record, gossip via
        the store's listeners. Model tokens are instance-global (the
        engine is); the store scopes listing and removal by tenant."""
        from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError

        engine = self.pipeline_engine
        if engine is None:
            raise SiteWhereError(
                "anomaly models require a pipeline engine "
                "(pipeline.enabled)", ErrorCode.GENERIC, http_status=409)
        spec = dict(spec or {})
        spec["tenant_token"] = tenant  # force the request tenant's scope
        with self._anomaly_model_lock:
            if replace:
                entry = engine.upsert_anomaly_model(spec)
            else:
                entry = engine.create_anomaly_model(spec)
            payload = self.anomaly_models.record(
                tenant, entry["spec"]["token"], entry["spec"], notify=False)
        self.anomaly_models.emit("add", tenant, entry["spec"]["token"],
                                 payload)
        return dict(entry["spec"])

    def remove_anomaly_model(self, tenant: str, token: str) -> bool:
        engine = self.pipeline_engine
        with self._anomaly_model_lock:
            removed = bool(engine is not None
                           and self.anomaly_models.get(tenant, token)
                           is not None
                           and engine.remove_anomaly_model(token))
            stamp = self.anomaly_models.erase(tenant, token, notify=False)
        if stamp is not None:
            self.anomaly_models.emit("remove", tenant, token, stamp)
        return stamp is not None or removed

    def apply_replicated_anomaly_model(self, op: str, tenant: str,
                                       token: str, payload) -> bool:
        """Gossip receive side: converge the durable store, then mirror
        the live engine. An invalid spec raises AnomalyModelError — the
        structured 409 naming the offending field — BEFORE any store
        mutation (same contract as the rule programs)."""
        engine = self.pipeline_engine
        if op == "add":
            spec, stamp = dict(payload["spec"]), int(payload["stamp"])
            with self._anomaly_model_lock:
                if not self.anomaly_models.would_apply_add(
                        tenant, token, spec, stamp):
                    return False
                if engine is not None:
                    engine.upsert_anomaly_model(spec)
                return self.anomaly_models.apply_add(tenant, token, spec,
                                                     stamp)
        if op == "remove":
            with self._anomaly_model_lock:
                if self.anomaly_models.apply_remove(tenant, token,
                                                    int(payload)):
                    if engine is not None:
                        engine.remove_anomaly_model(token)
                    return True
        return False

    # -- actuation policies (durable + replicated; alert -> command) -------
    def install_actuation_policy(self, tenant: str, spec: Dict,
                                 replace: bool = False) -> Dict:
        """Validate + install an alert->command policy on the fused
        pipeline: live engine install first (the compile 409s naming the
        offending field BEFORE any mutation), then durable record, then
        gossip via the store's listeners. Policy tokens are
        instance-global (the engine's slot table is); the store scopes
        listing and removal by tenant."""
        from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError

        engine = self.pipeline_engine
        if engine is None:
            raise SiteWhereError(
                "actuation policies require a pipeline engine "
                "(pipeline.enabled)", ErrorCode.GENERIC, http_status=409)
        spec = dict(spec or {})
        spec["tenant_token"] = tenant  # force the request tenant's scope
        with self._actuation_policy_lock:
            if replace:
                entry = engine.upsert_actuation_policy(spec)
            else:
                entry = engine.create_actuation_policy(spec)
            payload = self.actuation_policies.record(
                tenant, entry["spec"]["token"], entry["spec"], notify=False)
        self.actuation_policies.emit("add", tenant, entry["spec"]["token"],
                                     payload)
        return dict(entry["spec"])

    def remove_actuation_policy(self, tenant: str, token: str) -> bool:
        engine = self.pipeline_engine
        with self._actuation_policy_lock:
            removed = bool(engine is not None
                           and self.actuation_policies.get(tenant, token)
                           is not None
                           and engine.remove_actuation_policy(token))
            stamp = self.actuation_policies.erase(tenant, token,
                                                  notify=False)
        if stamp is not None:
            self.actuation_policies.emit("remove", tenant, token, stamp)
        return stamp is not None or removed

    def apply_replicated_actuation_policy(self, op: str, tenant: str,
                                          token: str, payload) -> bool:
        """Gossip receive side: converge the durable store, then mirror
        the live engine. An invalid spec raises ActuationPolicyError —
        the structured 409 naming the offending field — BEFORE any store
        mutation (same contract as the anomaly models)."""
        engine = self.pipeline_engine
        if op == "add":
            spec, stamp = dict(payload["spec"]), int(payload["stamp"])
            with self._actuation_policy_lock:
                if not self.actuation_policies.would_apply_add(
                        tenant, token, spec, stamp):
                    return False
                if engine is not None:
                    engine.upsert_actuation_policy(spec)
                return self.actuation_policies.apply_add(
                    tenant, token, spec, stamp)
        if op == "remove":
            with self._actuation_policy_lock:
                if self.actuation_policies.apply_remove(tenant, token,
                                                        int(payload)):
                    if engine is not None:
                        engine.remove_actuation_policy(token)
                    return True
        return False

    def _deliver_command_fire(self, fire: Dict) -> None:
        """CommandFanout transport: route one lane fire through the
        firing tenant's command-delivery stack. Raises (-> bounded retry,
        then dead-letter) when the tenant engine is down or the device
        has no active assignment."""
        from sitewhere_tpu_torch.actuation import deliver_via_service
        from sitewhere_tpu_torch.errors import SiteWhereError

        tenant = fire.get("tenant") or ""
        engine = self.engine_manager.get_engine(tenant)
        if engine is None:
            raise SiteWhereError(
                f"no running tenant engine for '{tenant}'")
        deliver_via_service(engine.command_delivery)(fire)

    # -- lifecycle ---------------------------------------------------------
    def on_initialize(self, monitor) -> None:
        self.event_log.start()  # background linger-flush thread
        self.datastores.start()
        self.bootstrap.bootstrap_users()
        if self._default_tenant:
            self.bootstrap.bootstrap_default_tenant(self._default_tenant)

    def on_start(self, monitor) -> None:
        # centralized logging wiring lives in on_start (not on_initialize,
        # which lifecycle runs only once) so instance.restart() re-attaches
        self.log_handler.start()
        self.log_aggregator.start()
        framework_logger = logging.getLogger("sitewhere")
        if framework_logger.level == logging.NOTSET:
            # the root default (WARNING) would filter INFO before the bus
            # handler ever sees it; only set when the operator hasn't
            framework_logger.setLevel(logging.INFO)
        if self.log_handler not in framework_logger.handlers:
            framework_logger.addHandler(self.log_handler)

    def on_stop(self, monitor) -> None:
        logging.getLogger("sitewhere").removeHandler(self.log_handler)
        self.log_handler.stop()
        self.log_aggregator.stop()
        self.serving.stop()  # drain in-flight reads before the log closes
        if self.latency_batcher is not None:
            self.latency_batcher.close()  # flushes pending offers
        self.datastores.stop()
        self.event_log.stop()
        self.bus.flush()  # durable bus logs visible to a successor instance

    def _ingest_backlog(self) -> int:
        """Worst decoded-events consumer lag across tenants — the
        admission controller's queue-depth signal (Kafka analog: max
        consumer group lag on the decoded topics)."""
        with self.bus._lock:
            groups = list(self.bus._groups.items())
        worst = 0
        for (topic_name, _group_id), group in groups:
            if topic_name.endswith("event-source-decoded-events"):
                worst = max(worst, group.lag())
        return worst

    # -- convenience accessors --------------------------------------------
    def get_tenant_engine(self, tenant_token: str) -> Optional[TenantEngine]:
        engine = self.engine_manager.get_engine(tenant_token)
        if engine is None and not self.engine_manager.is_stopped(tenant_token):
            # lazy boot on first use — but never resurrect an engine an
            # admin explicitly stopped
            engine = self.engine_manager.start_engine(tenant_token)
        return engine

    def topology(self) -> Dict:
        """Instance topology snapshot (replaces Kafka state heartbeats +
        TopologyStateAggregator.java for the single-process design)."""
        with self.engine_manager._lock:
            engines = {tok: eng.status.name
                       for tok, eng in self.engine_manager.engines.items()}
            failed = dict(self.engine_manager.failed)
        out = {
            "instance_id": self.instance_id,
            "status": self.status.name,
            "pipeline_enabled": self.pipeline_engine is not None,
            "tenant_engines": engines,
            "failed_tenant_engines": failed,
            # the torch device the engine and the read side run on
            "device": {"type": self.device.type, "name": (
                torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")},
        }
        mesh = getattr(self.pipeline_engine, "mesh", None)
        if mesh is not None:
            # the shard axis's card blocks: each card and its shards
            out["mesh"] = {"shards": mesh.n_shards, "cards": [
                {"card": str(card), "shards": mesh.shards_on(k)}
                for k, card in enumerate(mesh.cards)]}
        if self.pipeline_engine is not None:
            health = getattr(self.pipeline_engine, "health", None)
            if health is not None:
                # degradation ladder (runtime/health.py):
                # healthy -> degraded -> draining -> failed
                out["pipeline_health"] = health.to_json()
            # HBM residency ledger (runtime/hbmledger.py): per-table
            # resident bytes + backend headroom for capacity planning
            from sitewhere_tpu_torch.runtime import hbmledger
            out["hbm"] = hbmledger.ledger(self.pipeline_engine)
        from sitewhere_tpu_torch.sources.manager import GLOBAL_ADMISSION
        if GLOBAL_ADMISSION.enabled:
            out["admission"] = GLOBAL_ADMISSION.report()
        # failover plane (runtime/recovery.py): this boot's epoch, the
        # replay barrier's remaining suppression budget, and — with a
        # cluster — lease/takeover state from the monitor
        from sitewhere_tpu_torch.runtime.recovery import GLOBAL_REPLAY_BARRIER
        recovery: Dict = {
            "epoch": getattr(self, "recovery_epoch", 0),
            "replay_barrier_active": GLOBAL_REPLAY_BARRIER.active(),
            "replay_suppressed_effects": GLOBAL_REPLAY_BARRIER.suppressed,
        }
        if self.checkpoint_manager is not None:
            recovery["last_restore_epoch"] = \
                self.checkpoint_manager.checkpointer.last_restore_epoch
        out["recovery"] = recovery
        if self.cluster_hooks is not None:
            # multi-host deployment: per-process heartbeat states with
            # liveness (reference: TopologyStateAggregator.java)
            out["processes"] = self.cluster_hooks.processes()
            out["process_id"] = self.cluster_hooks.process_id
            out["degraded_peers"] = list(self.cluster_hooks.degraded)
            monitor = getattr(self.cluster_hooks, "takeover_monitor", None)
            if monitor is not None:
                recovery.update(monitor.snapshot())
        return out

    def extra_gauges(self) -> Dict[str, float]:
        """Derived gauges folded into the Prometheus exposition alongside
        the registry's own metrics: engine counters (one on-demand D2H
        fetch for the per-program/per-model vectors), cluster replication
        stats, the failover epoch, and the HBM residency ledger. Shared by
        GET /metrics and the cluster telemetry fan-in, so every peer's
        snapshot carries the same gauge families."""
        extra: Dict[str, float] = {}
        engine = self.pipeline_engine
        if engine is not None:
            extra["pipeline.batches_processed"] = engine.batches_processed
            extra["pipeline.alerts_dropped"] = engine.alerts_dropped
            health = getattr(engine, "health", None)
            if health is not None:
                # 0=healthy 1=degraded 2=draining 3=failed
                extra["pipeline.health_state"] = health.code
            # H2D staging ring (pipeline/staging.py): instantaneous slot
            # occupancy + configured depth. Only exported once the ring
            # has been built (first staged transfer) — a never-staging
            # engine keeps its exposition unchanged.
            ring = getattr(engine, "_staging_ring", None)
            if ring is not None:
                extra["pipeline.staging_ring.occupancy"] = ring.occupancy()
                extra["pipeline.staging_ring.depth"] = ring.depth
            for ptoken, c in engine.rule_program_counters().items():
                extra[f"pipeline.rule_program.fires.{ptoken}"] = c["fires"]
                extra[f"pipeline.rule_program.suppressed.{ptoken}"] = \
                    c["suppressed"]
            for mtoken, c in engine.anomaly_model_counters().items():
                extra[f"pipeline.anomaly_model.fires.{mtoken}"] = c["fires"]
                extra[f"pipeline.anomaly_model.evals.{mtoken}"] = c["evals"]
            for atoken, c in engine.actuation_policy_counters().items():
                extra[f"pipeline.actuation.fires.{atoken}"] = c["fires"]
                extra[f"pipeline.actuation.debounced.{atoken}"] = \
                    c["debounced"]
            if self.command_fanout is not None:
                for key, val in self.command_fanout.stats().items():
                    extra[f"pipeline.command_fanout.{key}"] = val
            # HBM residency: hbm.table_bytes{table="..."} per resident
            # table + hbm.total_bytes (host-side nbytes walk, no device
            # sync — runtime/hbmledger.py)
            from sitewhere_tpu_torch.runtime import hbmledger
            extra.update(hbmledger.export_gauges(engine))
        hooks = self.cluster_hooks
        if hooks is not None:
            gossip = hooks.gossip
            if gossip is not None:
                extra.update({
                    "cluster.gossip.published": gossip.published,
                    "cluster.gossip.applied": gossip.applied,
                    "cluster.gossip.conflicts": gossip.conflicts,
                    "cluster.gossip.publish_errors": gossip.publish_errors,
                })
            provisioning = getattr(hooks, "provisioning", None)
            if provisioning is not None:
                extra.update({
                    "cluster.provisioning.published":
                        provisioning.published,
                    "cluster.provisioning.applied": provisioning.applied,
                    "cluster.provisioning.publish_errors":
                        provisioning.publish_errors,
                    "cluster.provisioning.parked_rows":
                        provisioning.parked_rows,
                })
            if getattr(hooks, "data_plane", True):
                extra["cluster.forwarded_rows"] = hooks.forwarder.forwarded
                extra["cluster.forward_dead_lettered"] = \
                    hooks.forwarder.dead_lettered
                extra["cluster.step_ticks"] = hooks.loop.tick_count
            extra["cluster.degraded_peers"] = len(hooks.degraded)
        # serving tier: window-grid cache residency rides the hbm.* gauge
        # family (host RAM here, but the same capacity-planning ledger)
        extra["hbm.wincache_bytes"] = float(self.window_cache.resident_bytes)
        # failover epoch (runtime/recovery.py): lets dashboards graph
        # restarts/takeovers as step changes and alert on epoch skew
        extra["recovery.epoch"] = float(getattr(self, "recovery_epoch", 0))
        return extra

    def prometheus_text(self) -> str:
        """Full Prometheus exposition for this process: registry metrics
        plus every derived gauge from extra_gauges()."""
        return self.metrics.prometheus_text(self.extra_gauges())
