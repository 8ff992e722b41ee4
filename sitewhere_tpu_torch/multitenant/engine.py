"""Per-tenant engine: the full service stack for one tenant, one component
tree.

Reference: MultitenantMicroservice.java:54 keeps a map of tenant ->
MicroserviceTenantEngine (:64-70), boots engines for existing tenants on
start (:238), restarts failed engines (:284-303), and reacts to
tenant-model-updates. In the reference each of ~15 services runs its own
tenant engine; here ONE TenantEngine wires the whole per-tenant pipeline
(registry -> event management -> inbound -> enrichment -> delivery/
registration/connectors/rules/schedule/batch) around the SHARED process-wide
TPU pipeline engine + columnar log — the microservice fan-out collapsed into
a component tree (SURVEY.md §2.5: SPMD replaces RPC fan-out).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.assets import AssetManagement
from sitewhere_tpu_torch.batch import (
    BatchCommandInvocationHandler, BatchManagement, BatchOperationManager)
from sitewhere_tpu_torch.commands import CommandDeliveryService
from sitewhere_tpu_torch.connectors import OutboundConnectorsManager
from sitewhere_tpu_torch.model.batch import BatchOperationTypes
from sitewhere_tpu_torch.model.schedule import ScheduledJobType
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.persist.event_management import (
    DeviceEventManagement, EventPersistenceTriggers)
from sitewhere_tpu_torch.pipeline.enrichment import PayloadEnrichment
from sitewhere_tpu_torch.pipeline.inbound import InboundProcessingService
from sitewhere_tpu_torch.registration import RegistrationManager
from sitewhere_tpu_torch.registry.store import DeviceManagement
from sitewhere_tpu_torch.rules import RuleProcessorsManager
from sitewhere_tpu_torch.runtime.bus import ConsumerHost, TopicNaming
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.schedule import (
    BatchCommandInvocationJobExecutor, CommandInvocationJobExecutor,
    ScheduleManagement, ScheduleManager)
from sitewhere_tpu_torch.search import (ColumnarSearchProvider,
                                  SearchProvidersManager)
from sitewhere_tpu_torch.sources.manager import EventSourcesManager
from sitewhere_tpu_torch.streams import DeviceStreamManager

LOGGER = logging.getLogger("sitewhere.tenant")


class TenantEngine(LifecycleComponent):
    """Everything one tenant needs, assembled + lifecycle-managed.

    Shared process-level pieces come in as arguments (bus, columnar log,
    pipeline engine, registry tensors); per-tenant stores are created here.
    """

    def __init__(self, tenant: Tenant, bus, log, pipeline_engine=None,
                 registry_tensors=None, store_factory: Optional[Callable] = None,
                 naming: Optional[TopicNaming] = None, cluster=None,
                 batcher=None):
        super().__init__(f"tenant-engine:{tenant.token}")
        self.tenant = tenant
        self.tenant_id = tenant.token
        self.bus = bus
        self.log = log
        self.naming = naming or TopicNaming()
        self.pipeline_engine = pipeline_engine

        make_store = store_factory or (lambda kind: None)

        # registries
        self.registry = DeviceManagement(make_store("registry"), tenant.token)
        self.asset_management = AssetManagement(make_store("assets"),
                                                tenant.token)
        if registry_tensors is not None:
            registry_tensors.attach(self.registry, tenant.token)
        if cluster is not None and getattr(cluster, "data_plane", True):
            # inbound ownership routing and the lockstep step loop come
            # with the multi-host data plane; a host never drops them
            # quietly
            raise NotImplementedError(
                "data-plane cluster hooks (inbound ownership routing, the "
                "lockstep step loop) come with the multi-host data plane: "
                "ROADMAP A6d")
        if cluster is not None and getattr(cluster, "gossip", None) \
                is not None:
            # control-plane cluster (parallel/cluster.py): this tenant's
            # registry mutations broadcast to peers; theirs apply here.
            # Each host owns every device it ingests, so inbound keeps the
            # direct single-host submit path.
            cluster.gossip.register_tenant_registry(tenant.token,
                                                    self.registry)

        # event persistence + triggers. The pipeline packer's device
        # interner rides along so control-plane appends (inbound persist,
        # REST event posts, persisted rule alerts) stamp the SAME positive
        # device_idx the hot path does — lookup() never allocates, so an
        # unregistered token still lands as idx 0 (UNKNOWN) and the
        # serving tier's window cache falls back to the monolithic scan
        # for ranges containing it (serving/wincache.py). Without this
        # every REST-ingested row was idx 0 and the cache never engaged.
        self.event_management = DeviceEventManagement(
            log, self.registry, tenant.token,
            device_interner=(pipeline_engine.packer.devices
                             if pipeline_engine is not None else None))
        EventPersistenceTriggers(bus, self.naming,
                                 tenant.token).attach(self.event_management)

        # pipeline services
        self.inbound = InboundProcessingService(
            bus, self.registry, events=self.event_management,
            engine=pipeline_engine, tenant=tenant.token, naming=self.naming,
            batcher=batcher)
        self.enrichment = PayloadEnrichment(bus, self.registry, tenant.token,
                                            self.naming)
        self.command_delivery = CommandDeliveryService(
            bus, self.registry, tenant.token, self.naming)
        self.registration = RegistrationManager(
            bus, self.registry, tenant.token, self.naming,
            command_delivery=self.command_delivery)
        self.event_sources = EventSourcesManager()
        self.connectors = OutboundConnectorsManager(bus, tenant.token,
                                                    self.naming)
        self.rule_processors = RuleProcessorsManager(bus, tenant.token,
                                                     self.naming)

        # streaming media + federated search
        self.streams = DeviceStreamManager(self.registry,
                                           self.event_management,
                                           store=make_store("streams"))
        self.search_providers = SearchProvidersManager()
        self.search_providers.register(
            ColumnarSearchProvider(log, tenant.token))

        # batch + schedule
        self.batch_management = BatchManagement(make_store("batch"))
        self.batch_manager = BatchOperationManager(self.batch_management)
        self.batch_manager.register_handler(
            BatchOperationTypes.INVOKE_COMMAND,
            BatchCommandInvocationHandler(self.registry,
                                          self.event_management))
        self.schedule_management = ScheduleManagement(make_store("schedule"))
        self.schedule_manager = ScheduleManager(self.schedule_management)
        self.schedule_manager.register_executor(
            ScheduledJobType.COMMAND_INVOCATION,
            CommandInvocationJobExecutor(self.registry, self.event_management))
        self.schedule_manager.register_executor(
            ScheduledJobType.BATCH_COMMAND_INVOCATION,
            BatchCommandInvocationJobExecutor(
                self.registry, self.batch_manager, self.batch_management))
        if pipeline_engine is not None and \
                hasattr(pipeline_engine, "anomaly_model_manifest"):
            # unattended drift-refit sweeps: a
            # DRIFT_REFIT job walks installed anomaly models and pushes
            # refits through the gossip-replicated upsert path
            from sitewhere_tpu_torch.actuation.refit import (
                DriftRefitJobExecutor, DriftRefitter)
            self.drift_refitter = DriftRefitter(pipeline_engine)
            self.schedule_manager.register_executor(
                ScheduledJobType.DRIFT_REFIT,
                DriftRefitJobExecutor(self.drift_refitter))
        else:
            self.drift_refitter = None

        for component in (self.event_management, self.inbound, self.enrichment,
                          self.command_delivery, self.registration,
                          self.event_sources, self.connectors,
                          self.rule_processors, self.batch_manager,
                          self.schedule_manager, self.streams,
                          self.search_providers):
            self.add_nested(component)


class TenantEngineManager(LifecycleComponent):
    """tenant -> engine map with boot/restart semantics
    (MultitenantMicroservice.java:64-70, restart :284-303). Watches
    tenant-model-updates to add/remove engines live."""

    def __init__(self, tenant_management, engine_factory: Callable[[Tenant],
                                                                   TenantEngine],
                 bus=None, naming: Optional[TopicNaming] = None):
        super().__init__("tenant-engine-manager")
        self.tenant_management = tenant_management
        self.engine_factory = engine_factory
        self.bus = bus
        self.naming = naming or TopicNaming()
        self.engines: Dict[str, TenantEngine] = {}
        self.failed: Dict[str, str] = {}  # token -> error
        self._starting: set = set()  # tokens mid-boot (start_engine guard)
        self._stopped: set = set()   # tokens explicitly stopped by an admin
        self._lock = threading.RLock()
        self._watch: Optional[ConsumerHost] = None

    # -- lifecycle ---------------------------------------------------------
    def on_start(self, monitor) -> None:
        for tenant in self.tenant_management.tenants.all():
            self.start_engine(tenant.token)
        if self.bus is not None:
            self._watch = ConsumerHost(
                self.bus, self.naming.tenant_model_updates(),
                group_id="tenant-engine-manager", handler=self._on_updates)
            self._watch.start()

    def on_stop(self, monitor) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
        with self._lock:
            engines = list(self.engines.values())
            self.engines.clear()
        for engine in engines:
            try:
                engine.stop()
            except Exception:
                LOGGER.exception("stopping tenant engine %s failed",
                                 engine.tenant.token)

    # -- engine control ----------------------------------------------------
    def get_engine(self, tenant_token: str) -> Optional[TenantEngine]:
        with self._lock:
            return self.engines.get(tenant_token)

    def is_stopped(self, tenant_token: str) -> bool:
        """True when an admin explicitly stopped this engine (it must not be
        auto-restarted by lazy request-path resolution)."""
        with self._lock:
            return tenant_token in self._stopped

    def start_engine(self, tenant_token: str, wait_seconds: float = 30.0,
                     force: bool = False) -> Optional[TenantEngine]:
        """Boot (or return) the engine. A non-forced start respects an
        explicit admin stop — only `force=True` (the admin start/restart
        endpoints) clears the stopped flag, so stale async model-update
        records can't resurrect a stopped engine."""
        import time as _time
        deadline = _time.monotonic() + wait_seconds
        while True:
            with self._lock:
                if force:
                    self._stopped.discard(tenant_token)
                elif tenant_token in self._stopped:
                    return None
                if tenant_token in self.engines:
                    return self.engines[tenant_token]
                if tenant_token not in self._starting:
                    self._starting.add(tenant_token)
                    break
            # another thread is booting this tenant — wait for it rather
            # than surfacing a spurious "unknown tenant" to the caller
            if _time.monotonic() > deadline:
                return None
            _time.sleep(0.02)
        try:
            tenant = self.tenant_management.get_tenant_by_token(tenant_token)
            if tenant is None:
                return None
            try:
                engine = self.engine_factory(tenant)
                engine.start()
            except Exception as exc:
                with self._lock:
                    self.failed[tenant_token] = str(exc)
                LOGGER.exception("tenant engine %s failed to start",
                                 tenant_token)
                return None
            with self._lock:
                self.engines[tenant_token] = engine
                self.failed.pop(tenant_token, None)
            return engine
        finally:
            with self._lock:
                self._starting.discard(tenant_token)

    def stop_engine(self, tenant_token: str) -> None:
        with self._lock:
            engine = self.engines.pop(tenant_token, None)
            self._stopped.add(tenant_token)
        if engine is not None:
            engine.stop()

    def retire_engine(self, tenant_token: str) -> None:
        """Stop the engine for a DELETED tenant without leaving the
        admin-stop flag behind: an admin stop must survive stale async
        model-update records, but a deletion must not block a future
        tenant that legitimately reuses the token (tombstone resurrection
        semantics, multitenant/replication.py)."""
        self.stop_engine(tenant_token)
        with self._lock:
            self._stopped.discard(tenant_token)

    def restart_engine(self, tenant_token: str) -> Optional[TenantEngine]:
        self.stop_engine(tenant_token)
        return self.start_engine(tenant_token, force=True)

    # -- tenant-model-updates ---------------------------------------------
    def _on_updates(self, records: List) -> None:
        for record in records:
            try:
                update = json.loads(record.value)
            except Exception:
                continue
            token = update.get("tenant", "")
            operation = update.get("operation", "")
            if operation == "create":
                self.start_engine(token)
            elif operation == "delete":
                self.retire_engine(token)
            elif operation == "update":
                self.restart_engine(token)
