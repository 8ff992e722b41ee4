"""REST controllers: the reference's 27-controller surface on one router.

Reference: service-web-rest/src/main/java/com/sitewhere/web/rest/controllers/
(Devices.java, DeviceTypes.java, Assignments.java:98-160, Areas.java,
Zones.java, Customers.java, DeviceGroups.java, Assets.java, AssetTypes.java,
BatchOperations.java, Schedules.java, Tenants.java, Users.java,
DeviceEvents.java, DeviceStates.java, Instance.java, …). Each section below
names the controller it mirrors. Handlers receive a `Request` and return a
JSON-able object (or `(status, obj)`).

Tenant scoping: the reference resolves a tenant engine per request from the
X-SiteWhere-Tenant header via per-service gRPC routers; here `_engine()`
resolves the in-process TenantEngine the same way.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Any, Dict, List, Optional, Type

from sitewhere_tpu_torch.errors import ErrorCode, NotFoundError, SiteWhereError
from sitewhere_tpu_torch.model.area import (
    Area, AreaType, Customer, CustomerType, Zone)
from sitewhere_tpu_torch.model.asset import Asset, AssetType
from sitewhere_tpu_torch.model.batch import BatchOperation
from sitewhere_tpu_torch.model.common import Location, new_id
from sitewhere_tpu_torch.model.device import (
    Device, DeviceAlarm, DeviceAssignment, DeviceCommand, DeviceGroup,
    DeviceGroupElement, DeviceStatus, DeviceType)
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, CommandInitiator, CommandTarget, DeviceAlert,
    DeviceCommandInvocation, DeviceCommandResponse, DeviceEventBatch,
    DeviceLocation, DeviceMeasurement, DeviceStateChange, DeviceStreamData)
from sitewhere_tpu_torch.model.schedule import Schedule, ScheduledJob
from sitewhere_tpu_torch.model.tenant import Tenant
from sitewhere_tpu_torch.model.user import GrantedAuthority, SiteWhereRoles, User
from sitewhere_tpu_torch.persist.event_management import EventIndex
from sitewhere_tpu_torch.web.marshal import (
    entity_from_payload, results_to_jsonable, to_jsonable)
from sitewhere_tpu_torch.web.router import Request, Router

_EVENT_ENUM_FIELDS = {
    "source": AlertSource, "level": AlertLevel,
    "initiator": CommandInitiator, "target": CommandTarget,
}


def event_from_payload(cls: Type, payload: Dict[str, Any]):
    """JSON body → DeviceEvent subclass (enum + base64 coercion)."""
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in payload or f.name == "event_type":
            continue
        val = payload[f.name]
        enum_cls = _EVENT_ENUM_FIELDS.get(f.name)
        if enum_cls is not None and val is not None:
            val = enum_cls[val] if isinstance(val, str) else enum_cls(val)
        if f.name == "data" and isinstance(val, str):
            val = base64.b64decode(val)
        kwargs[f.name] = val
    return cls(**kwargs)


def _body(request: Request) -> Dict[str, Any]:
    if not isinstance(request.body, dict):
        raise SiteWhereError("JSON object body required", http_status=400)
    return request.body


def register_all(router: Router, instance, server) -> None:
    REST = SiteWhereRoles.REST

    def _engine(request: Request):
        token = request.tenant or "default"
        tenant = instance.tenant_management.get_tenant_by_token(token)
        if tenant is None:
            raise NotFoundError(f"unknown tenant: {token}",
                                ErrorCode.INVALID_TENANT_TOKEN)
        # tenant access gate (reference: ITenant.getAuthorizedUserIds checked
        # by the tenant-token interceptors): a non-empty authorized list
        # restricts access to those users + tenant administrators.
        if (tenant.authorized_user_ids
                and request.username not in tenant.authorized_user_ids
                and SiteWhereRoles.ADMINISTER_TENANTS
                not in request.authorities):
            raise SiteWhereError(
                f"user not authorized for tenant {token}", http_status=403)
        engine = instance.get_tenant_engine(token)
        if engine is None:
            raise NotFoundError(f"tenant engine unavailable: {token}",
                                ErrorCode.INVALID_TENANT_TOKEN)
        return engine

    def _registry(request: Request):
        return _engine(request).registry

    def _events(request: Request):
        return _engine(request).event_management

    def _assignment_events(request: Request):
        return _events(request), request.params["token"]

    # ------------------------------------------------------------------
    # System / instance (reference: Instance.java, System info endpoints)
    # ------------------------------------------------------------------
    def get_version(request: Request):
        import sitewhere_tpu_torch
        return {"version": sitewhere_tpu_torch.__version__,
                "edition": "sitewhere-tpu"}

    def get_topology(request: Request):
        return instance.topology()

    def get_metrics(request: Request):
        return instance.metrics.report()

    def get_flight(request: Request):
        """GET /api/instance/flight — last-N step flight records (stage
        segment timelines on one monotonic clock) + window rollups
        (per-stage occupancy, sum-vs-max sync decomposition,
        h2d_overlap_fraction, critical-stage counts). See
        docs/OBSERVABILITY.md for the schema."""
        from sitewhere_tpu_torch.runtime.flight import GLOBAL_FLIGHT
        last_n = request.query_int("last", 64)
        return GLOBAL_FLIGHT.export(last_n=max(1, min(last_n, 256)))

    def get_cluster_telemetry(request: Request):
        """GET /api/cluster/telemetry — cluster-wide telemetry fan-in:
        this host collects every peer's metrics snapshot, flight rollups,
        and event-age summary over busnet (`telemetry` op) and returns the
        peer-labeled merged view plus a merged Prometheus exposition
        (every sample re-labeled with peer="<pid>"). Unreachable peers are
        listed in `stale_peers` — a partial view beats a 502 during the
        exact incidents this endpoint exists for."""
        hooks = getattr(instance, "cluster_hooks", None)
        if hooks is None or not hasattr(hooks, "cluster_telemetry"):
            raise SiteWhereError(
                "cluster telemetry requires a cluster deployment "
                "(ClusterService or ControlPlaneCluster installed)",
                http_status=409)
        return hooks.cluster_telemetry()

    def get_logs(request: Request):
        return {"records": instance.log_aggregator.recent(
            limit=request.query_int("limit", 200),
            level=request.query_one("level"),
            source=request.query_one("source"))}

    def stream_topology(request: Request):
        """Live topology feed (SSE) — the reference's WebSocket
        TopologyBroadcaster. Emits a snapshot immediately, then again
        whenever it changes (0.5 s poll); keepalive comments every ~2 s of
        no change surface client disconnects (the write raises), so an
        abandoned stream never holds its server thread."""
        import json as _json
        import time as _time
        from sitewhere_tpu_torch.web.server import SseStream

        max_s = min(float(request.query_one("max_seconds", "3600")), 3600.0)

        def events():
            last = None
            idle = 0
            deadline = _time.monotonic() + max_s
            while _time.monotonic() < deadline:
                snap = instance.topology()
                enc = _json.dumps(snap, sort_keys=True)
                if enc != last:
                    last = enc
                    idle = 0
                    yield snap
                else:
                    idle += 1
                    if idle % 4 == 0:
                        yield ": keepalive"
                _time.sleep(0.5)

        return SseStream(events())

    def get_configuration_model(request: Request):
        from sitewhere_tpu_torch.runtime.config_model import (
            instance_configuration_model)
        return instance_configuration_model()

    def validate_configuration(request: Request):
        from sitewhere_tpu_torch.runtime.config_model import validate_config
        issues = validate_config(_body(request))
        return {"valid": not issues,
                "issues": [i.to_json() for i in issues]}

    def get_openapi(request: Request):
        import sitewhere_tpu_torch
        from sitewhere_tpu_torch.web.openapi import generate_openapi
        return generate_openapi(router, version=sitewhere_tpu_torch.__version__)

    # unauthenticated like the reference's swagger endpoint
    router.get("/api/openapi.json", get_openapi, auth=False)
    router.get("/api/system/version", get_version, authority=REST)
    router.get("/api/instance/topology", get_topology,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/metrics", get_metrics,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/flight", get_flight,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/cluster/telemetry", get_cluster_telemetry,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/logs", get_logs,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/topology/stream", stream_topology,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/configuration/model", get_configuration_model,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/instance/configuration/validate",
                validate_configuration,
                authority=SiteWhereRoles.VIEW_SERVER_INFO)

    def save_checkpoint(request: Request):
        """POST /api/instance/checkpoint — snapshot device state +
        interners + inbound cursors now (persist/checkpoint.py)."""
        manager = getattr(instance, "checkpoint_manager", None)
        if manager is None:
            raise SiteWhereError(
                "checkpointing requires a pipeline engine and a data_dir",
                http_status=409)
        path = manager.save()
        return {"path": path, "checkpoints": manager.list_checkpoints()}

    def list_checkpoints(request: Request):
        manager = getattr(instance, "checkpoint_manager", None)
        if manager is None:
            return {"checkpoints": []}
        return {"checkpoints": manager.list_checkpoints(),
                "restoredOffsets": manager.last_restore_offsets}

    # mutating + expensive (drains the engine, stalls the hot path,
    # writes to disk): requires the admin role like engine start/stop,
    # not the read-only VIEW_SERVER_INFO
    router.post("/api/instance/checkpoint", save_checkpoint,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.get("/api/instance/checkpoints", list_checkpoints,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)

    # ------------------------------------------------------------------
    # Serving tier — concurrent windowed analytics reads (serving/,
    # docs/SERVING.md). Every request goes through the QueryExecutor:
    # planner-routed host-vs-mesh replay behind the incremental grid
    # cache and per-tenant read admission — an over-budget poller gets
    # the structured 429 (QueryShedError) straight from submit.
    # ------------------------------------------------------------------
    def get_analytics_windows(request: Request):
        """GET /api/analytics/windows — per-device windowed stats for the
        request's tenant. `start_ms`+`end_ms` make the read cacheable
        (the grid origin is pinned); `keys` bounds the rows returned."""
        from sitewhere_tpu_torch.serving import WindowQuery
        _engine(request)  # tenant existence + authorization gate
        query = WindowQuery(
            tenant=request.tenant or "default",
            window_ms=max(1, request.query_int("window_ms", 60_000)),
            mm_name=request.query_one("mm"),
            start_ms=(int(request.query_one("start_ms"))
                      if request.query_one("start_ms") is not None else None),
            end_ms=(int(request.query_one("end_ms"))
                    if request.query_one("end_ms") is not None else None),
            area_id=request.query_one("area"),
            max_windows=min(4096, request.query_int("max_windows", 1024)))
        served = instance.serving.query(query)
        report, span = served["report"], served["span"]
        max_keys = min(256, request.query_int("keys", 64))

        def _col(arr, row):
            # NaN/inf (empty windows) are not strict-JSON; clients get null
            return [v if v == v and abs(v) != float("inf") else None
                    for v in (float(x) for x in arr[row, :report.n_windows])]

        keys = []
        for row in range(min(report.num_keys, max_keys)):
            keys.append({
                "id": int(report.key_ids[row]),
                "token": report.key_tokens[row],
                "count": [int(c) for c in
                          report.stats.count[row, :report.n_windows]],
                "sum": _col(report.stats.sum, row),
                "mean": _col(report.stats.mean, row),
                "min": _col(report.stats.min, row),
                "max": _col(report.stats.max, row),
            })
        return {
            "t0_ms": int(report.t0_ms),
            "window_ms": int(report.window_ms),
            "n_windows": int(report.n_windows),
            "num_keys": report.num_keys,
            "keys": keys,
            "serving": {"route": span["route"],
                        "cache_hit": span["cache_hit"],
                        "est_rows": span["est_rows"],
                        "total_ms": span["total_ms"]},
        }

    def get_serving_report(request: Request):
        """GET /api/serving/report — the read-side flight plane: pool +
        admission state, cache residency/hit counters, recent spans."""
        return instance.serving.report()

    router.get("/api/analytics/windows", get_analytics_windows,
               authority=REST)
    router.get("/api/serving/report", get_serving_report,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)

    # ------------------------------------------------------------------
    # Rule management — the operator surface of the fused pipeline rules
    # (pipeline/engine.py add_threshold_rule/add_geofence_rule; reference:
    # service-rule-processing ZoneTestRuleProcessor.java:33 configured via
    # RuleProcessingParser spring config, here live CRUD over REST)
    # ------------------------------------------------------------------
    def _pipeline_engine():
        engine = instance.pipeline_engine
        if engine is None:
            raise SiteWhereError(
                "rule management requires a pipeline engine "
                "(pipeline.enabled)", http_status=409)
        return engine

    def list_pipeline_rules(request: Request):
        from sitewhere_tpu_torch.pipeline.engine import rule_to_dict

        rules = _pipeline_engine().list_rules()
        out = {kind: [rule_to_dict(kind, rule) for rule in rule_list]
               for kind, rule_list in rules.items()}
        out["scripted"] = _list_scripted(request)
        return out

    def _scripted_rules(request: Request):
        """The REQUEST tenant's host-side rule processors (the scripted
        extension point; fused rules are instance-level)."""
        return _engine(request).rule_processors

    def create_pipeline_rule(request: Request):
        from sitewhere_tpu_torch.pipeline.engine import rule_from_dict, rule_to_dict

        body = _body(request)
        if body.get("type") == "scripted":
            return _create_scripted_rule(request, body)
        engine = _pipeline_engine()
        kind, rule = rule_from_dict(body)
        from sitewhere_tpu_torch.errors import DuplicateTokenError

        # one token namespace across fused AND scripted rules
        if _scripted_rules(request).get_processor(rule.token) is not None:
            raise DuplicateTokenError(f"rule '{rule.token}' already exists")
        engine.create_rule(kind, rule)  # atomic duplicate-token check
        return rule_to_dict(kind, rule)

    def _create_scripted_rule(request: Request, body: Dict):
        """Install a script-backed rule processor on the request tenant
        (the reference's Groovy rule processor, configured live instead
        of via spring restart). `script` names a ScriptManager script
        whose active version defines `process(context, event)` — verified
        at install time — and the resolve proxy hot-swaps on version
        activation. DURABLE and REPLICATED (round 5): the install records
        in the scripted-rule store (restored when the tenant engine
        boots, carried by the instance checkpoint) and gossips to every
        cluster host like a registry mutation."""
        from sitewhere_tpu_torch.errors import DuplicateTokenError

        token = body.get("token") or ""
        script_id = body.get("script") or ""
        if not token or not script_id:
            raise SiteWhereError(
                "scripted rules require 'token' and 'script'",
                http_status=400)
        # one token namespace across fused AND scripted rules (the
        # scripted side's duplicate check is add_processor's atomic one,
        # inside install_scripted_rule)
        if instance.pipeline_engine is not None \
                and instance.pipeline_engine.get_rule(token)[0] is not None:
            raise DuplicateTokenError(f"rule '{token}' already exists")
        instance.install_scripted_rule(request.tenant or "default", token,
                                       script_id)
        return {"type": "scripted", "token": token, "script": script_id,
                "scope": "replicated"}

    def _list_scripted(request: Request):
        return [{"type": "scripted",
                 "token": host.processor.processor_id,
                 "script": getattr(host.processor, "script_id", ""),
                 "active": host.is_running()}
                for host in _scripted_rules(request).list_processors()]

    def get_pipeline_rule(request: Request):
        from sitewhere_tpu_torch.pipeline.engine import rule_to_dict

        token = request.params["token"]
        kind, rule = _pipeline_engine().get_rule(token)
        if kind is None:
            processor = _scripted_rules(request).get_processor(token)
            if processor is not None:
                return {"type": "scripted", "token": token,
                        "script": getattr(processor, "script_id", ""),
                        "scope": "replicated"}
            raise NotFoundError(f"rule '{token}' not found",
                                ErrorCode.GENERIC)
        return rule_to_dict(kind, rule)

    def delete_pipeline_rule(request: Request):
        from sitewhere_tpu_torch.pipeline.engine import rule_to_dict

        engine = _pipeline_engine()
        token = request.params["token"]
        kind, rule = engine.get_rule(token)
        if kind is None or not engine.remove_rule(token):
            if instance.remove_scripted_rule(request.tenant or "default",
                                             token):
                return {"type": "scripted", "token": token}
            raise NotFoundError(f"rule '{token}' not found",
                                ErrorCode.GENERIC)
        return rule_to_dict(kind, rule)

    router.get("/api/rules", list_pipeline_rules,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/rules", create_pipeline_rule,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.get("/api/rules/{token}", get_pipeline_rule,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.delete("/api/rules/{token}", delete_pipeline_rule,
                  authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Stateful rule programs — the CEP-lite compiler's tenant-scoped
    # control plane (rules/compiler.py, ops/stateful.py): composite,
    # temporal rules compiled to fixed-shape tables evaluated inside the
    # fused step. Installs are durable (RuleProgramStore), replicated
    # cluster-wide with the LWW/tombstone algebra, and carry per-program
    # fire/suppress counters read on demand from the rule state.
    # ------------------------------------------------------------------
    def _program_tenant(request: Request) -> str:
        # the path names the tenant; _engine() enforces existence + the
        # caller's tenant access like every other tenant-scoped route
        _engine(request)
        return request.params["token"]

    def list_rule_programs(request: Request):
        tenant = _program_tenant(request)
        engine = instance.pipeline_engine
        counters = (engine.rule_program_counters()
                    if engine is not None else {})
        out = []
        for row in instance.rule_programs.installs_for(tenant):
            spec = row["spec"]
            out.append({**spec,
                        **counters.get(spec.get("token", ""),
                                       {"fires": 0, "suppressed": 0})})
        return {"programs": out}

    def create_rule_program(request: Request):
        tenant = _program_tenant(request)
        return instance.install_rule_program(tenant, _body(request))

    def get_rule_program(request: Request):
        tenant = _program_tenant(request)
        token = request.params["program"]
        row = instance.rule_programs.get(tenant, token)
        if row is None:
            raise NotFoundError(f"rule program '{token}' not found",
                                ErrorCode.GENERIC)
        engine = instance.pipeline_engine
        counters = (engine.rule_program_counters()
                    if engine is not None else {})
        return {**row["spec"],
                **counters.get(token, {"fires": 0, "suppressed": 0})}

    def delete_rule_program(request: Request):
        tenant = _program_tenant(request)
        token = request.params["program"]
        if not instance.remove_rule_program(tenant, token):
            raise NotFoundError(f"rule program '{token}' not found",
                                ErrorCode.GENERIC)
        return {"token": token, "removed": True}

    router.get("/api/tenants/{token}/ruleprograms", list_rule_programs,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/tenants/{token}/ruleprograms", create_rule_program,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.get("/api/tenants/{token}/ruleprograms/{program}",
               get_rule_program,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.delete("/api/tenants/{token}/ruleprograms/{program}",
                  delete_rule_program,
                  authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Anomaly models — on-TPU inference control plane (ml/compiler.py,
    # ops/anomaly.py): tiny learned scorers compiled into replicated
    # weight tables and evaluated inside the fused step. Installs are
    # durable (ModelStore), replicated with the LWW/tombstone algebra,
    # and carry per-model fire/eval counters read on demand from the
    # model state.
    # ------------------------------------------------------------------
    def list_anomaly_models(request: Request):
        tenant = _program_tenant(request)
        engine = instance.pipeline_engine
        counters = (engine.anomaly_model_counters()
                    if engine is not None else {})
        out = []
        for row in instance.anomaly_models.installs_for(tenant):
            spec = row["spec"]
            out.append({**spec,
                        **counters.get(spec.get("token", ""),
                                       {"fires": 0, "evals": 0})})
        return {"models": out}

    def create_anomaly_model(request: Request):
        tenant = _program_tenant(request)
        return instance.install_anomaly_model(tenant, _body(request))

    def get_anomaly_model(request: Request):
        tenant = _program_tenant(request)
        token = request.params["model"]
        row = instance.anomaly_models.get(tenant, token)
        if row is None:
            raise NotFoundError(f"anomaly model '{token}' not found",
                                ErrorCode.GENERIC)
        engine = instance.pipeline_engine
        counters = (engine.anomaly_model_counters()
                    if engine is not None else {})
        return {**row["spec"],
                **counters.get(token, {"fires": 0, "evals": 0})}

    def delete_anomaly_model(request: Request):
        tenant = _program_tenant(request)
        token = request.params["model"]
        if not instance.remove_anomaly_model(tenant, token):
            raise NotFoundError(f"anomaly model '{token}' not found",
                                ErrorCode.GENERIC)
        return {"token": token, "removed": True}

    router.get("/api/tenants/{token}/models", list_anomaly_models,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/tenants/{token}/models", create_anomaly_model,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.get("/api/tenants/{token}/models/{model}", get_anomaly_model,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.delete("/api/tenants/{token}/models/{model}",
                  delete_anomaly_model,
                  authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Actuation policies — the alert -> command control plane
    # (actuation/compiler.py, ops/actuate.py): declarative policies
    # compiled into the fused step's slot table, evaluated right after
    # anomaly scoring, delivered through the tenant's command stack.
    # Installs are durable (ActuationPolicyStore), replicated with the
    # LWW/tombstone algebra, and carry live per-policy fire/debounce
    # counters read on demand from the actuation state.
    # ------------------------------------------------------------------
    def list_actuation_policies(request: Request):
        tenant = _program_tenant(request)
        engine = instance.pipeline_engine
        counters = (engine.actuation_policy_counters()
                    if engine is not None else {})
        out = []
        for row in instance.actuation_policies.installs_for(tenant):
            spec = row["spec"]
            out.append({**spec,
                        **counters.get(spec.get("token", ""),
                                       {"fires": 0, "debounced": 0})})
        return {"policies": out}

    def create_actuation_policy(request: Request):
        tenant = _program_tenant(request)
        return instance.install_actuation_policy(tenant, _body(request))

    def get_actuation_policy(request: Request):
        tenant = _program_tenant(request)
        token = request.params["policy"]
        row = instance.actuation_policies.get(tenant, token)
        if row is None:
            raise NotFoundError(f"actuation policy '{token}' not found",
                                ErrorCode.GENERIC)
        engine = instance.pipeline_engine
        counters = (engine.actuation_policy_counters()
                    if engine is not None else {})
        return {**row["spec"],
                **counters.get(token, {"fires": 0, "debounced": 0})}

    def delete_actuation_policy(request: Request):
        tenant = _program_tenant(request)
        token = request.params["policy"]
        if not instance.remove_actuation_policy(tenant, token):
            raise NotFoundError(f"actuation policy '{token}' not found",
                                ErrorCode.GENERIC)
        return {"token": token, "removed": True}

    router.get("/api/tenants/{token}/actuations", list_actuation_policies,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/tenants/{token}/actuations", create_actuation_policy,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.get("/api/tenants/{token}/actuations/{policy}",
               get_actuation_policy,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.delete("/api/tenants/{token}/actuations/{policy}",
                  delete_actuation_policy,
                  authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Prometheus exposition + on-demand device profiling (reference:
    # Dropwizard reporters, Microservice.java:146,244-246; Jaeger spans)
    # ------------------------------------------------------------------
    def metrics_prometheus(request: Request):
        """GET /metrics — Prometheus text format. Public like every
        scrape endpoint (operational counters only; front with a network
        policy if the deployment needs to). The derived-gauge assembly
        lives on the instance (extra_gauges) so the cluster telemetry
        fan-in serves the identical families per peer."""
        text = instance.prometheus_text()
        return 200, text.encode("utf-8"), "text/plain; version=0.0.4"

    def start_device_trace(request: Request):
        """POST /api/instance/trace/start {log_dir?} — begin a
        torch.profiler capture on the live engine, written to log_dir as a
        Chrome trace when it stops (view in Perfetto or chrome://tracing);
        idempotent while tracing."""
        engine = instance.pipeline_engine
        if engine is None:
            raise SiteWhereError("device tracing requires a pipeline "
                                 "engine", http_status=409)
        import os as _os

        body = request.body if isinstance(request.body, dict) else {}
        log_dir = (body.get("log_dir")
                   or _os.path.join(instance.data_dir or ".",
                                    "device-trace"))
        engine.start_device_trace(log_dir)
        return {"tracing": True, "log_dir": log_dir}

    def stop_device_trace(request: Request):
        engine = instance.pipeline_engine
        if engine is None:
            raise SiteWhereError("device tracing requires a pipeline "
                                 "engine", http_status=409)
        engine.stop_device_trace()
        return {"tracing": False}

    router.get("/metrics", metrics_prometheus, auth=False)
    router.post("/api/instance/trace/start", start_device_trace,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.post("/api/instance/trace/stop", stop_device_trace,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Fault drills (runtime/faults.py; docs/OPERATIONS.md "Fault drills").
    # Arming is doubly guarded: admin authority AND the instance-level
    # allow_fault_drills switch — injecting faults is an operator drill
    # action, never something a stolen admin token should reach silently.
    # ------------------------------------------------------------------
    def _require_drills():
        if not getattr(instance, "allow_fault_drills", False):
            raise SiteWhereError(
                "fault drills are disabled on this instance "
                "(boot with allow_fault_drills=True)", http_status=403)

    def get_faults(request: Request):
        """GET /api/instance/faults — armed plan + per-point hit counts
        (empty report when disarmed)."""
        from sitewhere_tpu_torch.runtime.faults import active_plan
        plan = active_plan()
        return {"armed": plan is not None,
                "plan": plan.report() if plan is not None else None}

    def arm_faults(request: Request):
        """POST /api/instance/faults {seed, rules: [{point, p?, times?,
        after?, delay_s?, duration_s?}]} — arm a seeded fault schedule."""
        _require_drills()
        from sitewhere_tpu_torch.runtime.faults import FaultPlan, arm
        plan = FaultPlan.from_json(_body(request))
        arm(plan)
        return {"armed": True, "plan": plan.report()}

    def disarm_faults(request: Request):
        _require_drills()
        from sitewhere_tpu_torch.runtime.faults import disarm
        disarm()
        return {"armed": False}

    router.get("/api/instance/faults", get_faults,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.post("/api/instance/faults", arm_faults,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)
    router.delete("/api/instance/faults", disarm_faults,
                  authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Dead-letter operability (runtime/deadletter.py; reference: the
    # inbound-reprocess-events loop, KafkaTopicNaming.java:48-69)
    # ------------------------------------------------------------------
    def list_deadletters(request: Request):
        from sitewhere_tpu_torch.runtime.deadletter import list_parked_topics
        return {"topics": list_parked_topics(instance.bus, instance.naming)}

    def read_deadletters(request: Request):
        from sitewhere_tpu_torch.runtime.deadletter import read_parked_records
        topic = request.query_one("topic")
        if not topic:
            raise SiteWhereError("missing required query param 'topic'",
                                 http_status=400)
        return {"topic": topic, "records": read_parked_records(
            instance.bus, topic,
            limit=min(request.query_int("limit", 100), 1000))}

    def replay_deadletters(request: Request):
        from sitewhere_tpu_torch.runtime.deadletter import replay_parked_records
        body = _body(request)
        topic = body.get("topic")
        if not topic:
            raise SiteWhereError("missing required body field 'topic'",
                                 http_status=400)
        return replay_parked_records(
            instance.bus, instance.naming, topic,
            target=body.get("target"),
            max_records=int(body.get("max", 65536)))

    router.get("/api/instance/deadletters", list_deadletters,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    router.get("/api/instance/deadletters/records", read_deadletters,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)
    # re-ingests data into the pipeline: admin-scoped like checkpoints
    router.post("/api/instance/deadletters/replay", replay_deadletters,
                authority=SiteWhereRoles.ADMINISTER_TENANTS)

    # ------------------------------------------------------------------
    # Script management (reference: Instance.java:304-560 scripting rpcs,
    # global + per-tenant scopes)
    # ------------------------------------------------------------------
    def _register_script_routes(prefix: str, scope_of) -> None:
        sm = instance.script_manager
        ADMIN = SiteWhereRoles.ADMINISTER_TENANTS

        def list_scripts(request: Request):
            return {"scripts": [i.to_json() for i in
                                sm.list_scripts(scope_of(request))]}

        def create_script(request: Request):
            body = _body(request)
            info = sm.create_script(
                scope_of(request), body["scriptId"], body.get("content", ""),
                name=body.get("name", ""),
                description=body.get("description", ""),
                activate=body.get("activate", True))
            return 201, info.to_json()

        def get_script(request: Request):
            return sm.get_script(scope_of(request),
                                 request.params["script_id"]).to_json()

        def delete_script(request: Request):
            sm.delete_script(scope_of(request), request.params["script_id"])
            return {"deleted": True}

        def get_version_content(request: Request):
            content = sm.get_content(scope_of(request),
                                     request.params["script_id"],
                                     request.params["version_id"])
            return {"content": content}

        def add_version(request: Request):
            body = _body(request)
            v = sm.add_version(scope_of(request),
                               request.params["script_id"],
                               body.get("content", ""),
                               comment=body.get("comment", ""),
                               activate=body.get("activate", False))
            return 201, v.to_json()

        def clone_version(request: Request):
            body = request.body if isinstance(request.body, dict) else {}
            v = sm.clone_version(scope_of(request),
                                 request.params["script_id"],
                                 request.params["version_id"],
                                 comment=body.get("comment", ""))
            return 201, v.to_json()

        def activate_version(request: Request):
            return sm.activate_version(scope_of(request),
                                       request.params["script_id"],
                                       request.params["version_id"]).to_json()

        base = f"{prefix}/scripting/scripts"
        router.get(base, list_scripts, authority=ADMIN)
        router.post(base, create_script, authority=ADMIN)
        router.get(base + "/{script_id}", get_script, authority=ADMIN)
        router.delete(base + "/{script_id}", delete_script, authority=ADMIN)
        router.get(base + "/{script_id}/versions/{version_id}/content",
                   get_version_content, authority=ADMIN)
        router.post(base + "/{script_id}/versions", add_version,
                    authority=ADMIN)
        router.post(base + "/{script_id}/versions/{version_id}/clone",
                    clone_version, authority=ADMIN)
        router.post(base + "/{script_id}/versions/{version_id}/activate",
                    activate_version, authority=ADMIN)

    from sitewhere_tpu_torch.runtime.scripts import GLOBAL_SCOPE
    _register_script_routes("/api", lambda r: GLOBAL_SCOPE)
    _register_script_routes("/api/tenants/{token}",
                            lambda r: r.params["token"])

    # ------------------------------------------------------------------
    # Users + authorities (reference: Users.java, Authorities.java)
    # ------------------------------------------------------------------
    def _replication_status():
        """Cluster replication status of a provisioning mutation
        (multitenant/replication.py): did it broadcast, to how many
        peers, with how many publish failures parked for replay. Local
        (non-clustered) instances report mode "local"."""
        from sitewhere_tpu_torch.multitenant.replication import replicator_of

        replicator = replicator_of(instance)
        if replicator is None:
            return {"mode": "local", "peers": 0}
        return replicator.status()

    def _with_replication(entity):
        payload = to_jsonable(entity)
        payload["replication"] = _replication_status()
        return payload

    def get_provisioning_status(request: Request):
        """GET /api/instance/provisioning — replication counters +
        tombstone count for the control-plane provisioning stream."""
        return _replication_status()

    router.get("/api/instance/provisioning", get_provisioning_status,
               authority=SiteWhereRoles.VIEW_SERVER_INFO)

    def create_user(request: Request):
        body = _body(request)
        password = body.pop("password", "")
        user = entity_from_payload(User, body)
        return 201, _with_replication(
            instance.user_management.create_user(user, password))

    def list_users(request: Request):
        return results_to_jsonable(
            instance.user_management.list_users(request.criteria()))

    def get_user(request: Request):
        user = instance.user_management.get_user_by_username(
            request.params["username"])
        if user is None:
            raise NotFoundError("unknown user", ErrorCode.INVALID_USERNAME)
        return user

    def update_user(request: Request):
        body = _body(request)
        password = body.pop("password", None)
        user = instance.user_management.update_user(
            request.params["username"], body, password=password)
        return _with_replication(user)

    def delete_user(request: Request):
        return _with_replication(instance.user_management.delete_user(
            request.params["username"]))

    def get_user_authorities(request: Request):
        return {"authorities": instance.user_management.get_user_authorities(
            request.params["username"])}

    def create_authority(request: Request):
        authority = entity_from_payload(GrantedAuthority, _body(request))
        return 201, instance.user_management.create_granted_authority(authority)

    def list_authorities(request: Request):
        return {"results": instance.user_management.list_granted_authorities()}

    ADMIN_USERS = SiteWhereRoles.ADMINISTER_USERS
    router.post("/api/users", create_user, authority=ADMIN_USERS)
    router.get("/api/users", list_users, authority=ADMIN_USERS)
    router.get("/api/users/{username}", get_user, authority=ADMIN_USERS)
    router.put("/api/users/{username}", update_user, authority=ADMIN_USERS)
    router.delete("/api/users/{username}", delete_user, authority=ADMIN_USERS)
    router.get("/api/users/{username}/authorities", get_user_authorities,
               authority=ADMIN_USERS)
    router.post("/api/authorities", create_authority, authority=ADMIN_USERS)
    router.get("/api/authorities", list_authorities, authority=ADMIN_USERS)

    # ------------------------------------------------------------------
    # Tenants + engine control (reference: Tenants.java)
    # ------------------------------------------------------------------
    ADMIN_TENANTS = SiteWhereRoles.ADMINISTER_TENANTS

    def create_tenant(request: Request):
        tenant = entity_from_payload(Tenant, _body(request))
        return 201, _with_replication(
            instance.tenant_management.create_tenant(tenant))

    def list_tenants(request: Request):
        return results_to_jsonable(
            instance.tenant_management.list_tenants(request.criteria()))

    def get_tenant(request: Request):
        tenant = instance.tenant_management.get_tenant_by_token(
            request.params["token"])
        if tenant is None:
            raise NotFoundError("unknown tenant",
                                ErrorCode.INVALID_TENANT_TOKEN)
        return tenant

    def update_tenant(request: Request):
        return _with_replication(instance.tenant_management.update_tenant(
            request.params["token"], _body(request)))

    def delete_tenant(request: Request):
        # retire (not admin-stop): deletion must not block a future
        # tenant that legitimately reuses the token after resurrection
        instance.engine_manager.retire_engine(request.params["token"])
        return _with_replication(instance.tenant_management.delete_tenant(
            request.params["token"]))

    def start_tenant_engine(request: Request):
        engine = instance.engine_manager.start_engine(request.params["token"],
                                                      force=True)
        if engine is None:
            raise NotFoundError("unknown tenant",
                                ErrorCode.INVALID_TENANT_TOKEN)
        return {"status": engine.status.name}

    def stop_tenant_engine(request: Request):
        instance.engine_manager.stop_engine(request.params["token"])
        return {"status": "STOPPED"}

    def restart_tenant_engine(request: Request):
        engine = instance.engine_manager.restart_engine(request.params["token"])
        return {"status": engine.status.name if engine else "FAILED"}

    router.post("/api/tenants", create_tenant, authority=ADMIN_TENANTS)
    router.get("/api/tenants", list_tenants, authority=ADMIN_TENANTS)
    router.get("/api/tenants/{token}", get_tenant, authority=ADMIN_TENANTS)
    router.put("/api/tenants/{token}", update_tenant, authority=ADMIN_TENANTS)
    router.delete("/api/tenants/{token}", delete_tenant,
                  authority=ADMIN_TENANTS)
    router.post("/api/tenants/{token}/engine/start", start_tenant_engine,
                authority=ADMIN_TENANTS)
    router.post("/api/tenants/{token}/engine/stop", stop_tenant_engine,
                authority=ADMIN_TENANTS)
    router.post("/api/tenants/{token}/engine/restart", restart_tenant_engine,
                authority=ADMIN_TENANTS)

    # ------------------------------------------------------------------
    # Device types + commands + statuses (reference: DeviceTypes.java)
    # ------------------------------------------------------------------
    def create_device_type(request: Request):
        return 201, _registry(request).create_device_type(
            entity_from_payload(DeviceType, _body(request)))

    def list_device_types(request: Request):
        return results_to_jsonable(
            _registry(request).list_device_types(request.criteria()))

    def get_device_type(request: Request):
        return _registry(request).get_device_type_by_token(
            request.params["token"])

    def update_device_type(request: Request):
        return _registry(request).update_device_type(
            request.params["token"], _body(request))

    def delete_device_type(request: Request):
        return _registry(request).delete_device_type(request.params["token"])

    def create_device_command(request: Request):
        registry = _registry(request)
        dtype = registry.get_device_type_by_token(request.params["token"])
        command = entity_from_payload(DeviceCommand, _body(request))
        command.device_type_id = dtype.id
        return 201, registry.create_device_command(command)

    def list_device_commands(request: Request):
        return results_to_jsonable(_registry(request).list_device_commands(
            device_type_token=request.params["token"]))

    def create_device_status(request: Request):
        registry = _registry(request)
        dtype = registry.get_device_type_by_token(request.params["token"])
        status = entity_from_payload(DeviceStatus, _body(request))
        status.device_type_id = dtype.id
        return 201, registry.create_device_status(status)

    def list_device_statuses(request: Request):
        return results_to_jsonable(_registry(request).list_device_statuses(
            device_type_token=request.params["token"]))

    router.post("/api/devicetypes", create_device_type, authority=REST)
    router.get("/api/devicetypes", list_device_types, authority=REST)
    router.get("/api/devicetypes/{token}", get_device_type, authority=REST)
    router.put("/api/devicetypes/{token}", update_device_type, authority=REST)
    router.delete("/api/devicetypes/{token}", delete_device_type,
                  authority=REST)
    router.post("/api/devicetypes/{token}/commands", create_device_command,
                authority=REST)
    router.get("/api/devicetypes/{token}/commands", list_device_commands,
               authority=REST)
    router.post("/api/devicetypes/{token}/statuses", create_device_status,
                authority=REST)
    router.get("/api/devicetypes/{token}/statuses", list_device_statuses,
               authority=REST)

    # ------------------------------------------------------------------
    # Devices (reference: Devices.java)
    # ------------------------------------------------------------------
    def create_device(request: Request):
        registry = _registry(request)
        body = _body(request)
        type_token = body.pop("device_type_token", None)
        device = entity_from_payload(Device, body)
        if type_token and not device.device_type_id:
            device.device_type_id = registry.get_device_type_by_token(
                type_token).id
        return 201, registry.create_device(device)

    def list_devices(request: Request):
        assigned = request.query_one("assigned")
        return results_to_jsonable(_registry(request).list_devices(
            request.criteria(),
            device_type_token=request.query_one("deviceType"),
            assigned=None if assigned is None else assigned == "true"))

    def get_device(request: Request):
        device = _registry(request).get_device_by_token(
            request.params["token"])
        if device is None:
            raise NotFoundError("unknown device",
                                ErrorCode.INVALID_DEVICE_TOKEN)
        return device

    def update_device(request: Request):
        return _registry(request).update_device(request.params["token"],
                                                _body(request))

    def delete_device(request: Request):
        return _registry(request).delete_device(request.params["token"])

    def list_device_assignments(request: Request):
        return results_to_jsonable(_registry(request).list_assignments(
            request.criteria(), device_token=request.params["token"]))

    def add_device_event_batch(request: Request):
        body = _body(request)
        batch = DeviceEventBatch(
            device_token=request.params["token"],
            measurements=[event_from_payload(DeviceMeasurement, e)
                          for e in body.get("measurements", [])],
            locations=[event_from_payload(DeviceLocation, e)
                       for e in body.get("locations", [])],
            alerts=[event_from_payload(DeviceAlert, e)
                    for e in body.get("alerts", [])])
        persisted = _events(request).add_device_event_batch(
            request.params["token"], batch)
        return 201, {"persisted": len(persisted)}

    def list_device_events(request: Request):
        return results_to_jsonable(_events(request).list_device_events(
            request.params["token"], request.date_criteria()))

    router.post("/api/devices", create_device, authority=REST)
    router.get("/api/devices", list_devices, authority=REST)
    router.get("/api/devices/{token}", get_device, authority=REST)
    router.put("/api/devices/{token}", update_device, authority=REST)
    router.delete("/api/devices/{token}", delete_device, authority=REST)
    router.get("/api/devices/{token}/assignments", list_device_assignments,
               authority=REST)
    def create_device_mapping(request: Request):
        """Map a child device into a composite parent's schema slot
        (Devices.java:268 addDeviceElementMapping)."""
        from sitewhere_tpu_torch.model.device import DeviceElementMapping
        body = _body(request)
        mapping = DeviceElementMapping(
            device_element_schema_path=body.get(
                "deviceElementSchemaPath", body.get(
                    "device_element_schema_path", "")),
            device_token=body.get("deviceToken",
                                  body.get("device_token", "")))
        return _registry(request).create_device_element_mapping(
            request.params["token"], mapping)

    def delete_device_mapping(request: Request):
        """Remove the mapping at ?path= (Devices.java:281)."""
        path = request.query_one("path") or ""
        return _registry(request).delete_device_element_mapping(
            request.params["token"], path)

    router.post("/api/devices/{token}/events", add_device_event_batch,
                authority=REST)
    router.get("/api/devices/{token}/events", list_device_events,
               authority=REST)
    router.post("/api/devices/{token}/mappings", create_device_mapping,
                authority=REST)
    router.delete("/api/devices/{token}/mappings", delete_device_mapping,
                  authority=REST)

    # ------------------------------------------------------------------
    # Device alarms (reference: device-management alarm rpcs exposed
    # through Devices REST; DeviceAlarm CRUD + acknowledge/resolve)
    # ------------------------------------------------------------------
    def create_device_alarm(request: Request):
        registry = _registry(request)
        device = registry.get_device_by_token(request.params["token"])
        if device is None:
            raise NotFoundError("unknown device",
                                ErrorCode.INVALID_DEVICE_TOKEN)
        alarm = entity_from_payload(DeviceAlarm, _body(request))
        alarm.device_id = device.id
        return 201, registry.create_device_alarm(alarm)

    def list_device_alarms(request: Request):
        return results_to_jsonable(_registry(request).list_device_alarms(
            device_token=request.params["token"],
            criteria=request.criteria()))

    def list_all_alarms(request: Request):
        return results_to_jsonable(_registry(request).list_device_alarms(
            criteria=request.criteria()))

    def get_alarm(request: Request):
        alarm = _registry(request).get_device_alarm(
            request.params["alarm_id"])
        if alarm is None:
            raise NotFoundError("alarm not found",
                                ErrorCode.INVALID_EVENT_ID)
        return alarm

    def update_alarm(request: Request):
        return _registry(request).update_device_alarm(
            request.params["alarm_id"], _body(request))

    def delete_alarm(request: Request):
        return _registry(request).delete_device_alarm(
            request.params["alarm_id"])

    router.post("/api/devices/{token}/alarms", create_device_alarm,
                authority=REST)
    router.get("/api/devices/{token}/alarms", list_device_alarms,
               authority=REST)
    router.get("/api/alarms", list_all_alarms, authority=REST)
    router.get("/api/alarms/{alarm_id}", get_alarm, authority=REST)
    router.put("/api/alarms/{alarm_id}", update_alarm, authority=REST)
    router.delete("/api/alarms/{alarm_id}", delete_alarm, authority=REST)

    # ------------------------------------------------------------------
    # Label generation (reference: service-label-generation +
    # Devices.java/Assignments.java/... /{token}/label/{generatorId})
    # ------------------------------------------------------------------
    def list_label_generators(request: Request):
        return {"generators": instance.label_generators.generator_ids()}

    _LABEL_CODES = {
        "device": ErrorCode.INVALID_DEVICE_TOKEN,
        "devicetype": ErrorCode.INVALID_DEVICE_TYPE_TOKEN,
        "assignment": ErrorCode.INVALID_ASSIGNMENT_TOKEN,
        "area": ErrorCode.INVALID_AREA_TOKEN,
        "customer": ErrorCode.INVALID_CUSTOMER_TOKEN,
        "asset": ErrorCode.INVALID_ASSET_TOKEN,
    }

    def _label(entity_type: str, lookup):
        def handler(request: Request):
            token = request.params["token"]
            if lookup(request, token) is None:
                raise NotFoundError(f"unknown {entity_type}: {token}",
                                    _LABEL_CODES[entity_type])
            png = instance.label_generators.label_for(
                request.params["generator_id"], entity_type, token)
            return 200, png, "image/png"
        return handler

    router.get("/api/labels/generators", list_label_generators,
               authority=REST)
    for _etype, _pathseg, _lookup in (
            ("device", "devices",
             lambda r, t: _registry(r).get_device_by_token(t)),
            ("devicetype", "devicetypes",
             lambda r, t: _registry(r).get_device_type_by_token(t)),
            ("assignment", "assignments",
             lambda r, t: _registry(r).get_device_assignment_by_token(t)),
            ("area", "areas",
             lambda r, t: _registry(r).get_area_by_token(t)),
            ("customer", "customers",
             lambda r, t: _registry(r).get_customer_by_token(t)),
            ("asset", "assets",
             lambda r, t: _engine(r).asset_management.get_asset_by_token(t)),
    ):
        router.get(f"/api/{_pathseg}/{{token}}/label/{{generator_id}}",
                   _label(_etype, _lookup), authority=REST)

    # ------------------------------------------------------------------
    # Assignments + per-assignment events (reference: Assignments.java)
    # ------------------------------------------------------------------
    def create_assignment(request: Request):
        registry = _registry(request)
        body = _body(request)
        device_token = body.pop("device_token", None)
        assignment = entity_from_payload(DeviceAssignment, body)
        if device_token and not assignment.device_id:
            device = registry.get_device_by_token(device_token)
            if device is None:
                raise NotFoundError("unknown device",
                                    ErrorCode.INVALID_DEVICE_TOKEN)
            assignment.device_id = device.id
        for token_field, lookup, id_field in (
                ("area_token", registry.get_area_by_token, "area_id"),
                ("customer_token", registry.get_customer_by_token,
                 "customer_id")):
            tok = body.get(token_field)
            if tok and not getattr(assignment, id_field):
                setattr(assignment, id_field, lookup(tok).id)
        if not assignment.token:
            assignment.token = new_id()
        return 201, registry.create_device_assignment(assignment)

    def list_assignments(request: Request):
        return results_to_jsonable(_registry(request).list_assignments(
            request.criteria(), device_token=request.query_one("device"),
            customer_token=request.query_one("customer"),
            area_token=request.query_one("area")))

    def get_assignment(request: Request):
        assignment = _registry(request).get_device_assignment_by_token(
            request.params["token"])
        if assignment is None:
            raise NotFoundError("unknown assignment",
                                ErrorCode.INVALID_ASSIGNMENT_TOKEN)
        return assignment

    def release_assignment(request: Request):
        return _registry(request).release_device_assignment(
            request.params["token"])

    def mark_assignment_missing(request: Request):
        registry = _registry(request)
        assignment = registry.get_device_assignment_by_token(
            request.params["token"])
        if assignment is None:
            raise NotFoundError("unknown assignment",
                                ErrorCode.INVALID_ASSIGNMENT_TOKEN)
        return registry.mark_assignment_missing(assignment.id)

    router.post("/api/assignments", create_assignment, authority=REST)
    router.get("/api/assignments", list_assignments, authority=REST)
    router.get("/api/assignments/{token}", get_assignment, authority=REST)
    router.post("/api/assignments/{token}/end", release_assignment,
                authority=REST)
    router.post("/api/assignments/{token}/missing", mark_assignment_missing,
                authority=REST)

    def _event_routes(kind: str, cls, add_method: str, list_method: str):
        def add(request: Request):
            events_api, token = _assignment_events(request)
            payloads = request.body
            if isinstance(payloads, dict):
                payloads = [payloads]
            if not isinstance(payloads, list):
                raise SiteWhereError("JSON event body required",
                                     http_status=400)
            events = [event_from_payload(cls, p) for p in payloads]
            persisted = getattr(events_api, add_method)(token, *events)
            return 201, (persisted[0] if len(persisted) == 1
                         else {"persisted": len(persisted)})

        def list_(request: Request):
            events_api, token = _assignment_events(request)
            return results_to_jsonable(getattr(events_api, list_method)(
                EventIndex.ASSIGNMENT, token, request.date_criteria()))

        router.post(f"/api/assignments/{{token}}/{kind}", add, authority=REST)
        router.get(f"/api/assignments/{{token}}/{kind}", list_,
                   authority=REST)

    _event_routes("measurements", DeviceMeasurement, "add_measurements",
                  "list_measurements")
    _event_routes("locations", DeviceLocation, "add_locations",
                  "list_locations")
    _event_routes("alerts", DeviceAlert, "add_alerts", "list_alerts")
    _event_routes("statechanges", DeviceStateChange, "add_state_changes",
                  "list_state_changes")

    def create_command_invocation(request: Request):
        """POST …/invocations — the §3.4 cloud→device flow entry point."""
        events_api, token = _assignment_events(request)
        body = _body(request)
        invocation = event_from_payload(DeviceCommandInvocation, body)
        if not invocation.target_id:
            invocation.target_id = token
        if invocation.initiator == CommandInitiator.REST:
            invocation.initiator_id = request.username
        persisted = events_api.add_command_invocations(token, invocation)
        return 201, persisted[0]

    def list_command_invocations(request: Request):
        events_api, token = _assignment_events(request)
        return results_to_jsonable(events_api.list_command_invocations(
            EventIndex.ASSIGNMENT, token, request.date_criteria()))

    def create_command_response(request: Request):
        events_api, token = _assignment_events(request)
        response = event_from_payload(DeviceCommandResponse, _body(request))
        persisted = events_api.add_command_responses(token, response)
        return 201, persisted[0]

    def list_command_responses(request: Request):
        events_api, _ = _assignment_events(request)
        return results_to_jsonable(
            events_api.list_command_responses_for_invocation(
                request.params["invocation_id"], request.date_criteria()))

    router.post("/api/assignments/{token}/invocations",
                create_command_invocation, authority=REST)
    router.get("/api/assignments/{token}/invocations",
               list_command_invocations, authority=REST)
    router.post("/api/assignments/{token}/responses", create_command_response,
                authority=REST)
    router.get("/api/invocations/{invocation_id}/responses",
               list_command_responses, authority=REST)

    def list_assignment_events(request: Request):
        from sitewhere_tpu_torch.persist.eventlog import EventFilter
        events_api, token = _assignment_events(request)
        return results_to_jsonable(events_api.log.query(
            events_api.tenant, EventFilter(assignment_token=token),
            request.date_criteria()))

    router.get("/api/assignments/{token}/events", list_assignment_events,
               authority=REST)

    # ------------------------------------------------------------------
    # Events by id (reference: DeviceEvents.java)
    # ------------------------------------------------------------------
    def get_event_by_id(request: Request):
        event = _events(request).get_event_by_id(request.params["event_id"])
        if event is None:
            raise NotFoundError("unknown event", ErrorCode.INVALID_EVENT_ID)
        return event

    def get_event_by_alternate_id(request: Request):
        event = _events(request).get_event_by_alternate_id(
            request.params["alternate_id"])
        if event is None:
            raise NotFoundError("unknown event", ErrorCode.INVALID_EVENT_ID)
        return event

    router.get("/api/events/id/{event_id}", get_event_by_id, authority=REST)
    router.get("/api/events/alternate/{alternate_id}",
               get_event_by_alternate_id, authority=REST)

    # ------------------------------------------------------------------
    # Areas / area types / zones (reference: Areas.java, Zones.java)
    # ------------------------------------------------------------------
    def create_area_type(request: Request):
        return 201, _registry(request).create_area_type(
            entity_from_payload(AreaType, _body(request)))

    def create_area(request: Request):
        return 201, _registry(request).create_area(
            entity_from_payload(Area, _body(request)))

    def list_areas(request: Request):
        return results_to_jsonable(
            _registry(request).list_areas(request.criteria()))

    def get_area(request: Request):
        return _registry(request).get_area_by_token(request.params["token"])

    def create_zone(request: Request):
        registry = _registry(request)
        area = registry.get_area_by_token(request.params["token"])
        zone = entity_from_payload(Zone, _body(request))
        zone.area_id = area.id
        return 201, registry.create_zone(zone)

    def list_zones(request: Request):
        return results_to_jsonable(_registry(request).list_zones(
            area_token=request.params["token"]))

    def get_zone(request: Request):
        return _registry(request).get_zone_by_token(request.params["token"])

    def update_zone(request: Request):
        body = _body(request)
        if "bounds" in body:
            body["bounds"] = [Location(**b) for b in body["bounds"]]
        return _registry(request).update_zone(request.params["token"], body)

    def delete_zone(request: Request):
        return _registry(request).delete_zone(request.params["token"])

    router.post("/api/areatypes", create_area_type, authority=REST)
    router.post("/api/areas", create_area, authority=REST)
    router.get("/api/areas", list_areas, authority=REST)
    router.get("/api/areas/{token}", get_area, authority=REST)
    router.post("/api/areas/{token}/zones", create_zone, authority=REST)
    router.get("/api/areas/{token}/zones", list_zones, authority=REST)
    router.get("/api/zones/{token}", get_zone, authority=REST)
    router.put("/api/zones/{token}", update_zone, authority=REST)
    router.delete("/api/zones/{token}", delete_zone, authority=REST)

    # ------------------------------------------------------------------
    # Customers (reference: Customers.java)
    # ------------------------------------------------------------------
    def create_customer_type(request: Request):
        return 201, _registry(request).create_customer_type(
            entity_from_payload(CustomerType, _body(request)))

    def create_customer(request: Request):
        return 201, _registry(request).create_customer(
            entity_from_payload(Customer, _body(request)))

    def list_customers(request: Request):
        return results_to_jsonable(
            _registry(request).list_customers(request.criteria()))

    def get_customer(request: Request):
        return _registry(request).get_customer_by_token(
            request.params["token"])

    router.post("/api/customertypes", create_customer_type, authority=REST)
    router.post("/api/customers", create_customer, authority=REST)
    router.get("/api/customers", list_customers, authority=REST)
    router.get("/api/customers/{token}", get_customer, authority=REST)

    # ------------------------------------------------------------------
    # Device groups (reference: DeviceGroups.java)
    # ------------------------------------------------------------------
    def create_device_group(request: Request):
        return 201, _registry(request).create_device_group(
            entity_from_payload(DeviceGroup, _body(request)))

    def get_device_group(request: Request):
        return _registry(request).get_device_group_by_token(
            request.params["token"])

    def add_group_elements(request: Request):
        payloads = request.body
        if isinstance(payloads, dict):
            payloads = [payloads]
        if not isinstance(payloads, list):
            raise SiteWhereError("JSON element body required",
                                 http_status=400)
        elements = [entity_from_payload(DeviceGroupElement, p)
                    for p in payloads]
        return 201, {"elements": _registry(request).add_device_group_elements(
            request.params["token"], elements)}

    def list_group_elements(request: Request):
        return results_to_jsonable(_registry(request)
                                   .list_device_group_elements(
                                       request.params["token"]))

    def list_group_devices(request: Request):
        return {"devices": _registry(request).expand_group_devices(
            request.params["token"])}

    router.post("/api/devicegroups", create_device_group, authority=REST)
    router.get("/api/devicegroups/{token}", get_device_group, authority=REST)
    router.post("/api/devicegroups/{token}/elements", add_group_elements,
                authority=REST)
    router.get("/api/devicegroups/{token}/elements", list_group_elements,
               authority=REST)
    router.get("/api/devicegroups/{token}/devices", list_group_devices,
               authority=REST)

    # ------------------------------------------------------------------
    # Assets (reference: Assets.java, AssetTypes.java)
    # ------------------------------------------------------------------
    def _assets(request: Request):
        return _engine(request).asset_management

    def create_asset_type(request: Request):
        return 201, _assets(request).create_asset_type(
            entity_from_payload(AssetType, _body(request)))

    def list_asset_types(request: Request):
        return results_to_jsonable(
            _assets(request).list_asset_types(request.criteria()))

    def get_asset_type(request: Request):
        return _assets(request).get_asset_type_by_token(
            request.params["token"])

    def create_asset(request: Request):
        assets = _assets(request)
        body = _body(request)
        type_token = body.pop("asset_type_token", None)
        asset = entity_from_payload(Asset, body)
        if type_token and not asset.asset_type_id:
            asset.asset_type_id = assets.get_asset_type_by_token(type_token).id
        return 201, assets.create_asset(asset)

    def list_assets(request: Request):
        return results_to_jsonable(_assets(request).list_assets(
            asset_type_token=request.query_one("assetType"),
            criteria=request.criteria()))

    def get_asset(request: Request):
        return _assets(request).get_asset_by_token(request.params["token"])

    def update_asset(request: Request):
        return _assets(request).update_asset(request.params["token"],
                                             _body(request))

    def delete_asset(request: Request):
        return _assets(request).delete_asset(request.params["token"])

    router.post("/api/assettypes", create_asset_type, authority=REST)
    router.get("/api/assettypes", list_asset_types, authority=REST)
    router.get("/api/assettypes/{token}", get_asset_type, authority=REST)
    router.post("/api/assets", create_asset, authority=REST)
    router.get("/api/assets", list_assets, authority=REST)
    router.get("/api/assets/{token}", get_asset, authority=REST)
    router.put("/api/assets/{token}", update_asset, authority=REST)
    router.delete("/api/assets/{token}", delete_asset, authority=REST)

    # ------------------------------------------------------------------
    # Batch operations (reference: BatchOperations.java)
    # ------------------------------------------------------------------
    def list_batch_operations(request: Request):
        return results_to_jsonable(
            _engine(request).batch_management.list_batch_operations(
                request.criteria()))

    def get_batch_operation(request: Request):
        return _engine(request).batch_management.get_batch_operation_by_token(
            request.params["token"])

    def list_batch_elements(request: Request):
        return results_to_jsonable(
            _engine(request).batch_management.list_batch_elements(
                request.params["token"], request.criteria()))

    def create_batch_command_invocation(request: Request):
        from sitewhere_tpu_torch.batch.manager import \
            batch_command_invocation_request
        engine = _engine(request)
        body = _body(request)
        device_tokens = list(body.get("device_tokens", []))
        group_token = body.get("group_token")
        if group_token:
            device_tokens.extend(
                d.token for d in engine.registry.expand_group_devices(
                    group_token))
        operation = batch_command_invocation_request(
            command_token=body["command_token"],
            parameters=body.get("parameter_values", {}),
            device_tokens=device_tokens)
        operation = engine.batch_management.create_batch_operation(
            operation, engine.registry)
        engine.batch_manager.submit(operation)
        return 201, operation

    router.get("/api/batch", list_batch_operations, authority=REST)
    router.get("/api/batch/{token}", get_batch_operation, authority=REST)
    router.get("/api/batch/{token}/elements", list_batch_elements,
               authority=REST)
    router.post("/api/batch/command", create_batch_command_invocation,
                authority=REST)

    # ------------------------------------------------------------------
    # Schedules + jobs (reference: Schedules.java, ScheduledJobs.java)
    # ------------------------------------------------------------------
    ADMIN_SCHED = SiteWhereRoles.ADMINISTER_SCHEDULES

    def create_schedule(request: Request):
        return 201, _engine(request).schedule_management.create_schedule(
            entity_from_payload(Schedule, _body(request)))

    def list_schedules(request: Request):
        return results_to_jsonable(
            _engine(request).schedule_management.list_schedules(
                request.criteria()))

    def get_schedule(request: Request):
        return _engine(request).schedule_management.get_schedule_by_token(
            request.params["token"])

    def delete_schedule(request: Request):
        return _engine(request).schedule_management.delete_schedule(
            request.params["token"])

    def create_scheduled_job(request: Request):
        engine = _engine(request)
        job = entity_from_payload(ScheduledJob, _body(request))
        job = engine.schedule_management.create_scheduled_job(job)
        engine.schedule_manager.submit(job)
        return 201, job

    def list_scheduled_jobs(request: Request):
        return results_to_jsonable(
            _engine(request).schedule_management.list_scheduled_jobs(
                request.criteria()))

    def delete_scheduled_job(request: Request):
        engine = _engine(request)
        engine.schedule_manager.unschedule(request.params["token"])
        return engine.schedule_management.delete_scheduled_job(
            request.params["token"])

    router.post("/api/schedules", create_schedule, authority=ADMIN_SCHED)
    router.get("/api/schedules", list_schedules, authority=REST)
    router.get("/api/schedules/{token}", get_schedule, authority=REST)
    router.delete("/api/schedules/{token}", delete_schedule,
                  authority=ADMIN_SCHED)
    router.post("/api/jobs", create_scheduled_job, authority=ADMIN_SCHED)
    router.get("/api/jobs", list_scheduled_jobs, authority=REST)
    router.delete("/api/jobs/{token}", delete_scheduled_job,
                  authority=ADMIN_SCHED)

    # ------------------------------------------------------------------
    # Device streams (reference: Streams.java / service-streaming-media)
    # ------------------------------------------------------------------
    def create_device_stream(request: Request):
        body = _body(request)
        stream = _engine(request).streams.create_device_stream(
            request.params["token"], body["stream_id"],
            content_type=body.get("content_type",
                                  "application/octet-stream"))
        return 201, stream

    def list_device_streams(request: Request):
        return results_to_jsonable(_engine(request).streams
                                   .list_device_streams(
                                       request.params["token"],
                                       request.criteria()))

    def add_stream_data(request: Request):
        """Chunk upload: raw body bytes exactly as sent, sequence number in
        the path (JSON decoding must never touch chunk content)."""
        data = request.raw_body
        if not isinstance(data, bytes):
            raise SiteWhereError("binary body required", http_status=400)
        chunk = _engine(request).streams.add_stream_data(
            request.params["token"], request.params["stream_id"],
            int(request.params["sequence"]), data)
        return 201, {"id": chunk.id,
                     "sequence_number": chunk.sequence_number,
                     "size": len(data)}

    def get_stream_data(request: Request):
        streams = _engine(request).streams
        stream = streams.require_device_stream(request.params["token"],
                                               request.params["stream_id"])
        chunk = streams.get_stream_data(
            request.params["token"], request.params["stream_id"],
            int(request.params["sequence"]))
        if chunk is None:
            raise NotFoundError("unknown chunk", ErrorCode.INVALID_STREAM_ID)
        return 200, chunk.data, stream.content_type

    def get_stream_content(request: Request):
        streams = _engine(request).streams
        stream = streams.require_device_stream(request.params["token"],
                                               request.params["stream_id"])
        return 200, streams.reassemble(
            request.params["token"], request.params["stream_id"]), \
            stream.content_type

    router.post("/api/assignments/{token}/streams", create_device_stream,
                authority=REST)
    router.get("/api/assignments/{token}/streams", list_device_streams,
               authority=REST)
    router.post("/api/assignments/{token}/streams/{stream_id}/data/"
                "{sequence}", add_stream_data, authority=REST)
    router.get("/api/assignments/{token}/streams/{stream_id}/data/"
               "{sequence}", get_stream_data, authority=REST)
    router.get("/api/assignments/{token}/streams/{stream_id}/content",
               get_stream_content, authority=REST)

    # ------------------------------------------------------------------
    # Federated event search (reference: Search.java / service-event-search)
    # ------------------------------------------------------------------
    def list_search_providers(request: Request):
        return {"results": _engine(request).search_providers
                .list_providers()}

    def search_events(request: Request):
        from sitewhere_tpu_torch.search import SearchCriteriaSpec
        spec = SearchCriteriaSpec.from_query(request)
        return results_to_jsonable(_engine(request).search_providers.search(
            request.params["provider_id"], spec))

    def search_raw(request: Request):
        """Engine-native query passthrough for EXTERNAL providers
        (Search.java searchDeviceEvents raw mode /
        executeQueryWithRawResponse)."""
        provider = _engine(request).search_providers.get_provider(
            request.params["provider_id"])
        raw = getattr(provider, "raw_query", None)
        if raw is None:
            raise SiteWhereError(
                f"provider '{provider.provider_id}' does not support raw "
                f"queries", http_status=400)
        return raw(request.query_one("q") or "")

    router.get("/api/search", list_search_providers, authority=REST)
    router.get("/api/search/{provider_id}/events", search_events,
               authority=REST)
    router.get("/api/search/{provider_id}/raw", search_raw,
               authority=REST)

    # ------------------------------------------------------------------
    # Device state (reference: DeviceStates.java) — reads the TPU-resident
    # per-device state tensors through the pipeline engine.
    # ------------------------------------------------------------------
    def get_device_state(request: Request):
        engine = instance.pipeline_engine
        if engine is None:
            raise SiteWhereError("pipeline engine not enabled",
                                 http_status=503)
        state = engine.get_device_state(request.params["token"])
        if state is None:
            raise NotFoundError("no state for device",
                                ErrorCode.INVALID_DEVICE_TOKEN)
        return state

    router.get("/api/devicestates/{token}", get_device_state, authority=REST)
