"""Self-describing configuration metamodel.

The reference ships a machine-readable model of every microservice's
configuration surface — element roles, attributes, types, defaults — that the
admin UI renders into config editors and the server validates uploads
against (sitewhere-configuration: model/ConfigurationModelProvider.java,
per-service *ModelProvider + *Roles classes, 22 XSD namespaces).

This module is the TPU rebuild's equivalent over the layered JSON config
(runtime/config.py): each component contributes an `ElementModel` tree under
a role, the instance aggregates them into one JSON-able model, and
`validate_config` checks a configuration dict against it (types, required
attributes, unknown keys, choice constraints).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class AttributeType(str, enum.Enum):
    """Attribute datatypes (reference: configuration model AttributeType)."""

    STRING = "string"
    INTEGER = "integer"
    DECIMAL = "decimal"
    BOOLEAN = "boolean"
    SCRIPT = "script"          # name of a registered script
    DEVICE_TYPE_REF = "deviceTypeRef"
    ZONE_REF = "zoneRef"
    MEASUREMENT_REF = "measurementRef"


_PY_TYPES = {
    AttributeType.STRING: (str,),
    AttributeType.INTEGER: (int,),
    AttributeType.DECIMAL: (int, float),
    AttributeType.BOOLEAN: (bool,),
    AttributeType.SCRIPT: (str,),
    AttributeType.DEVICE_TYPE_REF: (str,),
    AttributeType.ZONE_REF: (str,),
    AttributeType.MEASUREMENT_REF: (str,),
}


@dataclass
class AttributeModel:
    """One configurable attribute (reference: AttributeNode)."""

    name: str
    type: AttributeType = AttributeType.STRING
    description: str = ""
    required: bool = False
    default: Any = None
    choices: Optional[List[Any]] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "type": self.type.value,
                               "required": self.required}
        if self.description:
            out["description"] = self.description
        if self.default is not None:
            out["default"] = self.default
        if self.choices:
            out["choices"] = list(self.choices)
        return out


@dataclass
class ElementModel:
    """One configurable element (reference: ElementNode): a named section of
    the config dict, with attributes and child elements."""

    name: str
    role: str
    description: str = ""
    attributes: List[AttributeModel] = field(default_factory=list)
    children: List["ElementModel"] = field(default_factory=list)
    multiple: bool = False      # element is a list of instances
    optional: bool = True

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "role": self.role,
            "description": self.description,
            "multiple": self.multiple,
            "optional": self.optional,
            "attributes": [a.to_json() for a in self.attributes],
            "children": [c.to_json() for c in self.children],
        }


def _attr(name, type=AttributeType.STRING, required=False, default=None,
          choices=None, description=""):
    return AttributeModel(name=name, type=type, required=required,
                          default=default, choices=choices,
                          description=description)


_I, _D, _B = AttributeType.INTEGER, AttributeType.DECIMAL, AttributeType.BOOLEAN


def pipeline_model() -> ElementModel:
    """Fused TPU pipeline engine (pipeline/engine.py ctor surface)."""
    return ElementModel(
        name="pipeline", role="pipeline",
        description="Fused TPU hot-path engine",
        attributes=[
            _attr("device", default="cuda",
                  description="the engine's torch device: cuda (or "
                              "cuda:N) on the card, cpu only when asked "
                              "for; without CUDA, cuda refuses to boot"),
            _attr("batch_size", _I, default=8192),
            _attr("mode", choices=["throughput", "latency"],
                  default="throughput",
                  description="throughput: full batches via the pipelined "
                              "feeder; latency: the engine boots at "
                              "latency_batch_size and ingest flushes "
                              "adaptively (fill or linger_ms) for a p99 "
                              "ingest->alert budget"),
            _attr("latency_batch_size", _I, default=4096),
            _attr("linger_ms", _D, default=2.0,
                  description="latency mode: max ms an offered event "
                              "waits before a partial batch flushes"),
            _attr("measurement_slots", _I, default=32),
            _attr("max_tenants", _I, default=16),
            _attr("max_threshold_rules", _I, default=256),
            _attr("max_geofence_rules", _I, default=256),
            _attr("presence_missing_interval_ms", _I,
                  default=8 * 60 * 60 * 1000,
                  description="DevicePresenceManager missing interval"),
            _attr("geofence_impl", choices=["auto", "xla", "pallas",
                                            "pallas_interpret"],
                  default="auto"),
            _attr("shards", _I, default=1,
                  description="mesh size for ShardedPipelineEngine"),
            _attr("device_routing", choices=["auto", "on", "off"],
                  default="auto",
                  description="on-device shard routing (radix bucket + "
                              "ICI all_to_all in the fused step) instead "
                              "of the host arena router; auto = on for "
                              "multi-shard single-controller meshes"),
            _attr("h2d_buffer_depth", _I, default=3,
                  description="on-device H2D staging-ring depth "
                              "(pipeline/staging.py): how many host->"
                              "device transfers may be in flight so "
                              "batch N+1's transfer overlaps batch N's "
                              "compute; 1 = serial transfers (the "
                              "differential baseline), 2-3 typical — "
                              "see docs/PERF.md"),
        ])


def event_sources_model() -> ElementModel:
    receiver_children = [
        ElementModel(
            name="mqtt", role="event-source-receiver", multiple=True,
            description="In-proc MQTT subscription receiver",
            attributes=[_attr("topic", required=True),
                        _attr("qos", _I, default=0)]),
        ElementModel(
            name="socket", role="event-source-receiver", multiple=True,
            attributes=[_attr("port", _I, required=True),
                        _attr("host", default="0.0.0.0")]),
        ElementModel(
            name="http", role="event-source-receiver", multiple=True,
            attributes=[_attr("port", _I, required=True),
                        _attr("path", default="/events")]),
        ElementModel(
            name="coap", role="event-source-receiver", multiple=True,
            attributes=[_attr("port", _I, required=True)]),
        ElementModel(
            name="websocket", role="event-source-receiver", multiple=True,
            attributes=[_attr("url", required=True)]),
        ElementModel(
            name="stomp_broker", role="event-source-receiver",
            multiple=True,
            description="EMBEDDED STOMP broker (the "
                        "ActiveMQBrokerEventReceiver slot): hosts the "
                        "broker in-process and consumes a destination",
            attributes=[_attr("port", _I, default=0),
                        _attr("host", default="127.0.0.1"),
                        _attr("destination",
                              default="/queue/sitewhere")]),
    ]
    decoder = ElementModel(
        name="decoder", role="event-source-decoder", optional=False,
        attributes=[
            _attr("type", required=True,
                  choices=["wire", "protobuf", "json-batch", "json-request",
                           "scripted", "composite"]),
            _attr("script", AttributeType.SCRIPT,
                  description="for type=scripted"),
        ])
    dedup = ElementModel(
        name="deduplicator", role="event-source-deduplicator",
        attributes=[_attr("type", choices=["alternate-id", "scripted"]),
                    _attr("script", AttributeType.SCRIPT)])
    return ElementModel(
        name="event_sources", role="event-sources", multiple=True,
        description="Inbound event sources (receivers + decoder + dedup)",
        attributes=[_attr("source_id", required=True),
                    _attr("bulk", _B, default=False,
                          description="use the bulk wire-ingest lane")],
        children=receiver_children + [decoder, dedup])


def event_management_model() -> ElementModel:
    # per-tenant store choice — the reference's DatastoreConfigurationParser
    # role (persist/datastore.py): a tenant either shares the instance log
    # or gets a dedicated columnar/memory store
    tenant_datastore = ElementModel(
        name="tenant_datastore", role="tenant-datastore", multiple=True,
        description="Dedicated event store for one tenant",
        attributes=[
            _attr("tenant", required=True),
            _attr("kind", choices=["columnar", "memory", "widerow"],
                  default="columnar",
                  description="columnar scan log, in-memory log, or the "
                              "wide-row ACID store (the HBase/Cassandra "
                              "historical-store role)"),
            _attr("data_dir",
                  description="spill dir / db path (relative = under "
                              "instance dir)"),
            _attr("segment_rows", _I, default=65536),
            _attr("linger_ms", _I, default=250),
            _attr("spill", _B, default=True),
            _attr("bucket_ms", _I, default=3_600_000,
                  description="widerow time-bucket width (retention "
                              "prunes whole buckets)"),
        ])
    return ElementModel(
        name="event_management", role="event-management",
        description="Columnar event log + indices",
        attributes=[
            _attr("data_dir", description="parquet spill directory"),
            _attr("segment_rows", _I, default=65536),
            _attr("spill", _B, default=True),
        ],
        children=[tenant_datastore])


def device_state_model() -> ElementModel:
    return ElementModel(
        name="device_state", role="device-state",
        attributes=[
            _attr("presence_missing_interval_ms", _I,
                  default=8 * 60 * 60 * 1000),
            _attr("presence_check_interval_ms", _I, default=10 * 60 * 1000),
        ])


def rule_processing_model() -> ElementModel:
    return ElementModel(
        name="rules", role="rule-processing", multiple=True,
        description="Threshold + geofence rule definitions",
        attributes=[_attr("token", required=True),
                    _attr("type", required=True,
                          choices=["threshold", "geofence", "scripted"]),
                    _attr("measurement_name", AttributeType.MEASUREMENT_REF),
                    _attr("operator",
                          choices=[">", ">=", "<", "<=", "==", "!="]),
                    _attr("threshold", _D),
                    _attr("zone_token", AttributeType.ZONE_REF),
                    _attr("condition", choices=["inside", "outside"]),
                    _attr("alert_level", _I),
                    _attr("alert_type"),
                    _attr("script", AttributeType.SCRIPT)])


def outbound_connectors_model() -> ElementModel:
    return ElementModel(
        name="outbound_connectors", role="outbound-connectors", multiple=True,
        attributes=[_attr("connector_id", required=True),
                    _attr("type", required=True,
                          choices=["mqtt", "http-post", "event-index",
                                   "scripted", "collecting"]),
                    _attr("topic"), _attr("url"),
                    _attr("num_threads", _I, default=1)],
        children=[ElementModel(
            name="filters", role="outbound-connector-filter", multiple=True,
            attributes=[_attr("type", required=True,
                              choices=["device-type", "area", "scripted"]),
                        _attr("token"), _attr("operation",
                                              choices=["include", "exclude"]),
                        _attr("script", AttributeType.SCRIPT)])])


def command_delivery_model() -> ElementModel:
    return ElementModel(
        name="command_delivery", role="command-delivery",
        children=[
            ElementModel(
                name="router", role="command-router",
                attributes=[_attr("type", default="device-type-mapping",
                                  choices=["device-type-mapping",
                                           "single-destination"])]),
            ElementModel(
                name="destinations", role="command-destination",
                multiple=True,
                attributes=[_attr("destination_id", required=True),
                            _attr("type", required=True,
                                  choices=["mqtt", "coap", "sms", "inproc"]),
                            _attr("topic_prefix"),
                            _attr("sms_from_number",
                                  description="for type=sms"),
                            _attr("device_type",
                                  AttributeType.DEVICE_TYPE_REF)]),
        ])


def registration_model() -> ElementModel:
    return ElementModel(
        name="registration", role="device-registration",
        attributes=[
            _attr("allow_new_devices", _B, default=True),
            _attr("auto_assign", _B, default=True),
            _attr("default_device_type", AttributeType.DEVICE_TYPE_REF),
        ])


def batch_operations_model() -> ElementModel:
    return ElementModel(
        name="batch_operations", role="batch-operations",
        attributes=[_attr("throttle_delay_ms", _I, default=0),
                    _attr("num_threads", _I, default=2)])


def schedule_model() -> ElementModel:
    return ElementModel(
        name="schedules", role="schedule-management",
        attributes=[_attr("tick_interval_s", _D, default=1.0)])


def label_generation_model() -> ElementModel:
    return ElementModel(
        name="labels", role="label-generation", multiple=True,
        attributes=[_attr("generator_id", default="qrcode"),
                    _attr("scale", _I, default=8),
                    _attr("border", _I, default=4),
                    _attr("ec_level", choices=["L", "M", "Q", "H"],
                          default="M")])


def web_rest_model() -> ElementModel:
    return ElementModel(
        name="web", role="web-rest",
        attributes=[_attr("port", _I, default=8080),
                    _attr("jwt_expiration_s", _I, default=3600)])


def analytics_model() -> ElementModel:
    return ElementModel(
        name="analytics", role="analytics",
        attributes=[_attr("window_ms", _I, default=60_000),
                    _attr("slide_ms", _I, default=10_000)])


def event_search_model() -> ElementModel:
    return ElementModel(
        name="search_providers", role="event-search", multiple=True,
        description="Federated event-search providers (the in-process "
                    "columnar provider is always registered; type=http "
                    "adds an external engine, the SolrSearchProvider "
                    "role)",
        attributes=[_attr("provider_id", required=True),
                    _attr("type", required=True,
                          choices=["http"]),
                    _attr("base_url", required=True),
                    _attr("name"),
                    _attr("timeout_s", _D, default=10.0),
                    _attr("tenant")])


def telemetry_model() -> ElementModel:
    return ElementModel(
        name="telemetry", role="instance-telemetry",
        description="Opt-in usage telemetry (the MicroserviceAnalytics "
                    "role): lifecycle Started/Uptime/Stopped events "
                    "POSTed to the OPERATOR'S endpoint; off by default, "
                    "no third-party service, lifecycle metadata only",
        attributes=[_attr("enabled", _B, default=False),
                    _attr("endpoint",
                          description="HTTP(S) URL receiving the JSON "
                                      "events (required when enabled)"),
                    _attr("interval_s", _D, default=3600.0)])


def observability_model() -> ElementModel:
    return ElementModel(
        name="observability", role="instance-observability",
        description="Tracing + event-age telemetry knobs (the flight "
                    "recorder and metrics registry are always on; this "
                    "controls the optional extras)",
        attributes=[
            _attr("trace_sample_n", _I, default=0,
                  description="sample 1-in-N ingest deliveries with a "
                              "journey span that propagates over busnet "
                              "(W3C traceparent); 0 disables sampling"),
        ])


def faults_model() -> ElementModel:
    """Deterministic fault injection + ingest admission (runtime/faults.py,
    sources/manager.py AdmissionController; docs/OPERATIONS.md
    "Fault drills")."""
    rule = ElementModel(
        name="rules", role="fault-rule", multiple=True,
        description="One fault-point schedule entry",
        attributes=[
            _attr("point", required=True,
                  description="fault point name (runtime/faults.py "
                              "FAULT_POINTS)"),
            _attr("p", _D, default=1.0,
                  description="per-hit firing probability (seeded RNG)"),
            _attr("times", _I,
                  description="stop after this many firings"),
            _attr("after", _I, default=0,
                  description="skip the first N hits"),
            _attr("delay_s", _D, default=0.0,
                  description="stall instead of raising (delay points)"),
            _attr("duration_s", _D, default=0.0,
                  description="window mode: keep firing for this long "
                              "after the first firing"),
        ])
    return ElementModel(
        name="faults", role="fault-injection",
        description="Seeded fault drills + overload admission control",
        attributes=[
            _attr("allow_drills", _B, default=False,
                  description="enable POST /api/instance/faults (403 "
                              "otherwise)"),
            _attr("seed", _I, default=0,
                  description="seed for the boot-armed fault plan"),
            _attr("admission_step_budget_ms", _D,
                  description="shed ingest when mean step sync cost "
                              "exceeds this (flight rollups)"),
            _attr("admission_queue_depth_budget", _I,
                  description="shed ingest when decoded-events backlog "
                              "exceeds this"),
        ],
        children=[rule])


def feeders_model() -> ElementModel:
    """Disaggregated feeder fleet (feeders/; docs/FEEDERS.md): remote
    workers own TTL-leased source partitions, decode+intern+pack locally,
    and ship ready-to-stage wire blobs to the mesh host's bus edge."""
    return ElementModel(
        name="feeders", role="feeder-fleet",
        description="Disaggregated input feeders: lease-owned partition "
                    "decode/pack off the mesh host, blob handoff over "
                    "busnet with exactly-once takeover replay",
        attributes=[
            _attr("enabled", _B, default=False,
                  description="mount the feeder_* ops on the bus edge "
                              "(requires bus.edge_port)"),
            _attr("frames_topic",
                  description="raw wire-frame topic feeders consume "
                              "(default: the instance feeder-frames "
                              "topic)"),
            _attr("lease_ttl_s", _D, default=5.0,
                  description="partition lease TTL; a worker renews at "
                              "TTL/3 and a lapsed lease is stealable at "
                              "a higher epoch"),
            _attr("connect",
                  description="worker mode: mesh host bus edge "
                              "host:port (serve --feeder)"),
            _attr("name",
                  description="worker identity for leases (default "
                              "host:pid)"),
            _attr("partitions",
                  description="worker mode: csv partition pin, e.g. "
                              "'0,1'; unset leases every partition"),
            _attr("poll_max_records", _I, default=4096),
            _attr("shed_backoff_s", _D, default=0.25,
                  description="worker backoff after a propagated "
                              "admission shed (structured 429)"),
        ])


def _all_elements() -> List[ElementModel]:
    """Every subsystem's element model — the single source both the UI model
    and the validator consume."""
    return [
        pipeline_model(), event_sources_model(), event_management_model(),
        device_state_model(), rule_processing_model(),
        outbound_connectors_model(), command_delivery_model(),
        registration_model(), batch_operations_model(), schedule_model(),
        label_generation_model(), web_rest_model(), analytics_model(),
        event_search_model(), telemetry_model(), observability_model(),
        faults_model(), feeders_model(),
    ]


def instance_configuration_model() -> Dict[str, Any]:
    """The aggregated, JSON-able model for the whole instance — what the
    admin UI fetches (reference: instance-wide configuration model
    aggregation of every microservice's *ModelProvider)."""
    elements = _all_elements()
    return {
        "modelVersion": 1,
        "elements": [e.to_json() for e in elements],
        "roles": sorted({r for e in elements for r in _roles_of(e)}),
    }


def _roles_of(element: ElementModel) -> List[str]:
    out = [element.role]
    for child in element.children:
        out.extend(_roles_of(child))
    return out


# -- validation ---------------------------------------------------------------

@dataclass
class ValidationIssue:
    path: str
    message: str

    def to_json(self) -> Dict[str, str]:
        return {"path": self.path, "message": self.message}


def _validate_element(cfg: Any, model: ElementModel, path: str,
                      issues: List[ValidationIssue]) -> None:
    if model.multiple:
        if not isinstance(cfg, list):
            issues.append(ValidationIssue(path, "expected a list"))
            return
        for i, item in enumerate(cfg):
            _validate_single(item, model, f"{path}[{i}]", issues)
    else:
        _validate_single(cfg, model, path, issues)


def _validate_single(cfg: Any, model: ElementModel, path: str,
                     issues: List[ValidationIssue]) -> None:
    if not isinstance(cfg, dict):
        issues.append(ValidationIssue(path, "expected an object"))
        return
    attrs = {a.name: a for a in model.attributes}
    children = {c.name: c for c in model.children}
    for key, value in cfg.items():
        if key in attrs:
            a = attrs[key]
            ok_types = _PY_TYPES[a.type]
            if a.type is not AttributeType.BOOLEAN \
                    and isinstance(value, bool):
                issues.append(ValidationIssue(
                    f"{path}.{key}", f"expected {a.type.value}, got boolean"))
            elif not isinstance(value, ok_types):
                issues.append(ValidationIssue(
                    f"{path}.{key}",
                    f"expected {a.type.value}, got {type(value).__name__}"))
            elif a.choices and value not in a.choices:
                issues.append(ValidationIssue(
                    f"{path}.{key}",
                    f"value {value!r} not one of {a.choices}"))
        elif key in children:
            _validate_element(value, children[key], f"{path}.{key}", issues)
        else:
            issues.append(ValidationIssue(f"{path}.{key}",
                                          "unknown configuration key"))
    for a in attrs.values():
        if a.required and a.name not in cfg:
            issues.append(ValidationIssue(
                f"{path}.{a.name}", "required attribute missing"))
    for c in children.values():
        if not c.optional and c.name not in cfg:
            issues.append(ValidationIssue(
                f"{path}.{c.name}", "required element missing"))


def validate_config(config: Dict[str, Any],
                    _allow_tenants: bool = True) -> List[ValidationIssue]:
    """Validate a configuration dict against the instance model. Top-level
    keys that no element claims are reported as unknown. A top-level
    `tenants.<id>` overlay revalidates recursively — but only one level
    deep, matching what runtime/config.py actually consumes (a nested
    tenants block inside an overlay is dead config and is flagged)."""
    elements = {e.name: e for e in _all_elements()}
    issues: List[ValidationIssue] = []
    for key, value in config.items():
        if key == "tenants" and _allow_tenants:
            if not isinstance(value, dict):
                issues.append(ValidationIssue("tenants", "expected an object"))
                continue
            for tenant, overlay in value.items():
                if isinstance(overlay, dict):
                    issues.extend(
                        _prefixed(validate_config(overlay,
                                                  _allow_tenants=False),
                                  f"tenants.{tenant}"))
                else:
                    issues.append(ValidationIssue(
                        f"tenants.{tenant}", "expected an object"))
        elif key in elements:
            _validate_element(value, elements[key], key, issues)
        else:
            issues.append(ValidationIssue(key, "unknown configuration key"))
    return issues


def _prefixed(issues: List[ValidationIssue],
              prefix: str) -> List[ValidationIssue]:
    return [ValidationIssue(f"{prefix}.{i.path}", i.message) for i in issues]
