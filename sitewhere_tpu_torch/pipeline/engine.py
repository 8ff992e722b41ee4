"""PipelineEngine: host orchestrator of the step on the card.

Counterpart of `sitewhere_tpu/pipeline/engine.py` `PipelineEngine` (a
LifecycleComponent, as the reference's is): rule CRUD and the rule-table
compilers, the CRUD of rule programs, anomaly models and actuation policies
with their state groups (sized to a [D, 1, ...] placeholder while a family
is empty), the params refresh on registry or rule version change, submit /
submit_blob / submit_routed, the H2D staging ring (`stage_blob`), alert
and command materialization from the device-compacted lanes (one host copy
per step), the presence sweep and state reads; and the host runtime the
reference reports through: flight records per step, the step-path
histograms and counters under the reference's metric names, fault points
with bounded retries around H2D, dispatch and lane fetch, and the
engine's health ladder.

On the card each static configuration's step is one captured CUDA graph
(pipeline/graph.py): the first step of a key runs eagerly and is kept, the
capture follows, later steps replay. The state groups and params are
engine-owned buffers that every step and every load updates IN PLACE —
never rebind `_state`, a group or `_params` on the card: a graph would keep
reading the old buffers. A path that must reallocate drops the graphs.

Not in this slice (the feeder fleet, the command dispatcher, the
rule/model/policy stores, checkpoints) — see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.actuation.compiler import (
    MAX_POLICY_BUCKET, compile_policy_into, empty_policy_table)
from sitewhere_tpu_torch.actuation.compiler import \
    dry_run_compile as dry_run_policy
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.errors import (
    DuplicateTokenError, ErrorCode, SiteWhereError)
from sitewhere_tpu_torch.ml.compiler import (
    MAX_MODEL_BUCKET, compile_model_into, empty_model_table)
from sitewhere_tpu_torch.ml.compiler import dry_run_compile as dry_run_model
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert)
from sitewhere_tpu_torch.model.state import DeviceState, PresenceState
from sitewhere_tpu_torch.ops.actuate import (
    DEFAULT_COMMAND_LANE_CAPACITY, MIN_COMMAND_LANE_CAPACITY,
    decode_command_lanes, init_actuation_state)
from sitewhere_tpu_torch.ops.anomaly import init_model_state
from sitewhere_tpu_torch.ops.compact import (
    DEFAULT_ALERT_LANE_CAPACITY, MIN_ALERT_LANE_CAPACITY, decode_alert_lanes)
from sitewhere_tpu_torch.ops.geofence import (
    GEOFENCE_IMPLS, GeofenceCondition, GeofenceRuleTable, ZoneTable,
    empty_geofence_table)
from sitewhere_tpu_torch.ops.pack import (
    WIRE_ROWS, EventBatch, EventPacker, batch_to_blob, blob_to_batch)
from sitewhere_tpu_torch.ops.slab import state_slab_lanes
from sitewhere_tpu_torch.ops.stateful import init_rule_state
from sitewhere_tpu_torch.ops.threshold import (
    ThresholdOp, ThresholdRuleTable, empty_threshold_table)
from sitewhere_tpu_torch.pipeline.graph import (
    capture_step, commit, same_layout, step_key)
from sitewhere_tpu_torch.pipeline.staging import StagedBlob, StagingRing
from sitewhere_tpu_torch.pipeline.state_tensors import (
    DeviceStateTensors, init_device_state)
from sitewhere_tpu_torch.pipeline.step import (
    PipelineParams, ProcessOutputs, check_presence, process_batch)
from sitewhere_tpu_torch.registry.interning import TokenInterner
from sitewhere_tpu_torch.registry.tensors import RegistryTensors
from sitewhere_tpu_torch.rules.compiler import (
    MAX_PROGRAM_BUCKET, compile_program_into, empty_program_table)
from sitewhere_tpu_torch.rules.compiler import \
    dry_run_compile as dry_run_program
from sitewhere_tpu_torch.runtime.eventage import (
    age_histogram, observe_summary)
from sitewhere_tpu_torch.runtime.faults import fault_point, jittered
from sitewhere_tpu_torch.runtime.flight import GLOBAL_FLIGHT
from sitewhere_tpu_torch.runtime.health import EngineHealth
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import GLOBAL_METRICS
from sitewhere_tpu_torch.tree import to_device, tree_map

_NEG = -(2 ** 31)
_ALERT_LEVELS = {int(level): level for level in AlertLevel}
# each state group's second per-slot counter, beside fire_count
_SECOND_COUNTER = {"rule": "suppress_count", "model": "eval_count",
                   "actuation": "debounce_count"}
_log = logging.getLogger("sitewhere.pipeline")
# pinned host staging buffers of the blob ring (see _staging_blob_buffer)
_BLOB_RING_SLOTS = 6


def record_event(device: torch.device):
    """A CUDA event recorded on `device`'s current stream: ready once the
    work queued there so far is done. None on the CPU (always ready)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


@dataclasses.dataclass
class ThresholdRule:
    """Host-side rule definition; compiled into ThresholdRuleTable rows."""

    token: str
    measurement_name: str = ""       # "" = any
    operator: str = ">"
    threshold: float = 0.0
    alert_type: str = "threshold.violation"
    alert_level: AlertLevel = AlertLevel.WARNING
    alert_message: str = ""
    tenant_token: str = ""           # "" = any
    device_type_token: str = ""      # "" = any
    active: bool = True


@dataclasses.dataclass
class GeofenceRule:
    """Host-side geofence rule: zone token + containment condition + the
    alert to fire."""

    token: str
    zone_token: str = ""
    condition: str = "outside"       # fire when point is inside|outside
    alert_type: str = "zone.violation"
    alert_level: AlertLevel = AlertLevel.ERROR
    alert_message: str = ""
    active: bool = True


def rule_to_dict(kind: str, rule) -> Dict:
    """Wire/REST form of a rule: plain JSON types plus a `type` tag."""
    data = dataclasses.asdict(rule)
    data["alert_level"] = int(rule.alert_level)
    data["type"] = kind
    return data


def rule_from_dict(data: Dict):
    """(kind, rule) from the wire/REST form, validated and type-coerced so
    that a rule that passes compiles into the rule tables. Raises
    SiteWhereError on bad input."""
    kind = data.get("type")
    token = data.get("token") or ""
    if not token or not isinstance(token, str):
        raise SiteWhereError("rule requires a string token",
                             ErrorCode.GENERIC)

    def fields_for(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        out = {k: v for k, v in data.items() if k in names and v is not None}
        try:
            if "threshold" in out:
                out["threshold"] = float(out["threshold"])
            if "active" in out:
                out["active"] = bool(out["active"])
            if "alert_level" in out:
                level = out["alert_level"]
                out["alert_level"] = (AlertLevel[level]
                                      if isinstance(level, str)
                                      and not level.lstrip("-").isdigit()
                                      else AlertLevel(int(level)))
        except (KeyError, ValueError, TypeError) as exc:
            raise SiteWhereError(f"invalid rule field value: {exc}",
                                 ErrorCode.GENERIC)
        for name, value in out.items():
            if name not in ("threshold", "active", "alert_level") \
                    and not isinstance(value, str):
                raise SiteWhereError(
                    f"rule field '{name}' must be a string",
                    ErrorCode.GENERIC)
        return out

    if kind == "threshold":
        rule = ThresholdRule(**fields_for(ThresholdRule))
        if rule.operator not in ThresholdOp.BY_NAME:
            raise SiteWhereError(
                f"unknown operator {rule.operator!r} (one of "
                f"{sorted(ThresholdOp.BY_NAME)})", ErrorCode.GENERIC)
        return kind, rule
    if kind == "geofence":
        rule = GeofenceRule(**fields_for(GeofenceRule))
        if rule.condition not in ("inside", "outside"):
            raise SiteWhereError(
                f"geofence condition must be inside|outside, got "
                f"{rule.condition!r}", ErrorCode.GENERIC)
        if not rule.zone_token:
            raise SiteWhereError("geofence rule requires zone_token",
                                 ErrorCode.GENERIC)
        return kind, rule
    raise SiteWhereError(
        f"unknown rule type {kind!r} (threshold|geofence)",
        ErrorCode.GENERIC)


class PipelineEngine(LifecycleComponent):
    """One engine per process; multi-tenant by construction (the tenant is
    a tensor column, not a separate engine). Runs on `device` ("cuda"
    unless the caller asks for the CPU; raises without a CUDA device)."""

    def __init__(self, registry_tensors: RegistryTensors,
                 batch_size: int = 8192, measurement_slots: int = 32,
                 max_tenants: int = 16, max_threshold_rules: int = 256,
                 max_geofence_rules: int = 256,
                 presence_missing_interval_ms: int = 8 * 60 * 60 * 1000,
                 name: str = "pipeline-engine",
                 geofence_impl: str = "auto",
                 alert_lane_capacity: Optional[int] = None,
                 max_rule_programs: int = 32,
                 rule_program_nodes: int = 16,
                 rule_program_state_slots: int = 8,
                 max_anomaly_models: int = 8,
                 anomaly_model_features: int = 4,
                 anomaly_model_layers: int = 2,
                 anomaly_model_width: int = 8,
                 h2d_buffer_depth: int = 3,
                 max_actuation_policies: int = 8,
                 command_lane_capacity: Optional[int] = None,
                 max_command_tokens: int = 1024,
                 device: DeviceLike = "cuda"):
        super().__init__(name)
        self.device = resolve_device(device)
        self.registry = registry_tensors
        self.batch_size = batch_size
        self.max_tenants = max_tenants
        self.measurement_slots = measurement_slots
        self.max_threshold_rules = max_threshold_rules
        self.max_geofence_rules = max_geofence_rules
        # rule ids travel in int16 halves of the alert-lane rules row
        if max(max_threshold_rules, max_geofence_rules) >= (1 << 15):
            raise ValueError("rule table capacity must be < 32768 "
                             "(alert-lane rule-id field width)")
        # rule-program slot ids travel in 8 alert-lane meta bits
        if not (0 < max_rule_programs <= MAX_PROGRAM_BUCKET):
            raise ValueError(
                f"max_rule_programs must be in 1..{MAX_PROGRAM_BUCKET} "
                f"(alert-lane program-id field width)")
        self.max_rule_programs = max_rule_programs
        self.rule_program_nodes = rule_program_nodes
        self.rule_program_state_slots = rule_program_state_slots
        # anomaly-model slot ids travel in 8 alert-lane meta bits
        if not (0 < max_anomaly_models <= MAX_MODEL_BUCKET):
            raise ValueError(
                f"max_anomaly_models must be in 1..{MAX_MODEL_BUCKET} "
                f"(alert-lane model-id field width)")
        if anomaly_model_features > anomaly_model_width:
            raise ValueError(
                "anomaly_model_features must be <= anomaly_model_width "
                "(features embed in the activation vector)")
        self.max_anomaly_models = max_anomaly_models
        self.anomaly_model_features = anomaly_model_features
        self.anomaly_model_layers = anomaly_model_layers
        self.anomaly_model_width = anomaly_model_width
        # actuation-policy slot ids travel in 8 command-lane meta bits
        if not (0 < max_actuation_policies <= MAX_POLICY_BUCKET):
            raise ValueError(
                f"max_actuation_policies must be in 1..{MAX_POLICY_BUCKET} "
                f"(command-lane policy-id field width)")
        self.max_actuation_policies = max_actuation_policies
        self.command_lane_capacity = (
            command_lane_capacity if command_lane_capacity is not None
            else DEFAULT_COMMAND_LANE_CAPACITY)
        if self.command_lane_capacity < MIN_COMMAND_LANE_CAPACITY:
            raise ValueError(
                f"command_lane_capacity must be >= "
                f"{MIN_COMMAND_LANE_CAPACITY}")
        # command tokens the command lanes resolve back through
        self.commands = TokenInterner(max_command_tokens, "commands")
        self.alert_lane_capacity = (alert_lane_capacity
                                    if alert_lane_capacity is not None
                                    else DEFAULT_ALERT_LANE_CAPACITY)
        if self.alert_lane_capacity < MIN_ALERT_LANE_CAPACITY:
            raise ValueError(
                f"alert_lane_capacity must be >= {MIN_ALERT_LANE_CAPACITY}")
        if geofence_impl not in GEOFENCE_IMPLS:
            raise ValueError(f"geofence_impl {geofence_impl!r}: expected "
                             f"one of {GEOFENCE_IMPLS}")
        self.geofence_impl = geofence_impl
        self.presence_missing_interval_ms = presence_missing_interval_ms
        self.packer = EventPacker(batch_size, registry_tensors.devices)

        self._threshold_rules: List[ThresholdRule] = []
        self._geofence_rules: List[GeofenceRule] = []
        # rule programs, anomaly models, actuation policies: token ->
        # {"slot", "epoch", "spec"}, with stable slots (lowest free slot on
        # install) because per-device state is keyed by slot; a new epoch
        # per install makes a recycled slot's state reset inside the step
        self._rule_programs: Dict[str, Dict] = {}
        self._anomaly_models: Dict[str, Dict] = {}
        self._actuation_policies: Dict[str, Dict] = {}
        self._epochs = {"program": 0, "model": 0, "policy": 0}
        # node slots the compiled program table uses (the node-pass trim)
        self._program_nodes_in_use = 0
        # the stateful groups and the dims each was built for
        self._rule_state = self._model_state = self._actuation_state = None
        self._built_dims: Dict[str, Tuple[int, ...]] = {}
        # command fan-out: with no dispatcher attached, fires park on the
        # pending list and drain via take_command_fires()
        self.command_dispatcher = None
        self._pending_commands: List[Dict] = []
        self.commands_fired = 0
        self.commands_debounced = 0
        self.commands_dropped = 0
        self._rules_version = 0
        self._params_built_for: Tuple[int, int] = (-1, -1)
        self._params: Optional[PipelineParams] = None
        self._state: Optional[DeviceStateTensors] = None
        # rule mutation and the params compile
        self._lock = threading.RLock()
        # state advance (submit / presence) against state reads and swaps
        # from other threads
        self._state_lock = threading.RLock()
        self.batches_processed = 0
        # bounded materialization (max_alerts) AND alert-lane overflow
        # (> capacity fired rows in one step) both count here
        self.alerts_dropped = 0
        # device->host materialization accounting: both lanes (alert +
        # command) count as the reference's two fetches, though they come
        # back in one host copy
        self.d2h_fetches = 0
        self.d2h_bytes = 0
        self._metrics = GLOBAL_METRICS.scoped(f"pipeline.{name}")
        # step flight recorder: one record per step; feeders pass records
        # they opened on stager threads via submit_blob(flight_rec=...)
        self.flight = GLOBAL_FLIGHT
        self._flight_last = None
        self._flight_step_n = 0
        self._flight_sample_every = 16
        self._stage_hist = GLOBAL_METRICS.histogram(
            "pipeline.step_stage_seconds")
        # per-tenant event volume, sampled every Nth step
        self._tenant_hist = GLOBAL_METRICS.histogram(
            "pipeline.step_tenant_events",
            buckets=(1.0, 8.0, 64.0, 512.0, 4096.0, 32768.0))
        # ingest->effect event-age histogram; materialize closes the
        # sidecar a submit carried in
        self._age_hist = age_histogram(GLOBAL_METRICS)
        # pinned host staging buffers for full-size blobs (card only):
        # _blob_ring_guards[i] is the event that proves slot i's last H2D
        # copy finished reading it
        self._blob_ring: Optional[List[np.ndarray]] = None
        self._blob_ring_pinned: Optional[List[torch.Tensor]] = None
        self._blob_ring_guards: Optional[list] = None
        self._blob_ring_pos = 0
        self._blob_ring_lock = threading.Lock()
        # the H2D staging ring: every staged transfer takes a slot, so at
        # most `h2d_buffer_depth` are in flight; built at first use
        if not (1 <= int(h2d_buffer_depth) <= 8):
            raise ValueError("h2d_buffer_depth must be in 1..8")
        self.h2d_buffer_depth = int(h2d_buffer_depth)
        self._staging_ring: Optional[StagingRing] = None
        self._staging_ring_lock = threading.Lock()
        # staged H2D copies run on this side stream (card only)
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # transient H2D / dispatch / lane-fetch failures retry with
        # backoff and jitter (step_retries attempts past the first); the
        # health ladder tracks healthy -> degraded -> draining -> failed
        self.step_retries = 2
        self.health = EngineHealth(name, metrics=self._metrics)
        self._retry_counter = self._metrics.counter("step_retries")
        # captured steps (card only): step_key -> CapturedStep. A capture
        # counts on graph_captures; each replay adds its graph's kernel
        # launches to graph_kernel_launches
        self._graphs: Dict[Tuple, object] = {}
        self._failed_captures: Dict[Tuple, str] = {}
        self.graph_captures = 0
        self.graph_kernel_launches: Dict[str, int] = {}

    # -- lifecycle ------------------------------------------------------------

    def on_initialize(self, monitor) -> None:
        """Allocate the device state and build the params and groups."""
        with self._state_lock:
            if self._state is None:
                self._state = init_device_state(
                    self.registry.devices.capacity, self.measurement_slots,
                    self.max_tenants, device=self.device)
        self._ensure_params()

    def on_start(self, monitor) -> None:
        if self._state is None:
            self.on_initialize(monitor)

    def _ensure_started(self) -> PipelineParams:
        """State allocated (lazy init for direct, un-started use), params
        and state groups current."""
        if self._state is None:
            self.initialize()
        return self._ensure_params()

    # -- stateful state groups ------------------------------------------------

    @property
    def _programs_enabled(self) -> bool:
        return bool(self._rule_programs)

    @property
    def _models_enabled(self) -> bool:
        return bool(self._anomaly_models)

    @property
    def _actuation_enabled(self) -> bool:
        return bool(self._actuation_policies)

    def _group_dims(self, group: str) -> Tuple[int, ...]:
        """Dims a state group is sized for: the family's buckets while it
        has something installed, else a [D, 1, ...] placeholder (the stage
        is off and its state passes through), so an empty family costs no
        device memory. The full group is allocated on the empty->non-empty
        transition and dropped on the way back."""
        if group == "rule":
            return ((self.max_rule_programs, self.rule_program_state_slots)
                    if self._programs_enabled else (1, 1))
        if group == "model":
            return ((self.max_anomaly_models, self.anomaly_model_features)
                    if self._models_enabled else (1, 1))
        return ((self.max_actuation_policies,) if self._actuation_enabled
                else (1,))

    def _init_group(self, group: str):
        dims = self._group_dims(group)
        self._built_dims[group] = dims
        init = {"rule": init_rule_state, "model": init_model_state,
                "actuation": init_actuation_state}[group]
        return init(self.registry.devices.capacity, *dims,
                    device=self.device)

    def _ensure_groups_sized(self) -> None:
        """(Re)allocate every state group whose family went empty<->non-
        empty since it was built (fresh state, as the reference's step
        rebuild does). A reallocation drops the captured steps: they read
        the old buffers."""
        with self._state_lock:
            for group in ("rule", "model", "actuation"):
                name = f"_{group}_state"
                if (getattr(self, name) is None
                        or self._built_dims.get(group)
                        != self._group_dims(group)):
                    setattr(self, name, self._init_group(group))
                    self._graphs.clear()

    def _expected_group_shapes(self, group: str) -> Dict[str, Tuple]:
        """Canonical shape per field of a state group at THIS engine's
        current dims — what a checkpoint must match."""
        D = self.registry.devices.capacity
        dims = self._group_dims(group)
        P, S = dims[0], (dims[1] if len(dims) > 1 else 1)
        return {"slab": (D, P, state_slab_lanes(S)), "gen": (P,),
                "fire_count": (P,), _SECOND_COUNTER[group]: (P,)}

    def _canonical_group(self, group: str):
        """Host snapshot of a state group: CPU copies of its fields."""
        with self._state_lock:
            state = getattr(self, f"_{group}_state")
            if state is None:
                return None
            return tree_map(lambda t: t.to("cpu", copy=True), state)

    def _load_canonical_group(self, group: str, state) -> None:
        """Inverse of _canonical_group: every field must have the shape of
        this engine's current dims for the group. Copies into the resident
        group (sized to those dims first), which keeps its storage."""
        for name, want in self._expected_group_shapes(group).items():
            got = tuple(getattr(state, name).shape)
            if got != want:
                raise ValueError(
                    f"{group}-state checkpoint shape mismatch for {name}: "
                    f"got {got}, engine expects {want} (bucket/state "
                    f"slots/device capacity must match)")
        with self._lock, self._state_lock:
            self._ensure_groups_sized()
            commit(getattr(self, f"_{group}_state"),
                   tree_map(torch.as_tensor, state))

    def _counters(self, group: str, entries: Dict[str, Dict],
                  names: Tuple[str, str]) -> Dict[str, Dict[str, int]]:
        """Per-token cumulative counters of a family (one host copy of two
        [P] vectors; a slot past the resident counter row — installed, not
        stepped yet — counts zero)."""
        state = getattr(self, f"_{group}_state")
        if state is None:
            return {}
        with self._state_lock:
            first = state.fire_count.cpu().numpy()
            second = getattr(state, _SECOND_COUNTER[group]).cpu().numpy()
        with self._lock:
            return {token: {names[0]: int(first[e["slot"]])
                            if e["slot"] < first.shape[0] else 0,
                            names[1]: int(second[e["slot"]])
                            if e["slot"] < second.shape[0] else 0}
                    for token, e in entries.items()}

    def _install(self, entries: Dict[str, Dict], family: str, capacity: int,
                 what: str, spec: Dict, slot: Optional[int],
                 epoch: Optional[int]) -> Dict:
        """Install or replace one validated spec of a family: the existing
        slot (or the lowest free one) and a new epoch, unless `slot` /
        `epoch` pin them (checkpoint restore)."""
        token = spec["token"]
        with self._lock:
            existing = entries.get(token)
            if slot is None:
                if existing is not None:
                    slot = existing["slot"]
                else:
                    used = {e["slot"] for e in entries.values()}
                    free = [s for s in range(capacity) if s not in used]
                    if not free:
                        raise SiteWhereError(
                            f"{what} capacity exceeded ({capacity} slots)",
                            ErrorCode.CAPACITY_EXCEEDED, http_status=409)
                    slot = free[0]
            if epoch is None:
                self._epochs[family] += 1
                epoch = self._epochs[family]
            else:
                self._epochs[family] = max(self._epochs[family], epoch)
            entry = {"slot": int(slot), "epoch": int(epoch), "spec": spec}
            entries[token] = entry
            self._rules_version += 1
        return entry

    def _create(self, entries: Dict[str, Dict], what: str, spec: Dict,
                upsert) -> Dict:
        """REST create semantics: a duplicate token raises atomically."""
        with self._lock:
            token = (spec or {}).get("token")
            if token in entries:
                raise DuplicateTokenError(f"{what} '{token}' already exists")
        return upsert(spec)

    def _remove(self, entries: Dict[str, Dict], token: str) -> bool:
        with self._lock:
            if entries.pop(token, None) is None:
                return False
            self._rules_version += 1
        return True

    def _by_slot(self, entries: Dict[str, Dict]) -> Dict[int, Dict]:
        with self._lock:
            return {e["slot"]: dict(e["spec"]) for e in entries.values()}

    def _manifest(self, entries: Dict[str, Dict]) -> List[Dict]:
        """Checkpoint form: spec + the runtime (slot, epoch) assignment, so
        a restore re-pins per-device state to its entry."""
        with self._lock:
            return [{"slot": e["slot"], "epoch": e["epoch"],
                     "spec": dict(e["spec"])}
                    for e in sorted(entries.values(),
                                    key=lambda e: e["slot"])]

    # -- rules ----------------------------------------------------------------

    def _mutate_rule(self, kind: str, rule, replace: bool) -> None:
        if kind == "threshold" and not isinstance(rule, ThresholdRule):
            raise SiteWhereError("threshold rule expected", ErrorCode.GENERIC)
        if kind == "geofence" and not isinstance(rule, GeofenceRule):
            raise SiteWhereError("geofence rule expected", ErrorCode.GENERIC)
        with self._lock:
            exists = any(r.token == rule.token
                         for r in self._threshold_rules
                         + self._geofence_rules)
            if exists and not replace:
                raise DuplicateTokenError(
                    f"rule '{rule.token}' already exists")
            target, cap = (
                (self._threshold_rules, self.max_threshold_rules)
                if kind == "threshold"
                else (self._geofence_rules, self.max_geofence_rules))
            # capacity BEFORE any removal: a failed upsert leaves the rule
            # set untouched
            freed = exists and any(r.token == rule.token for r in target)
            if len(target) - (1 if freed else 0) >= cap:
                raise SiteWhereError(f"{kind} rule capacity exceeded",
                                     ErrorCode.CAPACITY_EXCEEDED)
            if exists:
                self._threshold_rules = [r for r in self._threshold_rules
                                         if r.token != rule.token]
                self._geofence_rules = [r for r in self._geofence_rules
                                        if r.token != rule.token]
            (self._threshold_rules if kind == "threshold"
             else self._geofence_rules).append(rule)
            self._rules_version += 1

    def create_rule(self, kind: str, rule) -> None:
        """Install a NEW rule; DuplicateTokenError on a token collision."""
        self._mutate_rule(kind, rule, replace=False)

    def upsert_rule(self, kind: str, rule) -> None:
        """Install or replace the rule with this token."""
        self._mutate_rule(kind, rule, replace=True)

    def add_threshold_rule(self, rule: ThresholdRule) -> None:
        self.upsert_rule("threshold", rule)

    def add_geofence_rule(self, rule: GeofenceRule) -> None:
        self.upsert_rule("geofence", rule)

    def remove_rule(self, token: str) -> bool:
        with self._lock:
            n = len(self._threshold_rules) + len(self._geofence_rules)
            self._threshold_rules = [r for r in self._threshold_rules
                                     if r.token != token]
            self._geofence_rules = [r for r in self._geofence_rules
                                    if r.token != token]
            changed = n != (len(self._threshold_rules)
                            + len(self._geofence_rules))
            if changed:
                self._rules_version += 1
        return changed

    def get_rule(self, token: str):
        """(kind, rule) for a token, or (None, None)."""
        with self._lock:
            for rule in self._threshold_rules:
                if rule.token == token:
                    return "threshold", rule
            for rule in self._geofence_rules:
                if rule.token == token:
                    return "geofence", rule
        return None, None

    def list_rules(self) -> Dict[str, list]:
        with self._lock:
            return {"threshold": list(self._threshold_rules),
                    "geofence": list(self._geofence_rules)}

    def _compile_threshold_table(self) -> ThresholdRuleTable:
        table = empty_threshold_table(self.max_threshold_rules)
        for i, rule in enumerate(self._threshold_rules):
            active = rule.active
            tenant_idx = mm_idx = dtype_idx = 0
            # a scoping token that doesn't resolve deactivates the rule
            # instead of widening it to "any" (index 0 is the wildcard)
            if rule.tenant_token:
                tenant_idx = self.registry.tenants.lookup(rule.tenant_token)
                active = active and tenant_idx > 0
            if rule.device_type_token:
                dtype_idx = self.registry.device_types.lookup(
                    rule.device_type_token)
                active = active and dtype_idx > 0
            if rule.measurement_name:
                mm_idx = self.packer.measurements.intern(
                    rule.measurement_name)
            table.active[i] = active
            table.tenant_idx[i] = tenant_idx
            table.mm_idx[i] = mm_idx
            table.device_type_idx[i] = dtype_idx
            table.op[i] = ThresholdOp.BY_NAME[rule.operator]
            table.threshold[i] = rule.threshold
            table.alert_level[i] = int(rule.alert_level)
            table.alert_type_idx[i] = self.packer.alert_types.intern(
                rule.alert_type)
        return table

    def _compile_geofence_table(self) -> GeofenceRuleTable:
        table = empty_geofence_table(self.max_geofence_rules)
        for i, rule in enumerate(self._geofence_rules):
            zidx = self.registry.zones_interner.lookup(rule.zone_token)
            table.active[i] = rule.active and zidx > 0
            table.zone_row[i] = max(0, zidx - 1)
            table.condition[i] = (GeofenceCondition.INSIDE
                                  if rule.condition == "inside"
                                  else GeofenceCondition.OUTSIDE)
            table.alert_level[i] = int(rule.alert_level)
            table.alert_type_idx[i] = self.packer.alert_types.intern(
                rule.alert_type)
        return table

    # -- rule programs (rules/compiler.py) ------------------------------------

    def _compile_program_table(self):
        table = empty_program_table(self.max_rule_programs,
                                    self.rule_program_nodes)
        for entry in self._rule_programs.values():
            compile_program_into(
                table, entry["slot"], entry["spec"], entry["epoch"],
                intern_measurement=self.packer.measurements.intern,
                intern_alert_type=self.packer.alert_types.intern,
                lookup_tenant=self.registry.tenants.lookup,
                lookup_device_type=self.registry.device_types.lookup,
                measurement_slots=self.measurement_slots,
                max_state_slots=self.rule_program_state_slots)
        # node slots actually populated, for the node-pass trim (NOP is 0,
        # and node 0 of a used program is never NOP)
        used = np.nonzero((table.opcode != 0).any(axis=0))[0]
        self._program_nodes_in_use = int(used.max()) + 1 if used.size else 0
        return table

    def upsert_rule_program(self, spec: Dict, *, slot: Optional[int] = None,
                            epoch: Optional[int] = None) -> Dict:
        """Install or replace a rule program (idempotent). The spec is
        dry-run compiled against this engine's buckets and interners first
        (RuleProgramError, a 409 naming the node, otherwise). A replace
        bumps the slot's epoch so its temporal state resets inside the
        step; `slot`/`epoch` pin the assignment on checkpoint restore."""
        spec = dry_run_program(
            spec, measurement_slots=self.measurement_slots,
            max_nodes=self.rule_program_nodes,
            max_state_slots=self.rule_program_state_slots,
            intern_measurement=self.packer.measurements.intern)
        return self._install(self._rule_programs, "program",
                             self.max_rule_programs, "rule program", spec,
                             slot, epoch)

    def create_rule_program(self, spec: Dict) -> Dict:
        return self._create(self._rule_programs, "rule program", spec,
                            self.upsert_rule_program)

    def remove_rule_program(self, token: str) -> bool:
        return self._remove(self._rule_programs, token)

    def get_rule_program(self, token: str) -> Optional[Dict]:
        with self._lock:
            entry = self._rule_programs.get(token)
            return dict(entry["spec"]) if entry else None

    def list_rule_programs(self) -> List[Dict]:
        """Program specs in slot order (the order fires resolve in)."""
        return [e["spec"] for e in self._manifest(self._rule_programs)]

    def rule_programs_by_slot(self) -> Dict[int, Dict]:
        return self._by_slot(self._rule_programs)

    def rule_program_manifest(self) -> List[Dict]:
        return self._manifest(self._rule_programs)

    def rule_program_counters(self) -> Dict[str, Dict[str, int]]:
        """Per-program cumulative fire/suppress counters (they live in the
        rule state, so they survive checkpoints)."""
        return self._counters("rule", self._rule_programs,
                              ("fires", "suppressed"))

    def canonical_rule_state(self):
        """Host snapshot of the rule-program state (CPU copies)."""
        return self._canonical_group("rule")

    def load_canonical_rule_state(self, rule_state) -> None:
        self._load_canonical_group("rule", rule_state)

    # -- anomaly models (ml/compiler.py) --------------------------------------

    def _compile_model_table(self):
        table = empty_model_table(
            self.max_anomaly_models, self.anomaly_model_features,
            self.anomaly_model_layers, self.anomaly_model_width)
        for entry in self._anomaly_models.values():
            compile_model_into(
                table, entry["slot"], entry["spec"], entry["epoch"],
                intern_measurement=self.packer.measurements.intern,
                intern_alert_type=self.packer.alert_types.intern,
                lookup_tenant=self.registry.tenants.lookup,
                lookup_device_type=self.registry.device_types.lookup,
                measurement_slots=self.measurement_slots)
        return table

    def upsert_anomaly_model(self, spec: Dict, *,
                             slot: Optional[int] = None,
                             epoch: Optional[int] = None) -> Dict:
        """Install or replace an anomaly model (idempotent), dry-run
        compiled first (AnomalyModelError, a 409 naming the field). A
        replace bumps the slot's epoch so its feature state resets."""
        spec = dry_run_model(
            spec, measurement_slots=self.measurement_slots,
            max_features=self.anomaly_model_features,
            max_layers=self.anomaly_model_layers,
            width=self.anomaly_model_width,
            intern_measurement=self.packer.measurements.intern)
        return self._install(self._anomaly_models, "model",
                             self.max_anomaly_models, "anomaly model", spec,
                             slot, epoch)

    def create_anomaly_model(self, spec: Dict) -> Dict:
        return self._create(self._anomaly_models, "anomaly model", spec,
                            self.upsert_anomaly_model)

    def remove_anomaly_model(self, token: str) -> bool:
        return self._remove(self._anomaly_models, token)

    def get_anomaly_model(self, token: str) -> Optional[Dict]:
        with self._lock:
            entry = self._anomaly_models.get(token)
            return dict(entry["spec"]) if entry else None

    def list_anomaly_models(self) -> List[Dict]:
        """Model specs in slot order (the order fires resolve in)."""
        return [e["spec"] for e in self._manifest(self._anomaly_models)]

    def anomaly_models_by_slot(self) -> Dict[int, Dict]:
        return self._by_slot(self._anomaly_models)

    def anomaly_model_manifest(self) -> List[Dict]:
        return self._manifest(self._anomaly_models)

    def anomaly_model_counters(self) -> Dict[str, Dict[str, int]]:
        """Per-model cumulative fire/eval counters."""
        return self._counters("model", self._anomaly_models,
                              ("fires", "evals"))

    def canonical_model_state(self):
        """Host snapshot of the model feature state (CPU copies)."""
        return self._canonical_group("model")

    def load_canonical_model_state(self, model_state) -> None:
        self._load_canonical_group("model", model_state)

    # -- actuation policies (actuation/compiler.py) ---------------------------

    def _compile_policy_table(self):
        table = empty_policy_table(self.max_actuation_policies)
        for entry in self._actuation_policies.values():
            compile_policy_into(
                table, entry["slot"], entry["spec"], entry["epoch"],
                intern_command=self.commands.intern,
                lookup_tenant=self.registry.tenants.lookup)
        return table

    def upsert_actuation_policy(self, spec: Dict, *,
                                slot: Optional[int] = None,
                                epoch: Optional[int] = None) -> Dict:
        """Install or replace an actuation policy (idempotent), dry-run
        compiled against the command interner first (ActuationPolicyError,
        a 409 naming the field). A replace bumps the slot's epoch so its
        per-(device, policy) debounce state resets."""
        spec = dry_run_policy(spec, intern_command=self.commands.intern)
        return self._install(self._actuation_policies, "policy",
                             self.max_actuation_policies,
                             "actuation policy", spec, slot, epoch)

    def create_actuation_policy(self, spec: Dict) -> Dict:
        return self._create(self._actuation_policies, "actuation policy",
                            spec, self.upsert_actuation_policy)

    def remove_actuation_policy(self, token: str) -> bool:
        return self._remove(self._actuation_policies, token)

    def get_actuation_policy(self, token: str) -> Optional[Dict]:
        with self._lock:
            entry = self._actuation_policies.get(token)
            return dict(entry["spec"]) if entry else None

    def list_actuation_policies(self) -> List[Dict]:
        """Policy specs in slot order (the order lane rows resolve in)."""
        return [e["spec"] for e in self._manifest(self._actuation_policies)]

    def actuation_policies_by_slot(self) -> Dict[int, Dict]:
        return self._by_slot(self._actuation_policies)

    def actuation_policy_manifest(self) -> List[Dict]:
        return self._manifest(self._actuation_policies)

    def actuation_policy_counters(self) -> Dict[str, Dict[str, int]]:
        """Per-policy cumulative fire/debounce counters."""
        return self._counters("actuation", self._actuation_policies,
                              ("fires", "debounced"))

    def canonical_actuation_state(self):
        """Host snapshot of the debounce state (CPU copies)."""
        return self._canonical_group("actuation")

    def load_canonical_actuation_state(self, actuation_state) -> None:
        self._load_canonical_group("actuation", actuation_state)

    def take_command_fires(self) -> List[Dict]:
        """Drain command fires parked while no dispatcher was attached."""
        out, self._pending_commands = self._pending_commands, []
        return out

    # -- params refresh -------------------------------------------------------

    def _refresh_params(self) -> None:
        with self._lock:
            snap = self.registry.snapshot()
            self._install_params(to_device(PipelineParams(
                assignment_status=snap.assignment_status,
                tenant_idx=snap.tenant_idx,
                area_idx=snap.area_idx,
                device_type_idx=snap.device_type_idx,
                threshold=self._compile_threshold_table(),
                zones=ZoneTable(vertices=snap.zone_vertices,
                                nvert=snap.zone_nvert,
                                tenant_idx=snap.zone_tenant,
                                active=snap.zone_active),
                geofence=self._compile_geofence_table(),
                programs=self._compile_program_table(),
                models=self._compile_model_table(),
                policies=self._compile_policy_table()), self.device))
            self._params_built_for = (snap.version, self._rules_version)

    def _install_params(self, params: PipelineParams) -> None:
        """Copy freshly built params into the resident ones (every table is
        capacity-sized, so the layout never changes and captured steps
        keep reading current params); a first build, or a layout change,
        installs them as they are and drops the captured steps."""
        with self._state_lock:
            if self._params is not None and same_layout(self._params,
                                                        params):
                commit(self._params, params)
            else:
                self._params = params
                self._graphs.clear()

    def _ensure_params(self) -> PipelineParams:
        """Current params, the state groups sized to match, and the step's
        stage flags (`_step_flags`), all under both locks so neither an
        install nor a step from another thread comes between them."""
        with self._lock, self._state_lock:
            if self._params_built_for != (self.registry.version,
                                          self._rules_version):
                self._refresh_params()
            self._ensure_groups_sized()
            self._step_flags = {
                "programs_enabled": self._programs_enabled,
                "program_node_limit": self._program_nodes_in_use,
                "models_enabled": self._models_enabled,
                "actuation_enabled": self._actuation_enabled}
            return self._params

    # -- the H2D staging ring ---------------------------------------------------

    def _staging_blob_buffer(self, batch: EventBatch,
                             flight_rec=None) -> Optional[np.ndarray]:
        """Rotating reusable [WIRE_ROWS, B] PINNED staging buffer for
        full-size batches (a ring of 6, so blob contents stay stable
        through dispatch and the async H2D copy with the pipelined feeder's
        depth 3 and two stagers). Odd-size batches, and every batch on the
        CPU, allocate fresh (returns None): on the CPU the "transfer" is a
        host copy, as the reference skips its ring there."""
        if (self.device.type != "cuda"
                or batch.device_idx.ndim != 1
                or batch.device_idx.shape[0] != self.batch_size):
            return None
        with self._blob_ring_lock:
            if self._blob_ring is None:
                self._blob_ring_pinned = [
                    torch.empty((WIRE_ROWS, self.batch_size),
                                dtype=torch.int32, pin_memory=True)
                    for _ in range(_BLOB_RING_SLOTS)]
                self._blob_ring = [t.numpy()
                                   for t in self._blob_ring_pinned]
                self._blob_ring_guards = [None] * _BLOB_RING_SLOTS
            pos = self._blob_ring_pos
            self._blob_ring_pos = (pos + 1) % _BLOB_RING_SLOTS
            buf = self._blob_ring[pos]
            guard, self._blob_ring_guards[pos] = (
                self._blob_ring_guards[pos], None)
        if guard is not None:
            # slot reuse waits for the slot's previous H2D copy; by the
            # time a 6-slot ring cycles back it is almost always done
            if flight_rec is not None:
                flight_rec.begin_stage("guard")
            guard.synchronize()
            if flight_rec is not None:
                flight_rec.end_stage("guard")
        return buf

    def _note_blob_guard(self, buf, guard) -> None:
        """Record the event that proves a blob-ring buffer was read (no-op
        for other buffers). Compact and packed blobs are row views of a
        ring buffer: they are matched by their first byte."""
        if guard is None or not isinstance(buf, np.ndarray):
            return
        addr = buf.__array_interface__["data"][0]
        with self._blob_ring_lock:
            if self._blob_ring is None:
                return
            for i, ring_buf in enumerate(self._blob_ring):
                if ring_buf.__array_interface__["data"][0] == addr:
                    self._blob_ring_guards[i] = guard
                    return

    @property
    def staging_ring(self) -> StagingRing:
        """The H2D staging ring (pipeline/staging.py), built at first use
        so `h2d_buffer_depth` can be set before."""
        ring = self._staging_ring
        if ring is None:
            with self._staging_ring_lock:
                if self._staging_ring is None:
                    self._staging_ring = StagingRing(
                        self.h2d_buffer_depth, metrics=self._metrics)
                ring = self._staging_ring
        return ring

    def _retried(self, call, points, note_success=True):
        """`call()` with bounded retry around transient failures: the fault
        `points` armed first, then `step_retries` extra attempts with
        exponential backoff and jitter, each counted on `step_retries` and
        the health ladder, before the error propagates (so the consumer
        layer can park the batch; the submitter is never wedged). Injected
        faults raise before `call` queues any work, so drill retries are
        always state-safe. Shared by the H2D, dispatch and lane-fetch
        edges."""
        attempt = 0
        while True:
            try:
                for point in points:
                    fault_point(point)
                result = call()
                if note_success:
                    self.health.note_success()
                return result
            except Exception:
                attempt += 1
                if attempt > self.step_retries:
                    raise
                self._retry_counter.inc()
                self.health.note_retry()
                time.sleep(jittered(0.01 * (2 ** (attempt - 1))))

    def _acquire_staging_slot(self, flight_rec, order: Optional[int]):
        """Ordered, blocking ring-slot acquisition (backpressure when the
        ring is full); stamps the at-acquire ring snapshot on the flight
        record for the occupancy rollup."""
        ring = self.staging_ring
        slot = ring.acquire(order=order, flight_rec=flight_rec)
        if flight_rec is not None:
            flight_rec.ring = (ring.occupancy(), ring.depth)
        return slot

    def _stage_copy(self, slot, blob: np.ndarray):
        """The transfer of `blob` into `slot`: on the card an async copy on
        the H2D side stream into a row view of the slot's fixed device
        buffer, returning (view, event recorded after the copy); on the CPU
        a plain copy and no event."""
        host = torch.from_numpy(np.ascontiguousarray(blob))
        if self.device.type != "cuda":
            return host.clone(), None
        with torch.cuda.stream(self._h2d_stream):
            if slot.buffer is None or slot.buffer.shape[1] != host.shape[1]:
                slot.buffer = torch.empty(
                    (WIRE_ROWS, host.shape[1]), dtype=torch.int32,
                    device=self.device)
            dst = slot.buffer[:host.shape[0]]
            dst.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return dst, ready

    def stage_blob(self, blob, flight_rec=None,
                   order: Optional[int] = None) -> StagedBlob:
        """Stage a packed wire blob through the H2D staging ring: acquire a
        slot (backpressure when all `h2d_buffer_depth` transfers are in
        flight), start the async copy — arming the `h2d_error` fault point
        with the same bounded retry/backoff as every transfer edge — and
        return a handle that submit_blob dispatches and releases. The
        pipelined feeder passes its sequence as `order` so slots are
        granted in dispatch order. A failed transfer releases the slot
        guard-free and propagates."""
        slot = self._acquire_staging_slot(flight_rec, order)
        if flight_rec is not None:
            flight_rec.begin_stage("h2d")
        try:
            dev, ready = self._retried(lambda: self._stage_copy(slot, blob),
                                       ("h2d_error",), note_success=False)
        except BaseException:
            self.staging_ring.release(slot)
            raise
        finally:
            if flight_rec is not None:
                flight_rec.end_stage("h2d")
        slot.device_blob = dev
        # the copy's event proves the host staging buffer was read
        self._note_blob_guard(blob, ready)
        return StagedBlob(dev, slot, self.staging_ring, ready)

    # -- processing -----------------------------------------------------------

    def submit(self, batch: EventBatch, age=None) -> ProcessOutputs:
        """Pack a host batch into the wire blob and run one step; the state
        advances in place. `age` is the optional ingest-age sidecar
        (runtime/eventage.py) opened at the receive edge: it rides the
        flight record and materialize_alerts closes it."""
        rec = self.flight.begin_step(engine=self.name)
        if age is not None:
            rec.age = age
        # buffer first: its guard wait is the "guard" segment and must not
        # nest inside "pack"
        out_buf = self._staging_blob_buffer(batch, flight_rec=rec)
        rec.begin_stage("pack")
        fault_point("pack_fail")
        blob = batch_to_blob(batch, out=out_buf)
        rec.end_stage("pack")
        self._stage_hist.observe(rec.stage_s("pack"),
                                 engine=self.name, stage="pack")
        self._sample_tenant_mix(rec, batch)
        return self.submit_blob(
            blob, n_events=int(np.asarray(batch.valid).sum()),
            flight_rec=rec)

    def _sample_tenant_mix(self, rec, batch: EventBatch) -> None:
        """Every Nth step, attach the batch's tenant mix (host bincount
        over the registry's tenant mirror — never a device fetch) to the
        flight record and the per-tenant event histogram."""
        self._flight_step_n += 1
        if self._flight_step_n % self._flight_sample_every:
            return
        try:
            dev = np.asarray(batch.device_idx).ravel()
            valid = np.asarray(batch.valid).ravel().astype(bool)
            tenants = self.registry._tenant_idx[dev[valid]]
            mix = np.bincount(tenants, minlength=1)
        except Exception:
            return
        rec.tenant_mix = tuple(int(x) for x in mix[:self.max_tenants])
        for tenant, count in enumerate(rec.tenant_mix):
            if count:
                self._tenant_hist.observe(
                    float(count), engine=self.name, tenant=str(tenant))

    def submit_blob(self, blob, n_events: Optional[int] = None,
                    flight_rec=None) -> ProcessOutputs:
        """Run one step on a packed wire blob: numpy, an int32 tensor, or a
        StagedBlob from stage_blob (its slot is released after dispatch
        with the step's event as the reuse guard). Returns without waiting
        for the card. `n_events` feeds the events meter; `flight_rec` is a
        record opened by the caller (submit(), or a feeder's stager
        thread), else this opens a dispatch-only record."""
        slot = ready = None
        if isinstance(blob, StagedBlob):
            slot, ready, blob = blob.slot, blob.ready, blob.blob
        self._ensure_started()
        rec = flight_rec if flight_rec is not None else (
            self.flight.begin_step(engine=self.name))
        rec.begin_stage("dispatch")
        try:
            outputs = self._dispatch_with_retry(blob, ready)
        except BaseException:
            if slot is not None:
                # guard-free release: nothing consumed the slot's blob
                self.staging_ring.release(slot)
            raise
        rec.end_stage("dispatch")
        guard = record_event(self.device)
        if slot is not None:
            self.staging_ring.release(slot, guard)
        if n_events is not None:
            rec.events = int(n_events)
        self._flight_last = rec
        self._stage_hist.observe(rec.stage_s("dispatch"),
                                 engine=self.name, stage="dispatch")
        # the step's event proves a ring buffer's H2D copy was read
        self._note_blob_guard(blob, guard)
        self.batches_processed += 1
        if n_events is not None:
            self._metrics.meter("events").mark(n_events)
        return outputs

    def _dispatch_with_retry(self, blob, ready=None) -> ProcessOutputs:
        """Run one state-advancing step with bounded retry around transient
        H2D/dispatch failures (`_retried`). The first step of a static
        configuration runs eagerly here; its capture follows OUTSIDE the
        retries (a retried eager step would apply twice), and a failed
        capture raises and marks the engine failed."""
        def step():
            with self._state_lock:
                return self._run_step(blob, ready)

        outputs, capture_from = self._retried(
            step, ("h2d_error", "dispatch_error"))
        if capture_from is not None:
            with self._state_lock:
                try:
                    self._capture(capture_from, outputs)
                except Exception as exc:
                    key = capture_from[0]
                    self._failed_captures[key] = repr(exc)
                    self.health.note_fatal("step capture failed")
                    raise RuntimeError(
                        f"capturing the step of {key} failed ({exc!r}); "
                        f"the card never runs it eagerly after its first "
                        f"step") from exc
        return outputs

    def _captures(self) -> bool:
        """Whether this engine runs its steps as captured graphs (on the
        card)."""
        return self.device.type == "cuda"

    def _run_step(self, blob, ready):
        """One step, under the state lock: a replay of the key's captured
        step, or, for a key's first step (and every step on the CPU), the
        step run eagerly on the live buffers. Returns (outputs, None), or
        (outputs, (key, device blob)) when the key is to be captured."""
        key = step_key(self._step_flags, blob.shape)
        if key in self._failed_captures:
            raise RuntimeError(f"the step of {key} failed to capture "
                               f"({self._failed_captures[key]})")
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        graph = self._graphs.get(key)
        if graph is not None:
            outputs = graph.replay(blob)
            for name, n in graph.kernel_launches.items():
                self.graph_kernel_launches[name] = \
                    self.graph_kernel_launches.get(name, 0) + n
            return outputs, None
        if not (isinstance(blob, torch.Tensor)
                and blob.device == self.device):
            blob = torch.as_tensor(blob).to(self.device, non_blocking=True)
        outputs = self._step_into_state(blob)
        return outputs, ((key, blob) if self._captures() else None)

    def _step_into_state(self, blob: torch.Tensor) -> ProcessOutputs:
        """The step as a graph captures it: process_batch on the resident
        params and state groups, the new state copied back INTO the
        resident buffers (the stateful slabs already update in place), so
        every buffer keeps its storage across steps."""
        state, rule_state, model_state, actuation_state, outputs = \
            process_batch(
                self._params, self._state, self._rule_state,
                self._model_state, self._actuation_state,
                blob_to_batch(blob), geofence_impl=self.geofence_impl,
                alert_lane_capacity=self.alert_lane_capacity,
                command_lane_capacity=self.command_lane_capacity,
                **self._step_flags)
        commit(self._state, state)
        commit(self._rule_state, rule_state)
        commit(self._model_state, model_state)
        commit(self._actuation_state, actuation_state)
        return outputs

    def _capture(self, key_and_blob, outputs: ProcessOutputs) -> None:
        """Capture the key's step, unless another thread changed the
        static configuration since the eager step (the next step of the
        key then runs eagerly again and captures)."""
        key, blob = key_and_blob
        if key in self._graphs or key != step_key(self._step_flags,
                                                  blob.shape):
            return
        self._graphs[key] = capture_step(self._step_into_state, blob,
                                         outputs)
        self.graph_captures += 1

    def submit_routed(self, batch: EventBatch, age=None):
        """(batch_for_materialization, outputs): the engine-agnostic submit
        of the reference (the sharded engine returns a routed batch)."""
        return batch, self.submit(batch, age=age)

    def _fetch_lanes_with_retry(self, outputs: ProcessOutputs):
        """Both fixed-shape lanes (alert + command) in one host copy, with
        bounded retry (`_retried`); a fetch never changes state, so
        retrying it is always safe."""
        K = outputs.alert_lanes.shape[1]
        both = self._retried(
            lambda: torch.cat([outputs.alert_lanes, outputs.command_lanes],
                              dim=1).cpu().numpy(), ("lane_fetch_error",))
        return both[:, :K], both[:, K:]

    def materialize_alerts(self, batch: EventBatch, outputs: ProcessOutputs,
                           max_alerts: Optional[int] = None
                           ) -> List[DeviceAlert]:
        """Turn the step's device-compacted alert lanes into API-level
        DeviceAlert events, and its command lane into command fires.

        Both fixed-shape lanes (alert + command) come back in ONE host
        copy per step, whatever the batch size; the accounting counts them
        as the reference's two fetches. A `max_alerts` bound and lane
        overflow (> capacity fired rows) both count on `alerts_dropped`
        and log. The list is what a mask scan over the per-row outputs
        gives for the first `alert_lane_capacity` fired rows, order
        included. Command fires go to the attached `command_dispatcher`,
        or park for take_command_fires(). The lane_fetch / materialize /
        actuate segments land on the last dispatched step's flight record,
        and its age sidecar closes here."""
        rec = self._flight_last
        if rec is not None:
            rec.begin_stage("lane_fetch")
        lanes, cmd_lanes = self._fetch_lanes_with_retry(outputs)
        if rec is not None:
            rec.end_stage("lane_fetch")
            rec.begin_stage("materialize")
            self._stage_hist.observe(rec.stage_s("lane_fetch"),
                                     engine=self.name, stage="lane_fetch")
        try:
            self.d2h_fetches += 2
            self.d2h_bytes += lanes.nbytes + cmd_lanes.nbytes
            dec = decode_alert_lanes(lanes)
            self._account_lane_overflow(dec.dropped_alerts)
            dec = self._bound_alert_rows(dec, max_alerts)
            if dec.n == 0:
                return []
            dev_rows = np.asarray(batch.device_idx)[dec.rows]
            ts_rows = np.asarray(batch.ts)[dec.rows]
            return self._emit_alerts(dec, dev_rows, ts_rows)
        finally:
            if rec is not None:
                rec.end_stage("materialize")
                self._stage_hist.observe(
                    rec.stage_s("materialize"),
                    engine=self.name, stage="materialize")
            self._materialize_commands(cmd_lanes, rec)
            if rec is not None:
                self._close_age(rec)

    def _close_age(self, rec) -> None:
        """Close the step's ingest-age sidecar at the materialize edge into
        the AgeSummary that replaces it on the record, feeding the (engine,
        edge) histogram; with command fires in the step, the same summary
        is the detection->actuation age."""
        age = rec.age
        if age is None or not hasattr(age, "close"):
            return
        summary = age.close()
        rec.age = summary
        observe_summary(self._age_hist, summary,
                        engine=self.name, edge="materialize")
        if getattr(rec, "commands", 0):
            observe_summary(self._age_hist, summary, engine=self.name,
                            edge="detection_to_actuation")

    def _materialize_commands(self, cmd_lanes: np.ndarray, rec) -> None:
        """Decode the step's command lane, account fire/debounce/overflow
        activity, and hand resolved fires on."""
        if rec is not None:
            rec.begin_stage("actuate")
        dec = decode_command_lanes(cmd_lanes)
        self._account_command_activity(dec)
        fires = self._emit_command_fires(dec) if dec.n else []
        if rec is not None:
            rec.commands = len(fires)
            rec.end_stage("actuate")
            self._stage_hist.observe(rec.stage_s("actuate"),
                                     engine=self.name, stage="actuate")
        self._fanout_commands(fires, rec)

    def _fanout_commands(self, fires: List[Dict], rec) -> None:
        """Hand resolved fires to the attached dispatcher, or park them for
        take_command_fires() when none is attached."""
        if not fires:
            return
        if rec is not None:
            rec.begin_stage("command_fanout")
        try:
            if self.command_dispatcher is not None:
                self.command_dispatcher.dispatch(self, fires)
            else:
                self._pending_commands.extend(fires)
        finally:
            if rec is not None:
                rec.end_stage("command_fanout")
                self._stage_hist.observe(
                    rec.stage_s("command_fanout"),
                    engine=self.name, stage="command_fanout")

    def _account_command_activity(self, dec) -> None:
        fired = int(dec.fired) - int(dec.dropped)
        if fired:
            self.commands_fired += fired
            self._metrics.counter("actuation.fires").inc(fired)
        if dec.debounced:
            self.commands_debounced += int(dec.debounced)
            self._metrics.counter("actuation.debounced").inc(
                int(dec.debounced))
        if dec.dropped:
            self.commands_dropped += int(dec.dropped)
            self._metrics.counter("commands.dropped").inc(int(dec.dropped))
            _log.warning(
                "command-lane overflow: %d policy fires beyond the %d-row "
                "lane capacity dropped on device (commands_dropped=%d "
                "total)", dec.dropped, self.command_lane_capacity,
                self.commands_dropped)

    def _emit_command_fires(self, dec) -> List[Dict]:
        """Resolve decoded command-lane slots into fire records: device
        token via the interner's cached array, command token and params
        from the installed policy spec."""
        policies = self.actuation_policies_by_slot()
        tokens = self.registry.devices.token_array()[dec.dev].tolist()
        slots = dec.policy_slot.tolist()
        levels = dec.level.tolist()
        sources = dec.source.tolist()
        fires: List[Dict] = []
        for i in range(dec.n):
            spec = policies.get(slots[i])
            if spec is None:  # policy removed between dispatch and fetch
                continue
            fires.append({
                "policy": spec["token"], "slot": slots[i],
                "device": tokens[i], "command": spec["command"],
                "params": list(spec.get("params", ())),
                "level": levels[i], "source": sources[i],
                "tenant": spec.get("tenant_token", "")})
        return fires

    def _account_lane_overflow(self, dropped: int) -> None:
        if not dropped:
            return
        self.alerts_dropped += dropped
        self._metrics.counter("alerts.dropped").inc(dropped)
        _log.warning(
            "alert-lane overflow: %d alerts beyond the %d-row lane "
            "capacity dropped on device (alerts_dropped=%d total)",
            dropped, self.alert_lane_capacity, self.alerts_dropped)

    def _bound_alert_rows(self, dec, max_alerts: Optional[int]):
        """Apply a caller's max_alerts bound (row count) with the same loud
        accounting."""
        if max_alerts is None or dec.n <= max_alerts:
            return dec
        dropped = dec.n - max_alerts
        self.alerts_dropped += dropped
        self._metrics.counter("alerts.dropped").inc(dropped)
        _log.warning(
            "alert storm: %d fired rows exceed max_alerts=%d; dropping %d "
            "(alerts_dropped=%d total)", dec.n, max_alerts, dropped,
            self.alerts_dropped)
        return dec.head(max_alerts)

    def _emit_alerts(self, dec, dev_rows: np.ndarray,
                     ts_rows: np.ndarray) -> List[DeviceAlert]:
        """DeviceAlert list for decoded lane slots: threshold, geofence,
        rule-program then anomaly-model alerts per row. Tokens, dates and
        levels resolve by array ops before the per-alert loop."""
        with self._lock:
            thr_rules = list(self._threshold_rules)
            geo_rules = list(self._geofence_rules)
        programs = self.rule_programs_by_slot()
        # model-fire resolution is its own flight segment inside
        # materialize: the lane carries only slot ids
        flight = self._flight_last
        if flight is not None:
            flight.begin_stage("model_eval")
        models = self.anomaly_models_by_slot()
        model_f, model_s = dec.model_fired.tolist(), dec.model_slot.tolist()
        if flight is not None:
            flight.end_stage("model_eval")
        prog_f, prog_r = dec.prog_fired.tolist(), dec.prog_rule.tolist()
        prog_l = dec.prog_level.tolist()
        tokens = self.registry.devices.token_array()[dev_rows].tolist()
        dates = (ts_rows.astype(np.int64)
                 + self.packer.epoch_base_ms).tolist()
        thr_f, geo_f = dec.thr_fired.tolist(), dec.geo_fired.tolist()
        thr_r, geo_r = dec.thr_rule.tolist(), dec.geo_rule.tolist()
        thr_l, geo_l = dec.thr_level.tolist(), dec.geo_level.tolist()
        n_thr, n_geo = len(thr_rules), len(geo_rules)
        levels = _ALERT_LEVELS
        alerts: List[DeviceAlert] = []
        for i in range(dec.n):
            token = tokens[i]
            if thr_f[i] and 0 <= thr_r[i] < n_thr:
                rule = thr_rules[thr_r[i]]
                alerts.append(DeviceAlert(
                    device_id=token, source=AlertSource.SYSTEM,
                    level=levels.get(thr_l[i]) or AlertLevel(thr_l[i]),
                    type=rule.alert_type,
                    message=rule.alert_message
                    or f"threshold rule {rule.token} fired",
                    event_date=dates[i]))
            if geo_f[i] and 0 <= geo_r[i] < n_geo:
                rule = geo_rules[geo_r[i]]
                alerts.append(DeviceAlert(
                    device_id=token, source=AlertSource.SYSTEM,
                    level=levels.get(geo_l[i]) or AlertLevel(geo_l[i]),
                    type=rule.alert_type,
                    message=rule.alert_message
                    or f"geofence rule {rule.token} fired",
                    event_date=dates[i]))
            if prog_f[i] and prog_r[i] in programs:
                spec = programs[prog_r[i]]
                alerts.append(DeviceAlert(
                    device_id=token, source=AlertSource.SYSTEM,
                    level=levels.get(prog_l[i]) or AlertLevel(prog_l[i]),
                    type=spec["alert_type"],
                    message=spec["alert_message"]
                    or f"rule program {spec['token']} fired",
                    event_date=dates[i]))
            if model_f[i] and model_s[i] in models:
                # the lane carries only the model slot; level and type
                # come from the installed spec
                spec = models[model_s[i]]
                level = int(spec["alert_level"])
                alerts.append(DeviceAlert(
                    device_id=token, source=AlertSource.SYSTEM,
                    level=levels.get(level) or AlertLevel(level),
                    type=spec["alert_type"],
                    message=spec["alert_message"]
                    or f"anomaly model {spec['token']} fired",
                    event_date=dates[i]))
        return alerts

    # -- presence -------------------------------------------------------------

    def presence_sweep(self) -> List[str]:
        """Run the presence check at the current time; returns the tokens
        of newly-missing devices. The new presence columns are copied into
        the resident state, which keeps its storage."""
        params = self._ensure_started()
        now_rel = self.packer.rel_ts(int(time.time() * 1000))
        with self._state_lock:
            state, newly_missing = check_presence(
                self._state, params.assignment_status == 1, now_rel,
                min(self.presence_missing_interval_ms, 2 ** 31 - 1))
            commit(self._state, state)
        rows = np.nonzero(newly_missing.cpu().numpy())[0]
        if rows.size == 0:
            return []
        tokens = self.registry.devices.token_array()[rows].tolist()
        return [t for t in tokens if t]

    # -- state reads ----------------------------------------------------------

    @property
    def state(self) -> DeviceStateTensors:
        if self._state is None:
            raise RuntimeError("engine not started")
        return self._state

    def canonical_state(self) -> DeviceStateTensors:
        """Host snapshot of the state: the same fields as CPU tensors,
        detached from the engine's buffers."""
        with self._state_lock:
            return tree_map(lambda t: t.to("cpu", copy=True), self.state)

    def load_canonical_state(self, state: DeviceStateTensors) -> None:
        """Inverse of canonical_state: every field must have this engine's
        shape (device capacity, measurement slots, tenant width). Copies
        into the resident state, which keeps its storage."""
        self._ensure_started()
        for f in dataclasses.fields(state):
            got = tuple(getattr(state, f.name).shape)
            expect = tuple(getattr(self._state, f.name).shape)
            if got != expect:
                raise ValueError(
                    f"checkpoint shape mismatch for {f.name}: got {got}, "
                    f"engine expects {expect} (device capacity/measurement "
                    f"slots/tenant width must match)")
        with self._state_lock:
            commit(self._state, tree_map(torch.as_tensor, state))

    def get_device_state(self, device_token: str) -> Optional[DeviceState]:
        """Materialize one device's state row as the API-level DeviceState."""
        idx = self.registry.devices.lookup(device_token)
        if idx == 0 or self._state is None:
            return None
        with self._state_lock:
            row = {f.name: getattr(self._state, f.name)[idx].cpu().numpy()
                   for f in dataclasses.fields(self._state)
                   if not f.name.startswith("tenant_")}
        abs_ts = self.packer.abs_ts
        state = DeviceState(device_id=device_token)
        if int(row["last_interaction"]) > _NEG:
            state.last_interaction_date = abs_ts(int(row["last_interaction"]))
        state.presence = (PresenceState.PRESENT if bool(row["present"])
                          else PresenceState.NOT_PRESENT)
        if int(row["presence_missing_since"]) > _NEG:
            state.presence_missing_date = abs_ts(
                int(row["presence_missing_since"]))
        if int(row["last_location_ts"]) > _NEG:
            lat, lon, elev = (float(x) for x in row["last_location"])
            state.last_location = (abs_ts(int(row["last_location_ts"])),
                                   lat, lon, elev)
        names = self.packer.measurements.token_array()
        for slot in range(self.measurement_slots):
            ts_slot = int(row["last_measurement_ts"][slot])
            if ts_slot > _NEG:
                name = names[slot] or f"slot{slot}"
                state.last_measurements[name] = (
                    abs_ts(ts_slot), float(row["last_measurement"][slot]))
        if int(row["last_alert_ts"]) > _NEG:
            atype = self.packer.alert_types.token_of(
                int(row["last_alert_type"])) or ""
            state.last_alerts[atype] = (abs_ts(int(row["last_alert_ts"])),
                                        int(row["last_alert_level"]), "")
        return state

    def stats(self) -> Dict:
        with self._state_lock:
            s = self.state
            tenant_events = s.tenant_event_count.cpu().tolist()
            tenant_alerts = s.tenant_alert_count.cpu().tolist()
        return {
            "batches": self.batches_processed,
            "tenant_event_count": tenant_events,
            "tenant_alert_count": tenant_alerts,
            "scope": "global",  # single device: totals are global
        }
