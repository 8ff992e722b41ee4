"""PipelineEngine: host orchestrator of the step on the card.

Counterpart of `sitewhere_tpu/pipeline/engine.py` `PipelineEngine`, with
its main-path surface: rule CRUD and the rule-table compilers, the params
refresh on registry or rule version change, submit / submit_blob /
submit_routed, alert materialization from the device-compacted lanes (one
host copy per step), the presence sweep, and state reads.

Not in this slice (the flight recorder, fault points, health, the metrics
registry, the staging ring, the feeders, and the stateful stages' CRUD)
— see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.errors import (
    DuplicateTokenError, ErrorCode, SiteWhereError)
from sitewhere_tpu_torch.model.event import (
    AlertLevel, AlertSource, DeviceAlert)
from sitewhere_tpu_torch.model.state import DeviceState, PresenceState
from sitewhere_tpu_torch.ops.compact import (
    DEFAULT_ALERT_LANE_CAPACITY, MIN_ALERT_LANE_CAPACITY, decode_alert_lanes)
from sitewhere_tpu_torch.ops.geofence import (
    GEOFENCE_IMPLS, GeofenceCondition, GeofenceRuleTable, ZoneTable,
    empty_geofence_table)
from sitewhere_tpu_torch.ops.pack import (
    EventBatch, EventPacker, batch_to_blob, blob_to_batch)
from sitewhere_tpu_torch.ops.threshold import (
    ThresholdOp, ThresholdRuleTable, empty_threshold_table)
from sitewhere_tpu_torch.pipeline.state_tensors import (
    DeviceStateTensors, init_device_state)
from sitewhere_tpu_torch.pipeline.step import (
    PipelineParams, ProcessOutputs, check_presence, process_batch)
from sitewhere_tpu_torch.registry.tensors import RegistryTensors
from sitewhere_tpu_torch.tree import to_device, tree_map

_NEG = -(2 ** 31)
_ALERT_LEVELS = {int(level): level for level in AlertLevel}
_log = logging.getLogger("sitewhere.pipeline")


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


class PipelineEngine:
    """One engine per process; multi-tenant by construction (the tenant is
    a tensor column, not a separate engine). Runs on `device` ("cuda"
    unless the caller asks for the CPU; raises without a CUDA device)."""

    def __init__(self, registry_tensors: RegistryTensors,
                 batch_size: int = 8192, measurement_slots: int = 32,
                 max_tenants: int = 16, max_threshold_rules: int = 256,
                 max_geofence_rules: int = 256,
                 presence_missing_interval_ms: int = 8 * 60 * 60 * 1000,
                 geofence_impl: str = "auto",
                 alert_lane_capacity: Optional[int] = None,
                 device: DeviceLike = "cuda"):
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

    def start(self) -> None:
        """Allocate the device state and build the params (idempotent)."""
        with self._state_lock:
            if self._state is None:
                self._state = init_device_state(
                    self.registry.devices.capacity, self.measurement_slots,
                    self.max_tenants, device=self.device)
        self._ensure_params()

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

    # -- params refresh -------------------------------------------------------

    def _refresh_params(self) -> None:
        with self._lock:
            snap = self.registry.snapshot()
            self._params = to_device(PipelineParams(
                assignment_status=snap.assignment_status,
                tenant_idx=snap.tenant_idx,
                area_idx=snap.area_idx,
                device_type_idx=snap.device_type_idx,
                threshold=self._compile_threshold_table(),
                zones=ZoneTable(vertices=snap.zone_vertices,
                                nvert=snap.zone_nvert,
                                tenant_idx=snap.zone_tenant,
                                active=snap.zone_active),
                geofence=self._compile_geofence_table()), self.device)
            self._params_built_for = (snap.version, self._rules_version)

    def _ensure_params(self) -> PipelineParams:
        if self._params_built_for != (self.registry.version,
                                      self._rules_version):
            self._refresh_params()
        return self._params

    # -- processing -----------------------------------------------------------

    def submit(self, batch: EventBatch) -> ProcessOutputs:
        """Pack a host batch into the wire blob and run one step."""
        return self.submit_blob(batch_to_blob(batch))

    def submit_blob(self, blob) -> ProcessOutputs:
        """Run one step on a packed wire blob (numpy, or an int32 tensor on
        any device); the state advances. Returns without waiting for the
        card."""
        self.start()  # state allocated, params current
        params = self._params
        blob = torch.as_tensor(blob).to(self.device)
        with self._state_lock:
            self._state, outputs = process_batch(
                params, self._state, blob_to_batch(blob),
                geofence_impl=self.geofence_impl,
                alert_lane_capacity=self.alert_lane_capacity)
        self.batches_processed += 1
        return outputs

    def submit_routed(self, batch: EventBatch):
        """(batch_for_materialization, outputs): the engine-agnostic submit
        of the reference (the sharded engine returns a routed batch)."""
        return batch, self.submit(batch)

    def materialize_alerts(self, batch: EventBatch, outputs: ProcessOutputs,
                           max_alerts: Optional[int] = None
                           ) -> List[DeviceAlert]:
        """Turn the step's device-compacted alert lanes into API-level
        DeviceAlert events.

        Both fixed-shape lanes (alert + command) come back in ONE host
        copy per step, whatever the batch size; the accounting counts them
        as the reference's two fetches. A `max_alerts` bound and lane
        overflow (> capacity fired rows) both count on `alerts_dropped`
        and log. The list is what a mask scan over the per-row outputs
        gives for the first `alert_lane_capacity` fired rows, order
        included."""
        K = outputs.alert_lanes.shape[1]
        both = torch.cat([outputs.alert_lanes, outputs.command_lanes],
                         dim=1).cpu().numpy()
        lanes, cmd_lanes = both[:, :K], both[:, K:]
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

    def _account_lane_overflow(self, dropped: int) -> None:
        if not dropped:
            return
        self.alerts_dropped += dropped
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
        _log.warning(
            "alert storm: %d fired rows exceed max_alerts=%d; dropping %d "
            "(alerts_dropped=%d total)", dec.n, max_alerts, dropped,
            self.alerts_dropped)
        return dec.head(max_alerts)

    def _emit_alerts(self, dec, dev_rows: np.ndarray,
                     ts_rows: np.ndarray) -> List[DeviceAlert]:
        """DeviceAlert list for decoded lane slots: threshold then geofence
        per row (rule-program and anomaly-model fires come with the
        stateful stages). Tokens, dates and levels resolve by array ops
        before the per-alert loop."""
        with self._lock:
            thr_rules = list(self._threshold_rules)
            geo_rules = list(self._geofence_rules)
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
        return alerts

    # -- presence -------------------------------------------------------------

    def presence_sweep(self) -> List[str]:
        """Run the presence check at the current time; returns the tokens
        of newly-missing devices."""
        self.start()  # state allocated, params current
        params = self._params
        now_rel = self.packer.rel_ts(int(time.time() * 1000))
        with self._state_lock:
            self._state, newly_missing = check_presence(
                self._state, params.assignment_status == 1, now_rel,
                min(self.presence_missing_interval_ms, 2 ** 31 - 1))
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
        shape (device capacity, measurement slots, tenant width)."""
        self.start()
        for f in dataclasses.fields(state):
            got = tuple(getattr(state, f.name).shape)
            expect = tuple(getattr(self._state, f.name).shape)
            if got != expect:
                raise ValueError(
                    f"checkpoint shape mismatch for {f.name}: got {got}, "
                    f"engine expects {expect} (device capacity/measurement "
                    f"slots/tenant width must match)")
        with self._state_lock:
            self._state = tree_map(
                lambda t: torch.as_tensor(t).to(self.device, copy=True),
                state)

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
