"""What the port must answer, worked out by the plain reference.

The harness hands this module the same world and traffic pool it gave the
port, and the number of steps the port ran. Three parts:

- `eval_pool`: each pool batch once at its full size (the stateless
  families do not depend on time or history): validation, threshold and
  geofence outputs, the alert lanes of a world without stateful families,
  per-device and per-tenant counts, and the geofence kernel's pairs.
- `fold_final`: the device state after all N steps. Every reuse of the pool
  dates its events after all earlier ones and every reuse holds the same
  devices, so the last values come from the last whole pass over the pool
  and the steps after it; the counts are the pass's counts times the
  passes. It folds those steps with the frozen fold and adds the rest.
- `replay_devices`: the stateful families over the whole history of a
  sample of devices (renumbered 1..n), every step, with the stateless
  outputs of `eval_pool` for their rows: their per-row fires, their
  command fires and their state groups at the end, and each step's count
  of their fires.

`control` rounds the events' values and coordinates to bfloat16 first:
the reference one precision below the configuration's float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from swbench.reference import step as rstep
from swbench.reference.actuate import (
    decode_command_lanes, init_actuation_state)
from swbench.reference.anomaly import init_model_state
from swbench.reference.base import EventBatch
from swbench.reference.compact import compact_alert_lanes, decode_alert_lanes
from swbench.reference.geofence import zone_reject_mask
from swbench.reference.segments import count_by_key
from swbench.reference.state_tensors import init_device_state
from swbench.reference.stateful import (
    init_rule_state, observations_of_batch)
from swbench.reference.world import compile_world

_FIELDS = ("fired", "first_rule", "alert_level")


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def make_batch(cols: Dict, shift: int, device,
               control: bool = False) -> EventBatch:
    """The reference's EventBatch of pool columns, times moved by
    `shift`."""
    value, lat, lon = cols["value"], cols["lat"], cols["lon"]
    if control:
        value, lat, lon = _bf16(value), _bf16(lat), _bf16(lon)
    d = torch.device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)  # noqa
    B = len(cols["dev"])
    zi = torch.zeros(B, dtype=torch.int32, device=d)
    return EventBatch(
        device_idx=t(cols["dev"]), tenant_idx=zi, event_type=t(cols["et"]),
        ts=t((cols["ts"].astype(np.int64) + shift).astype(np.int32)),
        mm_idx=t(cols["mm"]), value=t(value), lat=t(lat), lon=t(lon),
        elevation=torch.zeros(B, dtype=torch.float32, device=d),
        alert_type_idx=zi, alert_level=zi.clone(),
        valid=torch.ones(B, dtype=torch.bool, device=d))


@dataclasses.dataclass
class PoolEval:
    thr: List[Dict[str, np.ndarray]]     # per pool batch, [B] each
    geo: List[Dict[str, np.ndarray]]
    lanes: List[Optional[np.ndarray]]    # main world only
    dev_counts: np.ndarray               # int64 [D], summed over the pool
    tenant_events: List[np.ndarray]      # per pool batch, [T]
    tenant_alerts: List[Optional[np.ndarray]]   # main world only
    p_in: List[int]                      # geofence pairs not y-rejected
    attach_rows: List[int]               # stateful: attach rows a batch


def eval_pool(world, pool: List[Dict], device, control: bool = False
              ) -> PoolEval:
    comp = compile_world(world, device)
    params, flags = comp.params, comp.flags
    cfg = world.config
    D, T = cfg["max_devices"], cfg["max_tenants"]
    stateful = flags["programs_enabled"] or flags["models_enabled"] \
        or flags["actuation_enabled"]
    out = PoolEval([], [], [], np.zeros(D, np.int64), [], [], [], [])
    for cols in pool:
        b = make_batch(cols, 0, device, control=control)
        b, dtype_row, _ = rstep.validate_batch(params, b, D)
        thr = rstep.eval_threshold_rules(b, params.threshold, dtype_row)
        geo = rstep.eval_geofence_rules(b, params.zones, params.geofence,
                                        impl="plain")
        out.thr.append({k: thr[k].cpu().numpy() for k in _FIELDS})
        out.geo.append({k: geo[k].cpu().numpy() for k in _FIELDS})
        out.dev_counts += count_by_key(b.device_idx, b.valid, D) \
            .cpu().numpy().astype(np.int64)
        out.tenant_events.append(
            count_by_key(b.tenant_idx, b.valid, T).cpu().numpy())
        out.p_in.append(int((~zone_reject_mask(
            b.lat, b.lon, params.zones.vertices)).sum()))
        if stateful:
            out.lanes.append(None)
            out.tenant_alerts.append(None)
            _, _, _, attach = observations_of_batch(
                b, cfg["measurement_slots"], D)
            out.attach_rows.append(int(attach.sum()))
        else:
            prog, model = rstep._placeholders(b.device_idx.shape[0],
                                              b.valid.device)
            out.lanes.append(compact_alert_lanes(
                thr, geo, flags["alert_lane_capacity"], prog, model)
                .cpu().numpy())
            fired = thr["fired"] | geo["fired"]
            out.tenant_alerts.append(count_by_key(
                b.tenant_idx, b.valid & fired, T).cpu().numpy())
        del b, thr, geo
    return out


def fold_final(world, pool: List[Dict], traffic: Dict, n_steps: int,
               ev: PoolEval, device, control: bool = False) -> Dict:
    """The device state after steps 0..n_steps-1, as numpy arrays."""
    from swbench.traffic import step_source

    comp = compile_world(world, device)
    cfg = world.config
    D, T = cfg["max_devices"], cfg["max_tenants"]
    P = traffic["pool"]
    passes, rest = divmod(n_steps, P)
    first = (passes - 1) * P if passes else 0
    state = init_device_state(D, cfg["measurement_slots"], T, device=device)
    tenant_alerts = np.zeros(T, np.int64)
    for k in range(first, n_steps):
        p, shift = step_source(k, traffic)
        b = make_batch(pool[p], shift, device, control=control)
        b, _, _ = rstep.validate_batch(comp.params, b, D)
        state = rstep.fold_device_state(state, b)
        state = dataclasses.replace(
            state, tenant_event_count=state.tenant_event_count
            + count_by_key(b.tenant_idx, b.valid, T))
    out = {f.name: getattr(state, f.name).cpu().numpy()
           for f in dataclasses.fields(state)}
    if passes > 1:
        out["event_count"] = (out["event_count"].astype(np.int64)
                              + (passes - 1) * ev.dev_counts).astype(np.int32)
        out["tenant_event_count"] = (
            out["tenant_event_count"].astype(np.int64)
            + (passes - 1) * np.sum(ev.tenant_events, axis=0)).astype(np.int32)
    if ev.tenant_alerts and ev.tenant_alerts[0] is not None:
        for k in range(n_steps):
            tenant_alerts += ev.tenant_alerts[k % P]
        out["tenant_alert_count"] = tenant_alerts.astype(np.int32)
    else:
        out.pop("tenant_alert_count")   # stateful fires of every device
    return out


@dataclasses.dataclass
class DeviceReplay:
    devices: np.ndarray          # global device indices, sorted
    rows: Dict[int, np.ndarray]  # step k -> global rows of those devices
    prog: Dict[int, Dict]        # step k -> {fired, first_rule, alert_level}
    model: Dict[int, Dict]       # step k -> {fired, first_model}
    commands: Dict[int, List]    # step k -> [(dev, slot, row, level, source)]
    groups: Dict[str, np.ndarray]  # final rule/model/actuation rows, gens
    fires: np.ndarray            # [steps] their rule-program + model fires
    extra_rows: np.ndarray       # [steps] their rows fired by those alone


# the packed per-step input of the replay: one int32 row a column
_COLS = ("dev", "et", "ts", "mm", "value", "lat", "lon", "valid",
         "thr_fired", "thr_first", "thr_level",
         "geo_fired", "geo_first", "geo_level")


class _ReplayStep:
    """One step of the stateful reference over the sampled devices, on
    inputs padded to R rows (padding: device 0, not valid, which no stage
    reads). Eager on the CPU; on a card the step is captured once in a
    CUDA graph (its second call) and replayed, since the plain stages are
    thousands of small kernels a step."""

    def __init__(self, comp, flags, state, rule, model, act, R, device):
        self.comp, self.flags = comp, flags
        self.groups = [state, rule, model, act]
        self.dev = torch.device(device)
        self.packed = torch.zeros((len(_COLS), R), dtype=torch.int32,
                                  device=self.dev)
        self.graph, self.calls, self.out = None, 0, None

    def _body(self):
        c = {name: self.packed[i] for i, name in enumerate(_COLS)}
        f32 = lambda x: x.view(torch.float32)   # noqa: E731
        R = self.packed.shape[1]
        zi = torch.zeros(R, dtype=torch.int32, device=self.dev)
        b = EventBatch(device_idx=c["dev"], tenant_idx=zi,
                       event_type=c["et"], ts=c["ts"], mm_idx=c["mm"],
                       value=f32(c["value"]), lat=f32(c["lat"]),
                       lon=f32(c["lon"]),
                       elevation=torch.zeros(R, dtype=torch.float32,
                                             device=self.dev),
                       alert_type_idx=zi, alert_level=zi,
                       valid=c["valid"] != 0)
        stateless = tuple(
            {"fired": c[f"{n}_fired"] != 0, "first_rule": c[f"{n}_first"],
             "alert_level": c[f"{n}_level"]} for n in ("thr", "geo"))
        state, rule, model, act = self.groups
        new = rstep.process_batch(self.comp.params, state, rule, model, act,
                                  b, geofence_impl="plain",
                                  stateless=stateless, **self.flags)
        # the next step reads the same buffers: copy the new groups back
        for old, fresh in zip(self.groups, new[:4]):
            for f in dataclasses.fields(old):
                dst, src = getattr(old, f.name), getattr(fresh, f.name)
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        return new[4]

    def __call__(self, host: np.ndarray):
        self.packed.copy_(torch.from_numpy(host))
        self.calls += 1
        if self.dev.type != "cuda" or self.calls == 1:
            self.out = self._body()
        elif self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._body()
            self.graph.replay()
        else:
            self.graph.replay()
        return self.out


def replay_devices(world, pool: List[Dict], traffic: Dict, n_steps: int,
                   ev: PoolEval, devices: np.ndarray, keep, device,
                   control: bool = False) -> DeviceReplay:
    """The stateful families over every step for `devices` only; the
    per-row outputs and command fires of the steps `keep(k)` selects."""
    from swbench.traffic import step_source

    cfg = world.config
    n = len(devices)
    D = n + 1
    comp = compile_world(world, device, n_rows=D)
    flags = dict(comp.flags)
    local = np.zeros(cfg["max_devices"], np.int32)
    local[devices] = np.arange(1, D, dtype=np.int32)
    sel = [np.nonzero(local[cols["dev"]] > 0)[0] for cols in pool]
    R = max(4, max(len(s) for s in sel))
    # the pool's packed rows of the sampled devices, times moved per step
    packed = []
    for p, cols in enumerate(pool):
        rows = sel[p]
        h = np.zeros((len(_COLS), R), np.int32)
        vals = {"dev": local[cols["dev"][rows]], "et": cols["et"][rows],
                "ts": cols["ts"][rows], "mm": cols["mm"][rows],
                "valid": np.ones(len(rows), np.int32)}
        for name in ("value", "lat", "lon"):
            v = cols[name][rows]
            vals[name] = (_bf16(v) if control else v).view(np.int32)
        for fam, src in (("thr", ev.thr[p]), ("geo", ev.geo[p])):
            vals[f"{fam}_fired"] = src["fired"][rows].astype(np.int32)
            vals[f"{fam}_first"] = src["first_rule"][rows]
            vals[f"{fam}_level"] = src["alert_level"][rows]
        for i, name in enumerate(_COLS):
            h[i, :len(rows)] = vals[name]
        packed.append(h)
    M, T = cfg["measurement_slots"], cfg["max_tenants"]
    state = init_device_state(D, M, T, device=device)
    rule = init_rule_state(D, cfg["max_rule_programs"],
                           cfg["rule_program_state_slots"], device=device)
    model = init_model_state(D, cfg["max_anomaly_models"],
                             cfg["anomaly_model_features"], device=device)
    act = init_actuation_state(D, cfg["max_actuation_policies"],
                               device=device)
    flags["alert_lane_capacity"] = R
    flags["command_lane_capacity"] = max(4, D * cfg["max_actuation_policies"])
    step = _ReplayStep(comp, flags, state, rule, model, act, R, device)
    rep = DeviceReplay(devices=devices, rows={}, prog={}, model={},
                       commands={}, groups={}, fires=None, extra_rows=None)
    ts_row = _COLS.index("ts")
    thr_row, geo_row = _COLS.index("thr_fired"), _COLS.index("geo_fired")
    tally = torch.zeros((n_steps, 2), dtype=torch.int64, device=device)
    for k in range(n_steps):
        p, shift = step_source(k, traffic)
        rows = sel[p]
        h = packed[p]
        if shift:
            h = h.copy()
            h[ts_row, :len(rows)] += np.int32(shift)
        out = step(h)
        m = len(rows)
        pf, mf = out.program_fired[:m], out.model_fired[:m]
        seen = (step.packed[thr_row, :m] != 0) | (step.packed[geo_row, :m]
                                                   != 0)
        tally[k, 0] = pf.sum() + mf.sum()
        tally[k, 1] = ((pf | mf) & ~seen).sum()
        if keep(k):
            m = len(rows)
            rep.rows[k] = rows
            rep.prog[k] = {
                "fired": out.program_fired[:m].cpu().numpy(),
                "first_rule": out.program_first_rule[:m].cpu().numpy(),
                "alert_level": out.program_alert_level[:m].cpu().numpy()}
            rep.model[k] = {"fired": out.model_fired[:m].cpu().numpy(),
                            "first_model": out.model_first[:m].cpu().numpy()}
            dec = decode_command_lanes(out.command_lanes.cpu().numpy())
            rep.commands[k] = [
                (int(devices[dv - 1]), int(s), int(rows[r]), int(lv), int(sr))
                for dv, s, r, lv, sr in zip(dec.dev, dec.policy_slot,
                                            dec.rows, dec.level, dec.source)]
    tally = tally.cpu().numpy()
    rep.fires, rep.extra_rows = tally[:, 0], tally[:, 1]
    for name, group in zip(("rule", "model", "actuation"),
                           step.groups[1:]):
        rep.groups[f"{name}.slab"] = group.slab[1:].cpu().numpy()
        rep.groups[f"{name}.gen"] = group.gen.cpu().numpy()
    return rep


def alert_keys(lanes: np.ndarray, cols: Dict, shift: int, world,
               comp_specs) -> List[tuple]:
    """The alerts the engine materializes from one step's alert lanes:
    (device token, source, level, type, message, event date) in lane
    order (threshold, geofence, rule program, anomaly model per row)."""
    dec = decode_alert_lanes(lanes)
    programs, models = comp_specs
    thr, geo = world.threshold_rules, world.geofence_rules
    base = world.config["epoch_base_ms"]
    out = []
    for i in range(dec.n):
        r = int(dec.rows[i])
        token = world.device_token(int(cols["dev"][r]))
        date = int(cols["ts"][r]) + shift + base
        if dec.thr_fired[i] and 0 <= dec.thr_rule[i] < len(thr):
            rule = thr[dec.thr_rule[i]]
            out.append((token, 1, int(dec.thr_level[i]), "threshold.violation",
                        f"threshold rule {rule['token']} fired", date))
        if dec.geo_fired[i] and 0 <= dec.geo_rule[i] < len(geo):
            rule = geo[dec.geo_rule[i]]
            out.append((token, 1, int(dec.geo_level[i]), "zone.violation",
                        f"geofence rule {rule['token']} fired", date))
        if dec.prog_fired[i] and int(dec.prog_rule[i]) in programs:
            spec = programs[int(dec.prog_rule[i])]
            out.append((token, 1, int(dec.prog_level[i]), spec["alert_type"],
                        spec["alert_message"]
                        or f"rule program {spec['token']} fired", date))
        if dec.model_fired[i] and int(dec.model_slot[i]) in models:
            spec = models[int(dec.model_slot[i])]
            out.append((token, 1, int(spec["alert_level"]), spec["alert_type"],
                        spec["alert_message"]
                        or f"anomaly model {spec['token']} fired", date))
    return out


def command_fires(cmd_lanes: np.ndarray, world, policies: Dict) -> List:
    """The command fires the engine resolves from one step's command lane."""
    dec = decode_command_lanes(cmd_lanes)
    out = []
    for i in range(dec.n):
        spec = policies.get(int(dec.policy_slot[i]))
        if spec is None:
            continue
        out.append({"policy": spec["token"], "slot": int(dec.policy_slot[i]),
                    "device": world.device_token(int(dec.dev[i])),
                    "command": spec["command"],
                    "params": list(spec.get("params", ())),
                    "level": int(dec.level[i]), "source": int(dec.source[i]),
                    "tenant": spec.get("tenant_token", "")})
    return out
