"""The comparison that decides `correct`: what the port answered in the
timed run (drive.Record, its final state) against what the plain
reference works out from the same world and traffic.

Every number compared is a count of elements that differ, with the limit
0 (an exact comparison):

- lanes: the alert and command lanes of every sampled step, element by
  element (world without stateful families); with stateful families, each
  lane slot's threshold and geofence fields on every row, its rule-program
  and anomaly-model fields on the rows of the replayed devices, every
  fired row below the lanes' cut-off that the reference knows of, the
  lanes' counts against what is known of them, and the command fires of
  the replayed devices below the command lane's cut-off;
- alerts: the materialized alerts and command fires of every sampled step
  against the reference's materialization of the lanes;
- counts: the alerts materialized and dropped at every materialized step
  and the alerts dropped over the run (world without stateful families;
  with them, as far as the replay derives them: `_stateful_counts`), the
  per-tenant fired-row counters (with stateful families; without them
  they are part of the state) and the steps the engine ran;
- state: every element of the device state after the run (f32 as bit
  patterns), the per-tenant counters included (the fired-row counter
  only without stateful families);
- groups: the rule, model and actuation state rows of the replayed
  devices and the groups' generations (worlds with stateful families).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from swbench.reference.actuate import decode_command_lanes
from swbench.reference.compact import decode_alert_lanes
from swbench.traffic import step_source

LIMITS = {"lanes": 0, "alerts": 0, "counts": 0, "state": 0, "groups": 0}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def state_diff(port: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
               ) -> int:
    bad = 0
    for name, want in ref.items():
        got = port[name]
        if got.shape != want.shape:
            bad += int(want.size)
            continue
        bad += int((_bits(got) != _bits(want)).sum())
    return bad


def _stateless_slots(dec, thr, geo) -> int:
    rows = dec.rows
    bad = int((dec.thr_fired != thr["fired"][rows]).sum())
    bad += int((dec.geo_fired != geo["fired"][rows]).sum())
    t, g = dec.thr_fired, dec.geo_fired
    bad += int((dec.thr_rule[t] != thr["first_rule"][rows][t]).sum())
    bad += int((dec.thr_level[t] != thr["alert_level"][rows][t]).sum())
    bad += int((dec.geo_rule[g] != geo["first_rule"][rows][g]).sum())
    bad += int((dec.geo_level[g] != geo["alert_level"][rows][g]).sum())
    return bad


def stateful_lanes(k: int, kept: Dict, p: int, ev, rep, B: int,
                   n_policies: int) -> int:
    """Mismatches of one sampled step's lanes in a world with stateful
    families (see the module docstring)."""
    dec = decode_alert_lanes(kept["lanes"])
    thr, geo = ev.thr[p], ev.geo[p]
    bad = _stateless_slots(dec, thr, geo)
    srows = rep.rows[k]
    prog, model = rep.prog[k], rep.model[k]
    where = np.searchsorted(srows, dec.rows)
    where = np.minimum(where, max(len(srows) - 1, 0))
    mine = (len(srows) > 0) & (srows[where] == dec.rows) \
        if len(srows) else np.zeros(dec.n, bool)
    i = where[mine]
    pf = prog["fired"][i]
    bad += int((dec.prog_fired[mine] != pf).sum())
    bad += int((dec.prog_rule[mine][pf] != prog["first_rule"][i][pf]).sum())
    bad += int((dec.prog_level[mine][pf]
                != prog["alert_level"][i][pf]).sum())
    mf = model["fired"][i]
    bad += int((dec.model_fired[mine] != mf).sum())
    bad += int((dec.model_slot[mine][mf] != model["first_model"][i][mf])
               .sum())
    # completeness below the cut-off, and the counts against what is known
    known_all = thr["fired"] | geo["fired"]
    s_fired = prog["fired"] | model["fired"]
    known_all = known_all.copy()
    known_all[srows[s_fired]] = True
    cutoff = int(dec.rows[-1]) + 1 if dec.fired_rows > dec.n else B
    known = np.nonzero(known_all[:cutoff])[0]
    bad += int(np.setdiff1d(known, dec.rows).size)
    if dec.fired_rows < int(known_all.sum()):
        bad += 1
    known_alerts = (int(thr["fired"].sum()) + int(geo["fired"].sum())
                    + int(prog["fired"].sum()) + int(model["fired"].sum()))
    if dec.total_alerts < known_alerts:
        bad += 1
    # the command lane: the replayed devices' fires below its cut-off
    cdec = decode_command_lanes(kept["cmd_lanes"])
    sdev = set(rep.devices.tolist())
    got = {(int(d), int(s), int(r), int(lv), int(src))
           for d, s, r, lv, src in zip(cdec.dev, cdec.policy_slot, cdec.rows,
                                       cdec.level, cdec.source)
           if int(d) in sdev}
    if cdec.fired > cdec.n and cdec.n:
        cut = int(cdec.dev[-1]) * n_policies + int(cdec.policy_slot[-1])
    else:
        cut = None
    want = {c for c in rep.commands[k]
            if cut is None or c[0] * n_policies + c[1] <= cut}
    bad += len(got ^ want)
    return bad


def compare(world, traffic, pool, rec, port_state, port_groups, ev, fold,
            rep, specs) -> Tuple[Dict[str, int], Dict]:
    """(number name -> mismatches, facts about what was checked)."""
    from swbench.reference.replay import alert_keys, command_fires

    B = traffic["batch"]
    programs, models, policies = specs
    stateful = rep is not None
    n = {"lanes": 0, "alerts": 0, "counts": 0, "state": 0, "groups": 0}
    answers = 0
    for k, kept in sorted(rec.kept.items()):
        p, shift = step_source(k, traffic)
        if stateful:
            n["lanes"] += stateful_lanes(
                k, kept, p, ev, rep, B,
                world.config["max_actuation_policies"])
            lanes = kept["lanes"]
            want_fires = command_fires(kept["cmd_lanes"], world, policies)
            n["alerts"] += _list_diff(kept["fires"], want_fires)
        else:
            want = ev.lanes[p]
            n["lanes"] += int((kept["lanes"] != want).sum())
            n["lanes"] += int((kept["cmd_lanes"] != 0).sum())
            lanes = want
        want_alerts = alert_keys(lanes, pool[p], shift, world,
                                 (programs, models))
        n["alerts"] += _list_diff(kept["alerts"], want_alerts)
        answers += len(kept["alerts"])
    P = traffic["pool"]
    if stateful:
        _stateful_counts(n, rec, ev, rep, port_state, fold, P)
    else:
        decs = [decode_alert_lanes(lanes) for lanes in ev.lanes]
        for k in range(rec.n_steps):
            dec = decs[k % P]
            n["counts"] += int(rec.n_alerts[k] != _alerts_of(dec))
            n["counts"] += int(rec.n_dropped[k] != dec.dropped_alerts)
        dropped = sum(decs[k % P].dropped_alerts for k in range(rec.n_steps))
        n["counts"] += int(rec.alerts_dropped != dropped)
    n["counts"] += int(rec.batches_processed != rec.n_submitted)
    n["state"] = state_diff(port_state, fold)
    if stateful:
        n["groups"] = state_diff(port_groups, rep.groups)
    facts = {"steps": rec.n_submitted, "materialized": rec.n_steps,
             "sampled_steps": len(rec.kept),
             "alerts_compared": answers,
             "replayed_devices": (0 if rep is None else len(rep.devices))}
    return n, facts


def _alerts_of(dec) -> int:
    return int(dec.thr_fired.sum() + dec.geo_fired.sum()
               + dec.prog_fired.sum() + dec.model_fired.sum())


def _stateful_counts(n, rec, ev, rep, port_state, fold, P: int) -> None:
    """The counts of a world with stateful families, as far as a replay
    of the sampled devices derives them. On every materialized step the
    alerts it materialized and dropped together hold at least the
    threshold and geofence alerts of all its rows and the replayed
    devices' fires; on the sampled steps both equal what the step's lanes
    say. The fired-row counters of the tenants with events hold together
    at least the rows fired by threshold, geofence or a replayed device's
    family over every step the engine ran; the other tenants' stay 0."""
    seen = [int(ev.thr[p]["fired"].sum() + ev.geo[p]["fired"].sum())
            for p in range(P)]
    rows = [int((ev.thr[p]["fired"] | ev.geo[p]["fired"]).sum())
            for p in range(P)]
    for k in range(rec.n_steps):
        known = seen[k % P] + int(rep.fires[k])
        n["counts"] += int(rec.n_alerts[k] + rec.n_dropped[k] < known)
    for k, kept in rec.kept.items():
        dec = decode_alert_lanes(kept["lanes"])
        n["counts"] += int(rec.n_alerts[k] != _alerts_of(dec))
        n["counts"] += int(rec.n_dropped[k] != dec.dropped_alerts)
    known_rows = sum(rows[k % P] + int(rep.extra_rows[k])
                     for k in range(rec.n_submitted))
    tenants = np.asarray(port_state["tenant_alert_count"]).astype(np.int64)
    active = np.asarray(fold["tenant_event_count"]) > 0
    n["counts"] += int(int(tenants[active].sum()) < known_rows)
    n["counts"] += int((tenants[~active] != 0).sum())


def _list_diff(got: Optional[List], want: List) -> int:
    got = got or []
    bad = abs(len(got) - len(want))
    return bad + sum(1 for a, b in zip(got, want) if a != b)


def verdict(n: Dict[str, int]) -> bool:
    return all(n[k] <= LIMITS[k] for k in LIMITS)


def check_lines(n: Dict[str, int]) -> List[str]:
    return [f"check {k}: {n[k]} (limit {LIMITS[k]})" for k in LIMITS]
