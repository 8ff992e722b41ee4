"""The control of `correct`: the plain reference one precision below the
configuration's float32 (event values and coordinates rounded to
bfloat16) put in the port's place, and held by the same comparison
against the float32 reference. It has to come out not correct.

    python3 -m swbench.control --workload <cell> --seeds 1,2,3 --steps N

prints, for each seed, the numbers the comparison gives the control over
N steps of the cell's own traffic at its own sizes, on the card when
there is one. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch


def _command_lanes(fires, capacity: int, n_policies: int) -> np.ndarray:
    """A command lane ([4, capacity] int32) of (dev, slot, row, level,
    source) fires, in (device, policy) order, as the port packs it."""
    from swbench.reference.actuate import _LEVEL_SHIFT, _SOURCE_SHIFT

    fires = sorted(fires, key=lambda f: f[0] * n_policies + f[1])
    lanes = np.zeros((4, capacity), np.int32)
    lanes[0, :] = -1
    lanes[2, :] = -1
    for i, (dev, slot, row, level, source) in enumerate(fires[:capacity]):
        lanes[0, i] = row
        lanes[1, i] = ((slot & 0xFF) | ((level & 0xF) << _LEVEL_SHIFT)
                       | ((source & 0x7) << _SOURCE_SHIFT))
        lanes[2, i] = dev
    lanes[3, 0] = len(fires)
    lanes[3, 1] = max(0, len(fires) - capacity)
    return lanes


def control_record(world, traffic, pool, n_steps: int, every: int,
                   offset: int, devices, device) -> Tuple:
    """(record, final state, groups) the control answers in the port's
    place: what drive.Record and the port's state would hold."""
    from swbench.drive import Record
    from swbench.reference.compact import decode_alert_lanes
    from swbench.reference.replay import (
        alert_keys, command_fires, eval_pool, fold_final, replay_devices)
    from swbench.reference import compact as rcompact
    from swbench.reference.world import compile_world
    from swbench.traffic import step_source

    cfg = world.config
    stateful = bool(cfg.get("families"))
    ev = eval_pool(world, pool, device, control=True)
    fold = fold_final(world, pool, traffic, n_steps, ev, device,
                      control=True)
    keep = lambda k: k % every == offset   # noqa: E731
    rep = (replay_devices(world, pool, traffic, n_steps, ev, devices, keep,
                          device, control=True) if stateful else None)
    comp = compile_world(world, "cpu")
    rec = Record(n_steps=n_steps, n_submitted=n_steps)
    B = traffic["batch"]
    cap = cfg["alert_lane_capacity"]
    cmd_cap = cfg.get("command_lane_capacity", 64)
    dropped = 0
    for k in range(n_steps):
        p, shift = step_source(k, traffic)
        if stateful and keep(k):
            prog = {"fired": np.zeros(B, bool),
                    "first_rule": np.full(B, -1, np.int32),
                    "alert_level": np.full(B, -1, np.int32)}
            model = {"fired": np.zeros(B, bool),
                     "first_model": np.full(B, -1, np.int32),
                     "alert_level": np.full(B, -1, np.int32)}
            rows = rep.rows[k]
            for key in prog:
                prog[key][rows] = rep.prog[k][key]
            model["fired"][rows] = rep.model[k]["fired"]
            model["first_model"][rows] = rep.model[k]["first_model"]
            t = lambda d: {n: torch.from_numpy(v) for n, v in d.items()}  # noqa
            lanes = rcompact.compact_alert_lanes(
                t(ev.thr[p]), t(ev.geo[p]), cap, t(prog), t(model)).numpy()
            cmd = _command_lanes(rep.commands[k], cmd_cap,
                                 cfg["max_actuation_policies"])
        else:
            lanes = ev.lanes[p] if ev.lanes[p] is not None else None
            cmd = np.zeros((4, cmd_cap), np.int32)
        if lanes is not None:
            dec = decode_alert_lanes(lanes)
            rec.n_alerts.append(int(dec.thr_fired.sum() + dec.geo_fired.sum()
                                    + dec.prog_fired.sum()
                                    + dec.model_fired.sum()))
            rec.n_dropped.append(dec.dropped_alerts)
            dropped += dec.dropped_alerts
        else:
            # the control knows every row's threshold and geofence alerts
            # and the replayed devices' fires: what it answers in total
            rec.n_alerts.append(int(ev.thr[p]["fired"].sum()
                                    + ev.geo[p]["fired"].sum()
                                    + rep.fires[k]))
            rec.n_dropped.append(0)
        if keep(k):
            rec.kept[k] = {
                "lanes": lanes, "cmd_lanes": cmd,
                "alerts": alert_keys(lanes, pool[p], shift, world,
                                     (comp.programs, comp.models)),
                "fires": (command_fires(cmd, world, comp.policies)
                          if stateful else None)}
    rec.alerts_dropped = dropped
    rec.batches_processed = n_steps
    if stateful:
        # the fired rows it knows of, on the tenant with the events
        tenant = int(np.argmax(fold["tenant_event_count"]))
        fold["tenant_alert_count"] = np.zeros(cfg["max_tenants"], np.int64)
        fold["tenant_alert_count"][tenant] = sum(
            int((ev.thr[k % traffic["pool"]]["fired"]
                 | ev.geo[k % traffic["pool"]]["fired"]).sum())
            + int(rep.extra_rows[k]) for k in range(n_steps))
    return rec, fold, (rep.groups if stateful else None)


def control_numbers(spec: Dict, seed: int, n_steps: int, device
                    ) -> Dict[str, int]:
    """The comparison's numbers for the control of one seed."""
    from swbench import check
    from swbench.reference.replay import eval_pool, fold_final, replay_devices
    from swbench.reference.world import compile_world
    from swbench.traffic import answer_offset, make_pool, sampled_devices
    from swbench.world import make_world

    cfg, traffic = spec["config"], spec["traffic"]
    world = make_world(cfg, seed)
    pool = make_pool(traffic, cfg, seed)
    every = traffic["answer_sample_every"]
    offset = answer_offset(seed, every)
    stateful = bool(cfg.get("families"))
    devices = (sampled_devices(seed, cfg["registered_devices"],
                               traffic["sampled_devices"])
               if stateful else None)
    rec, state, groups = control_record(world, traffic, pool, n_steps,
                                        every, offset, devices, device)
    ev = eval_pool(world, pool, device)
    fold = fold_final(world, pool, traffic, n_steps, ev, device)
    rep = (replay_devices(world, pool, traffic, n_steps, ev, devices,
                          lambda k: k in rec.kept, device)
           if stateful else None)
    comp = compile_world(world, "cpu")
    n, _ = check.compare(world, traffic, pool, rec, state, groups, ev, fold,
                         rep, (comp.programs, comp.models, comp.policies))
    return n


def main(argv=None) -> int:
    from swbench.run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        n = control_numbers(spec, seed, args.steps, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "steps": args.steps, "device": device,
                          "control": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
