"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 -m swbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's world and traffic pool from the seed, warms the cell's
own shapes through the timed path (its first steps: the eager step and
the capture of its one static key), measures for `--seconds`, checks what
the port answered against the plain reference, and prints one JSON line
last on standard output. With `--trace 0` its metrics are the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics (read by
swbench/metrics/<name>.py). A cell's configuration, traffic and metric
readers are found by the names BENCHMARK.json gives them.
"""

from __future__ import annotations

import argparse
import faulthandler
import importlib.util
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sitewhere_tpu")
TRACE_S = 2.0
# a run that has not ended by then prints every thread's stack on
# standard error and exits 1: a run must end within 360 s
WATCHDOG_S = 330
FLIGHT_CAPACITY = 32768


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell, its configuration and traffic, and the per-layer metrics
    that read something in it, by the names BENCHMARK.json gives."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def load_reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"swbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _flight_rows(engine, t0: float, close: float):
    """Per step dispatched in the window: stage -> ms."""
    recs = engine.flight.export(last_n=engine.flight.capacity)["records"]
    return [{k: v["ms"] for k, v in r["stages"].items()} for r in recs
            if "dispatch" in r["stages"]
            and t0 <= r["stages"]["dispatch"]["begin_s"] <= close]


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             chips: int = 1, tracer=None) -> Dict:
    """One run on `device` ("cuda:0" on the card; the CPU in the tests).
    Returns the result line's dict (with "_checks" and "_facts"). A traced
    run on the card profiles with swbench/trace.py's `Tracer`; `tracer`
    puts another in its place (the tests' stand-in on the CPU)."""
    import torch

    from sitewhere_tpu_torch.runtime.flight import FlightRecorder
    from swbench import check, drive
    from swbench.trace import Tracer
    from swbench.traffic import (
        answer_offset, make_pool, port_batches, sampled_devices)
    from swbench.world import build_engine, make_world

    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stateful = bool(cfg.get("families"))
    t_setup = time.perf_counter()
    logging.getLogger("sitewhere").setLevel(logging.ERROR)
    build_s = 0.0
    if on_card:
        from sitewhere_tpu_torch.ops import cuda_build

        t = time.perf_counter()
        cuda_build.build(["geofence"] + (["rule_programs"] if stateful
                                         else []))
        build_s = time.perf_counter() - t
    if tracer is None and trace and on_card:
        tracer = Tracer(seconds, TRACE_S)
    if tracer is not None:
        tracer.prime(dev)
    world = make_world(cfg, seed)
    engine = build_engine(world, traffic["batch"], dev)
    engine.flight = FlightRecorder(capacity=FLIGHT_CAPACITY)
    pool = make_pool(traffic, cfg, seed)
    batches = port_batches(pool)
    every = traffic["answer_sample_every"]
    offset = answer_offset(seed, every)
    rec = drive.run_closed(engine, traffic, pool, batches, seconds,
                           stateful, every, offset, tracer=tracer)
    setup_s = rec.t0 - t_setup
    rec.alerts_dropped = engine.alerts_dropped
    rec.batches_processed = engine.batches_processed
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    flight = _flight_rows(engine, rec.t0, rec.close)
    summary = tracer.summary() if tracer else None
    canon = engine.canonical_state()
    port_state = {f: getattr(canon, f).numpy()
                  for f in canon.__dataclass_fields__}
    port_groups, devices = None, None
    if stateful:
        devices = sampled_devices(seed, cfg["registered_devices"],
                                  traffic["sampled_devices"])
        idx = torch.from_numpy(devices).to(dev)
        port_groups = {}
        for name in ("rule", "model", "actuation"):
            group = getattr(engine, f"_{name}_state")
            port_groups[f"{name}.slab"] = group.slab[idx].cpu().numpy()
            port_groups[f"{name}.gen"] = group.gen.cpu().numpy()
    engine.stop()
    del engine, canon, batches
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the port is freed
    t_ref = time.perf_counter()
    from swbench.reference.replay import eval_pool, fold_final, replay_devices
    from swbench.reference.world import compile_world

    ev = eval_pool(world, pool, dev)
    fold = fold_final(world, pool, traffic, rec.n_submitted, ev, dev)
    rep = None
    if stateful:
        rep = replay_devices(world, pool, traffic, rec.n_submitted, ev,
                             devices, lambda k: k in rec.kept, dev)
    comp = compile_world(world, "cpu")
    specs = (comp.programs, comp.models, comp.policies)
    n, facts = check.compare(world, traffic, pool, rec, port_state,
                             port_groups, ev, fold, rep, specs)
    facts["reference_s"] = time.perf_counter() - t_ref
    correct = check.verdict(n) and rec.n_steps > 0

    B = traffic["batch"]
    result = {"correct": bool(correct), "attempted": rec.window_steps,
              "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": chips, "memory_peak_bytes": peak}}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    units.update({m["name"]: m["unit"] for m in spec["per_layer"]})
    if not trace:
        values = {"setup_s": setup_s,
                  "events_per_s": rec.window_steps * B / seconds}
        for m in spec["end_to_end"]:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        ctx = {"B": B, "Z": cfg["zones"], "V": cfg["zone_vertices"],
               "p_in": float(np.mean(ev.p_in)), "flight": flight,
               "trace": None}
        if summary is not None:
            ctx["trace"] = dict(summary, steps=int(sum(
                v[1] for k, v in summary["kernels"].items()
                if "points_in_zones" in k)))
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            # the steps a second the traced part ran, beside the rest of
            # the window's (less the profiler's switches): a trace that
            # slows the port reads it wrong
            rest_s = seconds - summary["window_s"] - summary["switch_s"]
            result["trace_rates"] = {
                "traced_steps_per_s": summary["traced_steps"]
                / summary["window_s"],
                "untraced_steps_per_s": (rec.window_steps
                                         - summary["traced_steps"]) / rest_s,
                "switch_s": summary["switch_s"]}
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in summary["device_ops"]],
                "idle_gaps": [[k, v] for k, v in summary["idle_gaps"]]}
        if stateful:
            ctx["rules"] = {"attach": float(np.mean(ev.attach_rows)),
                            "opcode": comp.params.programs.opcode.numpy(),
                            "mm_idx": comp.params.programs.mm_idx.numpy(),
                            "node_limit": comp.flags["program_node_limit"],
                            "S": cfg["rule_program_state_slots"]}
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
    result["build_s"] = build_s
    result["reference"] = facts
    result["_checks"] = n
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    # every cache of the program at a fixed path inside the checkout
    cache = BENCH_DIR / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    spec = load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"swbench: the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", chips=chips)
    found = forbidden_modules()
    if found:
        log(f"swbench: the run loaded {found}; no result")
        return 3
    n = result.pop("_checks")
    from swbench.check import LIMITS, check_lines

    result["card"] = card_line()
    result["checks"] = {k: {"value": n[k], "limit": LIMITS[k]} for k in LIMITS}
    for line in check_lines(n):
        log(line)
    print(json.dumps(result), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
