"""Times builds of the rule-program kernel's source against each other on one
card, in turns.

    python3 -m sitewhere_tpu_torch.tools.rule_ab [NAME=SOURCE.cu ...]

Run it from the repo root: it takes its world and timers from chip_smoke.py.
Each SOURCE is a version of csrc/rule_programs.cu with the same C interface
(an earlier commit's, or a text edit of the current one); the current
csrc/rule_programs.cu always runs, as "current". All are built together
with the port's nvcc flags. The input is chip_smoke phase 5's: its
stateful world at full size after three steps, and the rule-program
stage's rows at the fourth batch. Each build is held bit for bit against
the plain version there (every slab lane, both counters, the row outputs)
and on chip_smoke's RULE_WORLDS, then timed in turns, in the order given
and then in reverse, per call (chip_smoke.time_cuda) and queued
(chip_smoke.time_cuda_queued), through `eval_rule_programs` with the build
in place of the port's library. Prints one JSON line per build, then the
bound of the rows and the card line; exits 1 if a build differs from the
plain version.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

from sitewhere_tpu_torch.ops import cuda_build
from sitewhere_tpu_torch.ops import stateful
from sitewhere_tpu_torch.tools.geofence_ab import _build
from sitewhere_tpu_torch.tree import tree_map


def main(argv=None) -> int:
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("rule_ab: no CUDA device available", file=sys.stderr)
        return 2
    sources = {"current": cuda_build.CSRC_DIR / "rule_programs.cu"}
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, source = arg.partition("=")
        sources[name] = Path(source)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = {name: stateful.bind_rule_library(ctypes.CDLL(str(path)))
            for name, path in _build(sources).items()}

    engine = cs.build_stateful_world(dev)
    batches = [cs.synthetic_batch(engine.packer, cs.N_REGISTERED, cs.BATCH,
                                  cs.SEED + 500 + s, mm_slots=(1, 2),
                                  t_off_ms=1000 * s) for s in range(4)]
    for batch in batches[:3]:
        engine.materialize_alerts(batch, engine.submit(batch))
    table, rows, limit = cs.rule_step_rows(engine, batches[3])
    S = engine._rule_state.num_state_slots
    B, P = rows["dev"].shape[0], table.num_programs
    n_eff = min(table.num_nodes, limit) if limit else table.num_nodes

    def call(fn, state):
        return fn(table, state, node_limit=limit, **rows)

    ref_state, ref_out = call(stateful.eval_rule_programs_plain,
                              tree_map(torch.clone, engine._rule_state))
    real = stateful._rule_library
    failed = False
    results = {}
    try:
        for name, lib in libs.items():
            stateful._rule_library = lambda lib=lib: lib
            got_state, got_out = call(
                stateful.eval_rule_programs,
                tree_map(torch.clone, engine._rule_state))
            bad = sum(int((getattr(got_state, k) != getattr(ref_state, k))
                          .sum()) for k in ("slab", "gen", "fire_count",
                                            "suppress_count"))
            bad += sum(int((got_out[k] != ref_out[k]).sum())
                       for k in ref_out)
            worlds = cs.rule_worlds_on_the_card(dev)
            failed |= bool(bad or any(worlds.values()))
            results[name] = {"build": name, "mismatches": bad,
                             "world_mismatches": worlds,
                             "plan": stateful.rule_programs_plan(
                                 B, P, n_eff, S, dev.index or 0),
                             "ms_turns": [], "queued_ms_turns": []}
        for name in list(libs) + list(libs)[::-1]:
            stateful._rule_library = lambda lib=libs[name]: lib
            state = tree_map(torch.clone, engine._rule_state)
            fn = lambda: call(stateful.eval_rule_programs, state)  # noqa
            results[name]["ms_turns"].append(cs.time_cuda(fn))
            results[name]["queued_ms_turns"].append(cs.time_cuda_queued(fn))
    finally:
        stateful._rule_library = real
    for row in results.values():
        row["ms"] = statistics.mean(row["ms_turns"])
        row["queued_ms"] = statistics.mean(row["queued_ms_turns"])
        print(json.dumps(row), flush=True)
    bound_ms, bound_by, moved, operations, attach = cs.rule_bound_ms(
        table, rows, limit, S)
    print(json.dumps({"rows": B, "attach_rows": attach, "programs": P,
                      "nodes": n_eff, "state_slots": S, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": moved,
                      "operations": operations}))
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
