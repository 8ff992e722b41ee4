"""Times versions of the anomaly-model stage (ops/anomaly.py) against each
other on one card, in turns.

    python3 -m sitewhere_tpu_torch.tools.anomaly_ab [NAME=ANOMALY.py ...]

Run it from the repo root: it takes its world and timers from chip_smoke.py.
Each ANOMALY.py is a version of sitewhere_tpu_torch/ops/anomaly.py (an
earlier commit's, e.g. `git show <commit>:sitewhere_tpu_torch/ops/
anomaly.py`), loaded as a module of its own; the current one always runs,
as "current". The input is chip_smoke phase 5's: its stateful world at full
size after three steps, and stage 3c's rows at the fourth batch (the
step's sorted row view). Each version's `eval_anomaly_models` is timed in
turns, in the order given and then in reverse, per call
(chip_smoke.time_cuda: one call between CUDA events, launches included,
which is chip_smoke's 3c span without the stages around it), on a copy of
the engine's model state each call. Prints one JSON line per version with
its slab bits and fire outputs held against the current version's
(`mismatches`), and the device events (kernels, copies, memsets) and
device busy ms of one call under the profiler, then the card line.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys

import torch

from sitewhere_tpu_torch.ops import anomaly
from sitewhere_tpu_torch.tree import tree_map


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"sitewhere_tpu_torch.ops._anomaly_ab_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    import chip_smoke as cs
    from sitewhere_tpu_torch.ops.pack import batch_to_blob, blob_to_batch
    from sitewhere_tpu_torch.pipeline.step import (
        fold_device_state, stateful_rows, validate_batch)

    if not torch.cuda.is_available():
        print("anomaly_ab: no CUDA device available", file=sys.stderr)
        return 2
    versions = {"current": anomaly}
    for arg in sys.argv[1:] if argv is None else argv:
        name, _, path = arg.partition("=")
        versions[name] = _load(name, path)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    engine = cs.build_stateful_world(dev)
    batches = [cs.synthetic_batch(engine.packer, cs.N_REGISTERED, cs.BATCH,
                                  cs.SEED + 500 + s, mm_slots=(1, 2),
                                  t_off_ms=1000 * s) for s in range(4)]
    for batch in batches[:3]:
        engine.materialize_alerts(batch, engine.submit(batch))
    params, state = engine._ensure_params(), engine.state
    blob = torch.from_numpy(batch_to_blob(batches[3])).to(dev)
    b, _, _ = validate_batch(params, blob_to_batch(blob), state.num_devices)
    rows, _, _ = stateful_rows(params, fold_device_state(state, b), b)

    def call(module):
        model_state = tree_map(torch.clone, engine._model_state)
        return module.eval_anomaly_models(params.models, model_state,
                                          **rows)

    ref_state, ref_out = call(anomaly)
    results = {}
    for name, module in versions.items():
        got_state, got_out = call(module)
        bad = int((got_state.slab != ref_state.slab).sum())
        bad += sum(int((got_out[k] != ref_out[k]).sum())
                   for k in ("fired", "first_model", "alert_level"))
        results[name] = {"version": name, "mismatches": bad,
                         "rows": int(rows["dev"].shape[0]),
                         "attach_rows": int(rows["attach"].sum()),
                         "models": int(params.models.num_models),
                         "ms_turns": []}
    for name in list(versions) + list(versions)[::-1]:
        module = versions[name]
        results[name]["ms_turns"].append(cs.time_cuda(lambda: call(module)))
    for name, module in versions.items():
        model_state = tree_map(torch.clone, engine._model_state)
        _, _, on_device, busy_ms, _ = cs.device_profile(
            lambda: module.eval_anomaly_models(params.models, model_state,
                                               **rows))
        results[name]["device_events"] = sum(e.count for e in on_device)
        results[name]["device_busy_ms"] = busy_ms
    for row in results.values():
        row["ms"] = statistics.mean(row["ms_turns"])
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
