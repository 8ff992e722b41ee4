"""Shared helpers of the benchmark's tests: tiny specs of every cell."""

import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def tiny_spec(workload: str):
    """The cell as BENCHMARK.json names it, cut to a size a CPU test holds:
    2,000 devices, 16 zones, batches of 512, a pool of 4."""
    from swbench.run import load_cell

    spec = copy.deepcopy(load_cell(workload, ROOT))
    spec["config"].update(max_devices=2048, registered_devices=2000,
                          zones=16)
    tr = spec["traffic"]
    tr.update(batch=512, pool=4, warmup_steps=2, answer_sample_every=2)
    if "sampled_devices" in tr:
        tr["sampled_devices"] = 200
    return spec


CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
