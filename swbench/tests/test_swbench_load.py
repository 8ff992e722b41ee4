"""Every configuration, mix, cell and metric reader loads by its name, and
BENCHMARK.json keeps the benchmark contract's shape."""

import json
import re

import pytest

from swbench.tests.conftest import CELLS, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_by_name(workload):
    from swbench.run import load_cell

    spec = load_cell(workload, ROOT)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["depth"] >= 1
    assert spec["end_to_end"] and spec["per_layer"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    from swbench.run import load_reader

    read = load_reader(metric)
    assert read({}) is None    # nothing to read: no value, never a 0


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("swbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "swbench" / "traffic" / f"{w['traffic']}.json").is_file()
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (ROOT / "swbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_traffic_mixes_are_data():
    for path in (ROOT / "swbench" / "traffic").iterdir():
        mix = json.loads(path.read_text())
        assert abs(sum(mix["mix"].values()) - 1.0) < 1e-9
