"""Each cell end to end on the CPU at a small size (the harness as run.py
drives it, without its look for a card): the result line's keys, its
metrics by name, and `correct`; run.py's refusals."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, run_small

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def end_to_end(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_line_keys_and_metrics(cell):
    line = run_small(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == end_to_end(cell)
    assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", ["flat6m.batch100", "ivf10m.batch100"])
def test_traced_line(cell):
    line = run_small(cell, trace=True)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # no device on the CPU: no per-layer metric is made up
    assert line["metrics"] == {}


def test_every_per_layer_metric_has_a_reader_and_its_cells():
    names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "layer_metrics"
                / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in names and m["moves"] in end_to_end(cell)


def test_run_exits_without_a_result_where_there_is_no_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flat6m.batch100", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_exits_without_a_result_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flat6m.batch100", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
