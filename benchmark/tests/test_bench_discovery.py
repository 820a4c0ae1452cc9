"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new entries alone: in a copy of the benchmark, with no
file that was there edited, the new cell runs and reports the new
metric."""

import hashlib
import json
import shutil

from conftest import ROOT, run_small


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_cell_and_metric_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"

    cfg = json.loads((b / "configs" / "wiki-minilm-6m-flat.json").read_text())
    cfg.update(name="tiny-flat-int8", reduced=["rows"],
               placement={"kind": "shard", "devices": 4})
    cfg["data"].update(rows=12000, chunks=3)
    cfg["index"]["params"]["dtype"] = "int8"
    cfg["guarantee"]["checks"] = {"invalid": {"max": 0},
                                  "recall_at_10": {"min": 0.5}}
    (b / "configs" / "tiny-flat-int8.json").write_text(json.dumps(cfg))
    (b / "traffic" / "batch7.json").write_text(json.dumps(
        {"driver": "closed_batches", "batch": 7, "pool_batches": 2}))
    (b / "layer_metrics" / "harness.calls.py").write_text(
        "def read(rec):\n    return float(len(rec['info']['calls']))\n")
    spec["configs"].append({"name": "tiny-flat-int8", "source": "x",
                            "file": "benchmark/configs/tiny-flat-int8.json",
                            "reduced": ["rows"], "why": "a test"})
    spec["workloads"].append({"name": "tiny.batch7", "config":
                              "tiny-flat-int8", "traffic": "batch7",
                              "chips": 4, "why": "a test"})
    spec["per_layer"].append({"name": "harness.calls", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "harness", "moves": "search_qps",
                              "workloads": ["tiny.batch7"]})
    for m in spec["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("tiny.batch7")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    line = run_small("tiny.batch7", root=tmp_path)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"search_qps", "setup_s"}
    traced = run_small("tiny.batch7", root=tmp_path, trace=True)
    assert traced["metrics"]["harness.calls"]["value"] >= 2
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    # the cells already there are untouched by the additions
    assert run_small("flat6m.batch100", root=tmp_path)["correct"] is True
