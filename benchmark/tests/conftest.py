"""Shared helpers of the benchmark's CPU tests: each cell at a size a test
run holds, on the CPU, through the harness as run.py drives it (all but
its look for a card)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# configuration overrides that cut each configuration to a test's size
SMALL = {
    "wiki-minilm-6m-flat": {"data": {"rows": 20000, "chunks": 4,
                                     "geometry": {"centres": 32}}},
    "wiki-minilm-6m-flat-x4rep": {"data": {"rows": 20000, "chunks": 4,
                                           "geometry": {"centres": 32}}},
    "wikiall-10m-ivf-int8": {
        "data": {"rows": 20000, "dim": 64, "chunks": 4,
                 "geometry": {"centres": 32, "rank": 16}},
        "index": {"params": {"n_lists": 32, "kmeans_sample": 5000},
                  "search_params": {"n_probes": 8}}},
}
SMALL_TRAFFIC = {
    "batch100": {"pool_batches": 3},
}


def small_cell(workload: str, root: Path = ROOT):
    from benchmark.harness import cell as cell_lib

    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in spec["workloads"]}[workload]
    return cell_lib.find_cell(workload, root, overrides={
        "config": SMALL.get(entry["config"], {}),
        "traffic": SMALL_TRAFFIC.get(entry["traffic"], {})})


def run_small(workload: str, *, seed: int = 5, trace: bool = False,
              control: bool = False, fault=None, seconds: float = 0.3,
              root: Path = ROOT):
    """The result line of one small CPU run of `workload`."""
    import torch

    from benchmark.harness import cell as cell_lib

    cell = small_cell(workload, root)
    run = cell_lib.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                       devices=[torch.device("cpu")] * cell.chips,
                       t_start=time.perf_counter(), control=control,
                       fault=fault)
    return cell_lib.run_cell(run)

