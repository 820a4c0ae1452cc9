"""One run of one cell: find its configuration, traffic mix, driver and
per-layer readers by name, run the driver, reduce the trace, and make the
result line.

Everything that belongs to one configuration, one mix or one per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives it:

  configs/<config>.json         a deployment: data, index, placement,
                                guarantee (the numbers `correct` holds it
                                to, with their limits), control
  traffic/<traffic>.json        a mix: {"driver": <name>, its parameters}
  drivers/<driver>.py           a loop kind: run(run) -> Outcome
  layer_metrics/<metric>.py     a reader: read(record) -> number or None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "benchmark"
OUT = ROOT / "build" / "benchmark"  # traced runs' records (gitignored)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with `over` merged in, nested dicts key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_module(path: Path, name: str):
    """A module from a file under the benchmark, loaded by path (its name
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_dyn_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names, loaded."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_root: Path = BENCH

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench_root / "drivers" / f"{name}.py", name)

    def reader(self, metric: str):
        return load_module(self.bench_root / "layer_metrics" / f"{metric}.py",
                           metric)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric` (every cell, without a workloads
    list)."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(workload: str, root: Path = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, its configuration and
    traffic merged with `overrides` {"config": {...}, "traffic": {...}}
    (tests at small sizes)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{entry['traffic']}.json")
    overrides = overrides or {}
    return Cell(
        name=workload, entry=entry,
        config=merge(config, overrides.get("config")),
        traffic=merge(traffic, overrides.get("traffic")),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if reports(m, workload)],
        bench_root=root / "benchmark")


@dataclasses.dataclass
class Run:
    """What a driver is handed: the cell, the seed, the window, whether to
    trace, the devices, and (tools and tests) a control run or a fault."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    devices: list
    t_start: float  # perf_counter() when the process started its set-up
    control: bool = False
    fault: Optional[Callable] = None  # search fn -> broken search fn

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver returns. `metrics` holds the end-to-end metrics it
    measured (not setup_s); `checks` the judged comparison; `record` what
    the per-layer readers read (events, window, spans, counters, info)."""

    setup_s: float
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, dict]
    memory_peak_bytes: int
    record: dict
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)


def device_info(devices, memory_peak_bytes: int) -> dict:
    import torch

    cuda = [d for d in devices if d.type == "cuda"]
    kind = torch.cuda.get_device_name(cuda[0]) if cuda else "cpu"
    return {"platform": "gpu" if cuda else "cpu", "kind": kind,
            "count": len(set(str(d) for d in devices)),
            "memory_peak_bytes": int(memory_peak_bytes)}


def memory_peak(devices) -> int:
    import torch

    return max([torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"] or [0])


def layer_metrics(cell: Cell, record: dict, log) -> Dict[str, dict]:
    """Every per-layer metric this cell reports that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(record)
        if value is None:
            log(f"{m['name']}: nothing to read in this run's trace")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end_value(name: str, outcome: Outcome) -> float:
    """The driver's quantity an end-to-end metric names: `<quantity>` or
    `<quantity>.<tag>` (one quantity under two names, so that cells whose
    runs spread differently can take bounds of their own)."""
    if name == "setup_s":
        return outcome.setup_s
    return outcome.metrics[name.split(".")[0]]


def run_cell(run: Run) -> dict:
    """Run the cell once; the result line as a dict (without printing)."""
    cell = run.cell
    outcome: Outcome = cell.driver().run(run)
    dev = device_info(run.devices, outcome.memory_peak_bytes)
    rec = outcome.record
    if run.trace:
        metrics = layer_metrics(cell, rec, run.log)
        from benchmark.harness import trace as tr

        events, window = rec.get("events", []), rec["window"]
        cards = rec.get("cards") or [0]
        busy = [tr.busy_ns(events, c) / 1e9 for c in cards]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = (window[1] - window[0]) / 1e9
        breakdown = {
            "device_ops": tr.top_ops(events),
            "idle_gaps": tr.idle_gaps(events, window, rec.get("spans", []),
                                      dev=cards[0]),
        }
        tr.write_record(OUT / f"{cell.name}.seed{run.seed}.trace.json", {
            "spans": rec.get("spans", [])[:200000], "window": window,
            "counters": rec.get("counters", {}),
            "info": {k: v for k, v in rec.get("info", {}).items()
                     if isinstance(v, (int, float, str))},
            "metrics": metrics, "breakdown": breakdown, "device": dev})
    else:
        metrics = {m["name"]: {"value": end_to_end_value(m["name"], outcome),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    correct = bool(outcome.checks) and all(c["ok"]
                                           for c in outcome.checks.values())
    line = {"correct": correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": _json_number(v["value"]),
                          "limit": v["limit"]}
                      for k, v in outcome.checks.items()}
    return line


def _json_number(v):
    """A compared number as strict JSON takes it: an infinite reading (an
    invalid answer) as the largest double, a missing one as null."""
    if v is None or v != v:
        return None
    return max(min(v, 1.7976931348623157e308), -1.7976931348623157e308)
