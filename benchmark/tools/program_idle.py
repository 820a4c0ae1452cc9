"""Where a cell's card waits, by the program's own spans: one traced run of
the cell as run.py makes it, its device events pinned to the program's
`kernel.launch` spans (harness/program_spans), then each card's idle time
credited to the innermost program span open on the host, the harness's
spans around it, or the harness.

    python3 benchmark/tools/program_idle.py --workload ivf10m.batch100 \
        --seed 3141592653 --seconds 30

Prints one JSON line: the card and its power limit, the window, the
queries a second, each card's idle split (raw, by the harness's spans, and
pinned, by program span), the three program-span readers' numbers, the
harness's spans' mean, and the program spans' count, mean, self time and
quantiles by name, in microseconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
os.environ["USE_FLAX"] = "0"  # as run.py: the port alone, no JAX
os.environ["USE_JAX"] = "0"
READERS = ("ivf.search_host_us", "ivf.launch_idle", "replica.fanout_host_us")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import cell as cell_lib
    from benchmark.harness import program_spans, trace

    cell = cell_lib.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    run = cell_lib.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                       trace=True, devices=devices, t_start=T_START)
    out = cell.driver().run(run)
    rec = out.record
    w0, w1 = rec["window"]
    pinned = program_spans.pins(rec)
    spans = program_spans.in_window(rec) or []
    line = {
        "workload": args.workload, "seed": args.seed, "card": power_limit(),
        "correct": all(c["ok"] for c in out.checks.values()),
        "window_s": (w1 - w0) / 1e9,
        "queries_per_s": out.metrics["search_qps"],
        "late_kernels": None if pinned is None else pinned["late"],
        "idle_raw": {c: trace.idle_gaps(rec["events"], rec["window"],
                                        rec["spans"], dev=c)
                     for c in rec["cards"]},
        "idle_pinned": {c: program_spans.idle_split(rec, c)
                        for c in rec["cards"]},
        "readers": {m: cell.reader(m).read(rec) for m in READERS},
        "harness_us": {name: mean_us([(s, e) for n, s, e in rec["spans"]
                                      if n == name])
                       for name in ("search call", "ids to host")},
        "spans": span_table(spans),
    }
    print(json.dumps(line), flush=True)
    return 0


def mean_us(intervals):
    return sum(e - s for s, e in intervals) / max(len(intervals), 1) / 1e3


def span_table(spans):
    """{name: count, mean / self / p50 / p90 / p99 / max us} of the
    window's program spans."""
    from cuvs_rag_tpu_torch.utils import profiling

    out = {}
    for name, g in profiling.summary(spans).items():
        us = sorted((s["end_ns"] - s["start_ns"]) / 1e3 for s in spans
                    if s["name"] == name)
        out[name] = {"count": g["count"], "mean": g["mean_s"] * 1e6,
                     "self": g["self_s"] / g["count"] * 1e6,
                     **{f"p{q}": us[min(len(us) - 1, len(us) * q // 100)]
                        for q in (50, 90, 99)}, "max": us[-1]}
    return out


if __name__ == "__main__":
    sys.exit(main())
