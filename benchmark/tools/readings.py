"""Read the numbers `correct` compares, on the card, for many seeds in one
process: the program's (sound runs, the lower readings) and, with
--control, the configuration's control's (the upper readings).

    python3 benchmark/tools/readings.py --workload flat6m.batch100 \
        --seeds 11 12 13 --seconds 1 [--control]

Each seed is a run of the cell as run.py makes it (data, build, window,
reference), with a window of --seconds that covers at least the whole pool
of a batch mix once; the control answers each pool batch once. Prints one
JSON line a seed: the numbers and whether they passed the limits in force.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import cell as cell_lib

    cell = cell_lib.find_cell(args.workload, ROOT)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = cell_lib.Run(cell=cell, seed=seed, seconds=args.seconds,
                           trace=False, devices=devices, t_start=t0,
                           control=args.control)
        out = cell.driver().run(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "numbers": out.numbers,
                          "passed": {k: v["ok"]
                                     for k, v in out.checks.items()},
                          "run_s": time.perf_counter() - t0}), flush=True)
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
