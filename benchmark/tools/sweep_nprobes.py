"""Sweep n_probes of an IVF cell on the card: recall@10 of every pool
batch against the plain reference, and ms a batch, at each count.

    python3 benchmark/tools/sweep_nprobes.py --workload ivf10m.batch100 \
        --seeds 1 2 --probes 8 12 16 20 24 32 \
        [--geometry '{"kind": "low_rank", "centres": 0, "rank": 16, "sigma": 1.0}']

One index a seed (and --geometry, where given, in place of the
configuration's), built as the cell builds it; prints one JSON line a
(seed, n_probes) with recall@10 over the whole pool and the distinct lists
a batch probes. The cell's configuration fixes the fewest probes that
reach its recall bar on every seed tried.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="ivf10m.batch100")
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--probes", type=int, nargs="+",
                   default=[8, 12, 16, 20, 24, 32, 40])
    p.add_argument("--geometry", type=json.loads, default=None)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.harness import cell as cell_lib
    from benchmark.harness import gen, systems

    closed_batches = cell_lib.load_module(
        cell_lib.BENCH / "drivers" / "closed_batches.py", "closed_batches")

    over = {"config": {"data": {"geometry": args.geometry}}} \
        if args.geometry else None
    cell = cell_lib.find_cell(args.workload, ROOT, over)
    if args.geometry:  # the whole block, not merged key by key
        cell.config["data"]["geometry"] = args.geometry
    dev = torch.device("cuda", 0)
    batch = int(cell.traffic["batch"])
    n_pool = int(cell.traffic["pool_batches"])
    k = int(cell.config["guarantee"]["k"])
    for seed in args.seeds:
        data = gen.Data(cell.config["data"], seed, dev)
        prog = systems.Program(cell.config, data, [dev])
        pool = data.queries(0, batch * n_pool)
        ref_d, ref_i, _ = systems.reference(cell.config, data, pool, None)
        ref_i = ref_i.cpu().numpy()
        for n_probes in args.probes:
            prog.search_params = dataclasses.replace(prog.search_params,
                                                     n_probes=n_probes)
            ids = []
            for b in range(n_pool):  # warm-up pass
                prog.search(pool[b * batch:(b + 1) * batch])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(n_pool):
                _, i = prog.search(pool[b * batch:(b + 1) * batch])
                ids.append(i.cpu().numpy())
            ms = (time.perf_counter() - t0) / n_pool * 1e3
            ids = np.concatenate(ids)
            summary = closed_batches.index_summary(prog, batch)
            lists = closed_batches.probed_lists(
                summary, list(pool.split(batch)))
            hits = sum(len(set(a.tolist()) & set(b.tolist()))
                       for a, b in zip(ids, ref_i))
            print(json.dumps({"seed": seed, "n_probes": n_probes,
                              "recall_at_10": hits / ids.size,
                              "ms_per_batch": ms,
                              "build_s": prog.build_s,
                              "geometry": cell.config["data"]["geometry"],
                              "lists": lists}), flush=True)
        prog.free()
        del prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
