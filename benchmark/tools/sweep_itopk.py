"""Sweep itopk_size of a CAGRA cell on the card: recall@10 of every pool
batch against the plain exact reference, and ms a batch, at each size; and
the port's answers against the plain beam-search reference.

    python3 benchmark/tools/sweep_itopk.py --workload cagra10m.batch100 \
        --seeds 1 2 --itopk 32 64 128 256 [--beam-batches 2] \
        [--index-params '{"build_nprobes": 8}' ...]

One index a seed and an --index-params (each merged into the
configuration's index params; none: the configuration's own), built as
the cell builds it; prints a JSON line of the build (seconds by phase, the
card's peak and resident memory), then one a (seed, itopk) with recall@10
over the whole pool. The cell's configuration
takes the fewest of these that reach its recall bar on every seed tried.
With --beam-batches n, the first n pool batches are also searched at the
configuration's own parameters and walked again by
`benchmark/reference/cagra_beam.py` over the index's stored rows, graph and
entry map, one query at a time in float64: the share of queries whose ids
are the reference's (as sets), and the worst rank-by-rank distance gap
over the reference's k-th distance.
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


def beam_agreement(prog, queries, k: int) -> dict:
    """The port's answers for `queries` at the program's search parameters
    against the plain beam-search reference's, over the same index."""
    import torch

    from benchmark.reference import cagra_beam

    ix, sp = prog.index, prog.search_params
    d, i = prog.search(queries)
    t0 = time.perf_counter()
    ref_d, ref_i = cagra_beam.beam_search(
        ix.vectors, ix.graph, ix.n_valid, ix.entry_centroids, ix.entry_rows,
        queries, k, itopk=sp.itopk_size, search_width=sp.search_width,
        num_entry_points=sp.num_entry_points,
        max_iterations=sp.max_iterations)
    ref_s = time.perf_counter() - t0
    d, i = d.double().cpu(), i.long().cpu()
    same = torch.tensor([set(a.tolist()) == set(b.tolist())
                         for a, b in zip(i, ref_i)])
    gap = (d - ref_d).abs() / ref_d[:, -1:]
    return {"queries": int(i.shape[0]),
            "equal_id_sets": float(same.double().mean()),
            "worst_gap_equal_sets": float(gap[same].max()) if same.any()
            else None,
            "worst_gap_all": float(gap.max()),
            "equal_ids_in_order": float((i == ref_i).all(1).double().mean()),
            "reference_s": ref_s}


def sweep(cfg: dict, traffic: dict, seed: int, args, over: dict) -> None:
    """One index of `cfg` from `seed`: its build line, one line an itopk,
    and with --beam-batches the beam reference's agreement."""
    import numpy as np
    import torch

    from benchmark.harness import gen, systems
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    dev = torch.device("cuda", 0)
    batch, n_pool = int(traffic["batch"]), int(traffic["pool_batches"])
    name = torch.cuda.get_device_name(dev)  # CUDA initialised first
    torch.cuda.reset_peak_memory_stats(dev)
    data = gen.Data(cfg["data"], seed, dev)
    prog = systems.Program(cfg, data, [dev])
    gauges = default_registry.snapshot()["gauges"]
    print(json.dumps({
        "seed": seed, "device": name,
        "index_params": over, "build_s": prog.build_s,
        "build_phase_s": {
            g.removeprefix("cagra.build.").removesuffix("_s"): v
            for g, v in gauges.items() if g.startswith("cagra.build.")},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "resident_bytes": torch.cuda.memory_allocated(dev)}), flush=True)
    pool = data.queries(0, batch * n_pool)
    _, ref_i, _ = systems.reference(cfg, data, pool, None)
    ref_i = ref_i.cpu().numpy()
    own = prog.search_params
    for itopk in args.itopk:
        prog.search_params = dataclasses.replace(own, itopk_size=itopk)
        for b in range(n_pool):  # warm-up pass
            prog.search(pool[b * batch:(b + 1) * batch])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ids = np.concatenate([
            prog.search(pool[b * batch:(b + 1) * batch])[1].cpu().numpy()
            for b in range(n_pool)])
        ms = (time.perf_counter() - t0) / n_pool * 1e3
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(ids, ref_i))
        print(json.dumps({"seed": seed, "index_params": over,
                          "itopk": itopk, "search_width": own.search_width,
                          "recall_at_10": hits / ids.size,
                          "ms_per_batch": ms}), flush=True)
    prog.search_params = own
    if args.beam_batches:
        out = beam_agreement(prog, pool[:args.beam_batches * batch],
                             int(cfg["guarantee"]["k"]))
        print(json.dumps(dict(out, seed=seed, itopk=own.itopk_size)),
              flush=True)
    prog.free()
    del prog
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="cagra10m.batch100")
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--itopk", type=int, nargs="+", default=[32, 64, 128, 256])
    p.add_argument("--beam-batches", type=int, default=0)
    p.add_argument("--index-params", type=json.loads, nargs="+",
                   default=[{}])
    args = p.parse_args(argv)

    from benchmark.harness import cell as cell_lib

    cell = cell_lib.find_cell(args.workload, ROOT)
    for over in args.index_params:
        cfg = cell_lib.merge(cell.config, {"index": {"params": over}})
        for seed in args.seeds:
            sweep(cfg, cell.traffic, seed, args, over)
    return 0


if __name__ == "__main__":
    sys.exit(main())
