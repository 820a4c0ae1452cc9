"""Tuned operating points: for each approximate family, eval/tune.py finds
the cheapest search params at each recall@10 target over a 2M x 768
clustered corpus and the measured frontier is printed.

    python -m cuvs_rag_tpu_torch.scripts.bench_tune [--n 2000000]
        [--targets 0.95 0.99] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-lists", type=int, default=2000,
                   help="centres of the corpus, lists of the IVF indexes")
    ap.add_argument("--targets", type=float, nargs="+", default=[0.95, 0.99])
    ap.add_argument("--families", nargs="+",
                    default=["ivf_flat", "ivf_pq", "cagra"])
    return ap.parse_args(argv)


def run(args, hold=None) -> list:
    from cuvs_rag_tpu_torch.eval import recall as recall_lib
    from cuvs_rag_tpu_torch.eval.tune import tune
    from cuvs_rag_tpu_torch.index import cagra, ivf_flat, ivf_pq
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, IVFFlatParams, IVFPQParams, Metric)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    n, d = args.n, args.dim
    corpus, queries, _ = common.clustered_setup(n, d, args.n_lists,
                                                args.batch, 0, dev, seed=SEED)
    print(f"corpus {n} x {d} (clustered, bf16 on the device); "
          f"batch {args.batch}, k {args.k}", flush=True)
    t0 = time.perf_counter()
    gt = recall_lib.exact_ground_truth_streamed(corpus, queries, args.k,
                                                Metric.SQEUCLIDEAN)
    print(f"exact GT (streamed oracle): {time.perf_counter() - t0:.1f}s",
          flush=True)

    builders = {
        "ivf_flat": lambda: ivf_flat.build(
            IVFFlatParams(n_lists=args.n_lists, dtype="bfloat16"), corpus),
        "ivf_pq": lambda: ivf_pq.build(
            IVFPQParams(n_lists=args.n_lists, pq_dim=d // 8, pq_bits=8),
            corpus),
        "cagra": lambda: cagra.build(CagraParams(), corpus),
    }
    rows = []
    for fam in args.families:
        t0 = time.perf_counter()
        ix = builders[fam]()
        common.sync(dev)
        build_s = time.perf_counter() - t0
        print(f"\n=== {fam} (build {build_s:.1f}s) ===", flush=True)
        for tgt in args.targets:
            t0 = time.perf_counter()
            res = tune(fam, ix, queries, k=args.k, target_recall=tgt,
                       ground_truth=gt)
            tune_s = time.perf_counter() - t0
            if res.met:
                print(f"  target {tgt}: {res.search_params} -> recall "
                      f"{res.point.recall:.3f}, "
                      f"{res.point.latency_ms_per_query:.3f} ms/q "
                      f"({len(res.curve)} configs, {tune_s:.0f}s)",
                      flush=True)
                rows.append((fam, tgt, str(res.search_params),
                             res.point.recall,
                             res.point.latency_ms_per_query))
            else:
                best = max((p.recall for p in res.curve), default=0)
                print(f"  target {tgt}: NOT MET (best {best:.3f}, "
                      f"{len(res.curve)} configs, {tune_s:.0f}s)", flush=True)
                rows.append((fam, tgt, "—", best, float("nan")))
        del ix

    print("\n| family | target | tuned params | recall@10 | ms/query |")
    print("|---|---|---|---|---|")
    for fam, tgt, sp, r, ms in rows:
        print(f"| {fam} | {tgt} | {sp} | {r:.3f} | {ms:.3f} |")
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
