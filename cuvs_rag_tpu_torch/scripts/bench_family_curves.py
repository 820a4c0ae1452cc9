"""IVF-Flat against CAGRA operating curves on three corpus geometries.

    python -m cuvs_rag_tpu_torch.scripts.bench_family_curves
        [easy|hard|uniform|both] [N] [--device cuda]

  easy:    well-separated clusters (sigma 0.3, full rank), where IVF
           probes one list and wins outright
  hard:    low intrinsic dimension (r = 64), overlapping clusters (sigma
           1.0 in the subspace): text-embedding geometry, where cluster
           boundaries blur and IVF recall climbs slowly in nprobe
  uniform: one low-rank Gaussian blob (r = 24), no cluster structure: true
           neighbours straddle the k-means cells (IVF-hostile,
           graph-friendly)

For each, both families' recall / latency points and the cheapest config
per family at recall targets 0.95 / 0.99 / 0.999, beside the exact scan's
floor. "both" (the default) and "all" run the three.
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

TARGETS = (0.95, 0.99, 0.999)
D, K, BATCH, REPS = 768, 10, 100, 10
SEED = 42
# a stream a geometry, as the JAX script folds its key for each corpus
GEOMETRY_SEEDS = {"easy": 999, "hard": 555, "uniform": 333}
IVF_PROBES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
CAGRA_POINTS = ((32, 0), (64, 0), (64, 6), (128, 0), (256, 0), (512, 0))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("which", nargs="?", default="both")
    p.add_argument("n", type=int, nargs="?", default=2_000_000)
    common.add_device_arg(p)
    p.add_argument("--dim", type=int, default=D)
    return p.parse_args(argv)


def geometry(kind: str, n_lists: int, d: int, dev):
    seed = SEED + GEOMETRY_SEEDS[kind]
    if kind == "easy":
        return common.clustered(seed, n_lists, d, 0.3, dev)
    if kind == "hard":
        return common.low_rank(seed, n_lists, d, 64, 1.0, dev)
    return common.low_rank(seed, 0, d, 24, 1.0, dev)


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import cagra, flat, ivf_flat
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
        IVFFlatSearchParams)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    n, d = args.n, args.dim
    n_lists = max(64, n // 1000)
    kinds = (["easy", "hard", "uniform"] if args.which in ("both", "all")
             else [args.which])
    out = {}
    for kind in kinds:
        geo = geometry(kind, n_lists, d, dev)
        corpus = common.make_corpus(SEED + GEOMETRY_SEEDS[kind], n, geo, dev)
        queries = common.make_queries(SEED, 0, BATCH, geo, dev)
        qrs = common.perturbed(queries, SEED, REPS)

        fx = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
        gt = flat.search(None, fx, queries, K)[1].cpu().numpy()
        t_exact = common.time_batches(lambda q: flat.search(None, fx, q, K),
                                      qrs)
        print(f"\n=== {kind} corpus, N={n} ===", flush=True)
        print(f"flat exact floor: {t_exact/BATCH*1e3:.4f} ms/q", flush=True)
        del fx

        def measure(search_fn):
            rec = common.recall(search_fn(queries)[1].cpu().numpy(), gt, K)
            return rec, common.time_batches(search_fn, qrs) / BATCH * 1e3

        rows = []
        t0 = time.perf_counter()
        ivf = ivf_flat.build(IVFFlatParams(n_lists=n_lists), corpus)
        common.sync(dev)
        print(f"ivf build {time.perf_counter()-t0:.1f}s", flush=True)
        for npb in IVF_PROBES:
            if npb > ivf.n_lists:
                continue
            sp = IVFFlatSearchParams(n_probes=npb)
            rec, msq = measure(lambda q: ivf_flat.search(sp, ivf, q, K))
            rows.append(("ivf_flat", f"nprobe={npb}", rec, msq))
            print(f"  ivf nprobe={npb:3d}: {msq:7.4f} ms/q  recall={rec:.4f}",
                  flush=True)
            if rec >= 0.9995 and npb >= 8:
                break
        del ivf

        t0 = time.perf_counter()
        cg = cagra.build(CagraParams(graph_degree=32), corpus)
        common.sync(dev)
        print(f"cagra build {time.perf_counter()-t0:.1f}s", flush=True)
        for itopk, iters in CAGRA_POINTS:
            sp = CagraSearchParams(itopk_size=itopk, max_iterations=iters)
            rec, msq = measure(lambda q: cagra.search(sp, cg, q, K))
            rows.append(("cagra", f"itopk={itopk},it={iters}", rec, msq))
            print(f"  cagra itopk={itopk:3d} iters={iters}: {msq:7.4f} ms/q  "
                  f"recall={rec:.4f}", flush=True)
            if rec >= 0.9995:
                break
        del cg

        print(f"--- cheapest config per target ({kind}) ---", flush=True)
        for t in TARGETS:
            ok = [r for r in rows if r[2] >= t]
            if not ok:
                print(f"  target {t}: UNREACHED by approx families "
                      f"(exact floor {t_exact/BATCH*1e3:.3f} ms/q)",
                      flush=True)
                continue
            fam, cfg, rec, msq = min(ok, key=lambda r: r[3])
            print(f"  target {t}: {fam} {cfg} -> {msq:.4f} ms/q "
                  f"(recall {rec:.4f})", flush=True)
        out[kind] = {"exact_ms_per_query": t_exact / BATCH * 1e3,
                     "points": rows}
        del corpus
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
