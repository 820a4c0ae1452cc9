"""IVF-PQ at 2M x 768: two-level 8-bit against 4-bit codes (both through
K6), with and without the exact re-rank, recall against the exact flat
search.

    python -m cuvs_rag_tpu_torch.scripts.bench_ivf_pq [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

N, D, K, BATCH, REPS = 2_000_000, 768, 10, 100, 10
N_LISTS = 2000


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--n-lists", type=int, default=N_LISTS)
    return p.parse_args(argv)


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import flat, ivf_pq
    from cuvs_rag_tpu_torch.utils.config import (
        FlatParams, IVFPQParams, IVFPQSearchParams)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    # clustered rows: on i.i.d. Gaussian rows every list is equidistant
    corpus, _, qrs = common.clustered_setup(args.n, args.dim, args.n_lists,
                                            BATCH, REPS, dev)
    print("corpus ready", flush=True)
    fx = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
    gt = flat.search(None, fx, qrs[0], K)[1].cpu().numpy()
    del fx

    out = {}
    for bits in (8, 4):
        t0 = time.perf_counter()
        ix = ivf_pq.build(IVFPQParams(n_lists=args.n_lists,
                                      pq_dim=args.dim // 8, pq_bits=bits,
                                      kmeans_sample=100_000), corpus)
        common.sync(dev)
        print(f"pq{bits} build {time.perf_counter()-t0:.1f}s "
              f"codes {ix.codes.nbytes/1e6:.0f} MB", flush=True)
        for rr in (0, 16):
            sp = IVFPQSearchParams(n_probes=20, refine_ratio=rr)
            i0 = ivf_pq.search(sp, ix, qrs[0], K)[1].cpu().numpy()
            rec = common.recall(i0, gt, K)
            t = common.time_batches(lambda q: ivf_pq.search(sp, ix, q, K),
                                    qrs)
            print(f"pq{bits} refine={rr}: {t*1e3:.2f} ms/batch "
                  f"{t/BATCH*1e3:.4f} ms/q  recall@{K}={rec:.3f}", flush=True)
            out[(bits, rr)] = {"ms_per_batch": t * 1e3, "recall": rec}
        del ix
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
