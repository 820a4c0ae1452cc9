"""Top-2000 retrieval A/B: the reference's SearchConfig.top_k=2000 default.

    python -m cuvs_rag_tpu_torch.scripts.bench_topk_large [K] [--device cuda]

Exact flat search at k = 2,000 over 2M x 768 bf16 N(0, 1) rows, 100
queries a batch: the certified large-k kernel (K3: per-class top-R planes
and an exactness certificate, ops/flat_kernels.flat_topk_large) against
the library route (the exact tile scan, one fp32 product and torch.topk a
tile: ops/topk.flat_topk_search) and against approx=True (which keeps the
exact scan at large k), with their id agreement.
"""

from __future__ import annotations

import argparse

from cuvs_rag_tpu_torch.scripts import common

N, D, BATCH, REPS = 2_000_000, 768, 100, 5
SEED = 42


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("k", type=int, nargs="?", default=2000)
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    return p.parse_args(argv)


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels
    from cuvs_rag_tpu_torch.utils.config import FlatParams, FlatSearchParams

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    k = args.k
    geo = common.Gaussian(args.dim)
    corpus = common.make_corpus(SEED, args.n, geo, dev)
    ix = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
    print(f"corpus ready; k={k}  r_planes="
          f"{flat_kernels.default_r_planes(k, 1024)}", flush=True)
    qrs = [common.make_queries(SEED, 100 + r, BATCH, geo, dev)
           for r in range(REPS)]

    def timed(name, fn):
        d, ids = fn(qrs[0])
        t = common.time_batches(fn, qrs)
        print(f"{name:28s} {t*1e3:8.2f} ms/batch  {t/BATCH*1e3:.4f} ms/q",
              flush=True)
        return d, ids, t

    d_new, i_new, t_new = timed("large-k kernel (certified)",
                                lambda q: flat.search(None, ix, q, k))
    if hold:
        hold("large_k", ix.vectors[:args.n], qrs[0], d_new, i_new)
    _, i_lib, t_lib = timed("torch exact scan",
                            lambda q: flat.search_scores(None, ix, q, k,
                                                         use_kernel=False))
    sp = FlatSearchParams(approx=True)
    _, _, t_apx = timed("approx=True (exact scan)",
                        lambda q: flat.search(sp, ix, q, k))
    agree = common.recall(i_new.cpu().numpy(), i_lib.cpu().numpy(), k)
    print(f"kernel vs torch exact id agreement@{k}: {agree:.5f}", flush=True)
    return {"kernel_ms": t_new * 1e3, "library_ms": t_lib * 1e3,
            "approx_ms": t_apx * 1e3, "agreement": agree}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
