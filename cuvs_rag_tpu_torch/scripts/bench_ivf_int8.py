"""IVF-Flat at 2M x 768: bf16 against int8 SQ8 storage (both through K4),
recall against the exact flat search.

    python -m cuvs_rag_tpu_torch.scripts.bench_ivf_int8 [--device cuda]
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
    from cuvs_rag_tpu_torch.index import flat, ivf_flat
    from cuvs_rag_tpu_torch.utils.config import (
        FlatParams, IVFFlatParams, IVFFlatSearchParams)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    corpus, _, qrs = common.clustered_setup(args.n, args.dim, args.n_lists,
                                            BATCH, REPS, dev)
    print("corpus ready", flush=True)
    fx = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
    gt = flat.search(None, fx, qrs[0], K)[1].cpu().numpy()
    del fx

    out = {}
    for dtype in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        ix = ivf_flat.build(IVFFlatParams(n_lists=args.n_lists, dtype=dtype,
                                          kmeans_sample=100_000), corpus)
        common.sync(dev)
        print(f"{dtype} build {time.perf_counter()-t0:.1f}s "
              f"lists {ix.vectors.nbytes/1e6:.0f} MB", flush=True)
        for np_ in (10, 20):
            sp = IVFFlatSearchParams(n_probes=np_)
            i0 = ivf_flat.search(sp, ix, qrs[0], K)[1].cpu().numpy()
            rec = common.recall(i0, gt, K)
            t = common.time_batches(lambda q: ivf_flat.search(sp, ix, q, K),
                                    qrs)
            print(f"{dtype} nprobe={np_}: {t*1e3:.2f} ms/batch "
                  f"{t/BATCH*1e3:.4f} ms/q  recall@{K}={rec:.3f}", flush=True)
            out[(dtype, np_)] = {"ms_per_batch": t * 1e3, "recall": rec}
        del ix
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
