"""Batch-1 (single-query) latency: wall time against device time.

    python -m cuvs_rag_tpu_torch.scripts.bench_batch1 [--device cuda]

The reference's headline metric is per-query latency (2.01 ms A100 / 3.74
ms 2xT4 at 2M). For exact flat and IVF-Flat (10 probes) over 2M x 768
clustered bf16 rows, one query a call:

  * wall/query       one search call including the result's copy to the
                     host (what a caller waiting on each answer sees)
  * pipelined/query  REPS independent calls queued back to back and one
                     synchronize: the host's launches overlap the card's
                     work, so this is the cost a call that cannot overlap
  * device/query     torch.profiler's kernel time a call
                     (eval/roofline.device_ms over every kernel): the
                     engine itself; "not measured" off the card
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

N, D, K, REPS = 2_000_000, 768, 10, 100
N_LISTS = 2000
WALL_CALLS = 20
ALL_KERNELS = ""  # device_ms matches names as substrings: "" sums every kernel


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
    corpus, queries, _ = common.clustered_setup(args.n, args.dim, args.n_lists,
                                                REPS, 0, dev)
    qs = [queries[r:r + 1] for r in range(REPS)]

    fx = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
    ivf = ivf_flat.build(IVFFlatParams(n_lists=args.n_lists,
                                       dtype="bfloat16"), corpus)
    spi = IVFFlatSearchParams(n_probes=10)
    engines = [("flat-exact", lambda q: flat.search(None, fx, q, K)),
               ("ivf-nprobe10", lambda q: ivf_flat.search(spi, ivf, q, K))]
    if hold:
        hold("flat-exact", corpus, queries,
             *flat.search(None, fx, queries, K))
    out = {}
    for name, fn in engines:
        fn(qs[0])[0].cpu()  # warm-up
        t0 = time.perf_counter()
        for q in qs[:WALL_CALLS]:
            fn(q)[0].cpu()
        wall = (time.perf_counter() - t0) / WALL_CALLS

        best = float("inf")
        for _ in range(2):
            common.sync(dev)
            t0 = time.perf_counter()
            for q in qs:
                fn(q)
            common.sync(dev)
            best = min(best, (time.perf_counter() - t0) / REPS)

        dev_ms = None
        if dev.type == "cuda":
            from cuvs_rag_tpu_torch.eval.roofline import device_ms

            dev_ms = device_ms(lambda: fn(qs[0]), (ALL_KERNELS,),
                               calls=REPS)[ALL_KERNELS]
        shown = "not measured" if dev_ms is None else f"{dev_ms:7.3f} ms/q"
        print(f"{name:14s} wall {wall*1e3:7.3f} ms/q | "
              f"pipelined {best*1e3:7.3f} ms/q | device {shown}", flush=True)
        out[name] = {"wall_ms": wall * 1e3, "pipelined_ms": best * 1e3,
                     "device_ms": dev_ms}
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
