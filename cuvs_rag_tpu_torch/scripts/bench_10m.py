"""North-star benchmark (BASELINE.json: QPS and build time at recall@10 >=
0.95 on 10M x 768), on one card.

    python -m cuvs_rag_tpu_torch.scripts.bench_10m [--device cuda]

10M x 768 is 30.7 GB of fp32 and 15.4 GB of bf16; int8 (SQ8) storage puts
the layout at 7.7 GB plus padding. The corpus is made chunk by chunk from
a seed, 80 chunks of rows around 4,096 centres at sigma 1.0 (clusters
overlap, as real embeddings do; sigma 0.3 leaves ~2,400 near-equidistant
rows a cluster, where any two quantizations disagree on top-10 ties). The
build streams the chunks (ivf_flat.build_from_chunks) and the exact
ground truth makes them again (common.streamed_ground_truth): nothing but
the index is ever resident. Recall is taken on the very queries the
ground truth is for; the timed batches are distinct copies moved by
0.01 * N(0, 1).
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

N = 10_000_000
D = 768
K = 10
BATCH = 100
N_CHUNKS = 80
N_LISTS = 4096
KMEANS_SAMPLE = 250_000
PROBES = (10, 20, 32)
REPS = 10
SEED = 42
SIGMA = 1.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--chunks", type=int, default=N_CHUNKS)
    p.add_argument("--n-lists", type=int, default=N_LISTS)
    p.add_argument("--kmeans-sample", type=int, default=KMEANS_SAMPLE)
    return p.parse_args(argv)


def setup(args, dev):
    """(chunk_fn, chunk_rows, queries): the corpus' chunk maker and the
    BATCH queries drawn around the same centres."""
    if args.n % args.chunks:
        raise ValueError("--n must divide into --chunks")
    rows = args.n // args.chunks
    geo = common.clustered(SEED, args.n_lists, args.dim, SIGMA, dev)
    queries = common.make_queries(SEED, 0, BATCH, geo, dev)
    return (lambda i: common.make_chunk(SEED, i, rows, geo, dev)), rows, \
        queries


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.ops import ivf_kernels
    from cuvs_rag_tpu_torch.utils.config import (
        IVFFlatParams, IVFFlatSearchParams)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    chunk_fn, rows, queries = setup(args, dev)

    t0 = time.perf_counter()
    gt_d, gt = common.streamed_ground_truth(chunk_fn, args.chunks, rows,
                                            queries, K)
    gt_s = time.perf_counter() - t0
    print(f"exact GT (streamed, bf16) {gt_s:.0f}s", flush=True)

    common.reset_peak_memory(dev)
    t0 = time.perf_counter()
    ix = ivf_flat.build_from_chunks(
        IVFFlatParams(n_lists=args.n_lists, dtype="int8",
                      kmeans_sample=args.kmeans_sample),
        chunk_fn, args.n, args.dim, n_chunks=args.chunks, device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    layout_gb = ix.vectors.nbytes / 1e9
    peak = common.peak_memory_gb(dev)
    route = ivf_kernels.ivf_route(ix.vectors.dtype, args.dim)
    print(f"build {build_s:.0f}s  layout {layout_gb:.2f} GB "
          f"window {ix.max_list_size}  peak {common.gb(peak)}  "
          f"K4 route {route}", flush=True)

    qrs = common.perturbed(queries, SEED + 5000, REPS)
    out = {"gt_s": gt_s, "gt": gt, "gt_distances": gt_d,
           "build_s": build_s, "layout_gb": layout_gb,
           "window": ix.max_list_size, "peak_memory_gb": peak,
           "k4_route": route,
           "queries": queries, "index": ix, "probes": {}}
    for np_ in PROBES:
        sp = IVFFlatSearchParams(n_probes=np_)
        _, i0 = ivf_flat.search(sp, ix, queries, K)
        rec = common.recall(i0.cpu().numpy(), gt, K)
        t = common.time_batches(lambda q: ivf_flat.search(sp, ix, q, K), qrs)
        print(f"nprobe={np_}: {t*1e3:.2f} ms/batch "
              f"{t/BATCH*1e3:.4f} ms/q  qps={BATCH/t:.0f}  "
              f"recall@{K}={rec:.3f}", flush=True)
        out["probes"][np_] = {"ms_per_batch": t * 1e3,
                              "ms_per_query": t / BATCH * 1e3,
                              "qps": BATCH / t, "recall_at_10": rec}
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
