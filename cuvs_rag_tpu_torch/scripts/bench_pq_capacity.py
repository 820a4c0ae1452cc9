"""PQ capacity benchmark: a corpus past device memory served from one card.

    python -m cuvs_rag_tpu_torch.scripts.bench_pq_capacity --n 60000000 \\
        --opq --refine-external 16 --memmap-store /path/store.bin

The chunked PQ build (ivf_pq.build_from_chunks) keeps only the code layout
on the device: at store_raw=False a 768-d row costs pq_dim bytes plus the
int32 id and an fp32 correction, so 60M x 768 (92 GB of bf16) leaves its
raw rows off the card. The corpus is made chunk by chunk on the card from
a seed: the build streams the chunks, the exact ground truth makes them
again, and recall stays certified at sizes where no raw store fits the
device. The exact re-rank ("refine") reads candidate rows from outside
the device: made again on the card (--refine-external alone), a host-RAM
bf16 array (--host-store) or a disk-backed MemmapStore (--memmap-store).
Both stores are the card's own rows, copied chunk by chunk to the host
(peak host memory one chunk beyond the store), and a sample of stored rows
is held bit-equal to the chunks they came from.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cuvs_rag_tpu_torch.scripts import common

SEED = 42
SAMPLE_CHUNKS = 3  # chunks whose stored rows are held against the card's
SAMPLE_ROWS = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=30_000_000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--chunk-rows", type=int, default=250_000)
    p.add_argument("--n-lists", type=int, default=8192)
    p.add_argument("--pq-bits", type=int, default=8)
    p.add_argument("--pq-dim", type=int, default=0, help="0 = dim // 8")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--probes", type=int, nargs="+", default=[20, 40, 64])
    p.add_argument("--kmeans-sample", type=int, default=250_000)
    p.add_argument("--store-raw", action="store_true",
                   help="keep the raw store on the device for refine (only "
                        "fits small --n)")
    p.add_argument("--refine", type=int, default=0,
                   help="refine_ratio when --store-raw is set")
    p.add_argument("--refine-external", type=int, default=0,
                   help="out-of-core refine: refine_ratio served through "
                        "ivf_pq.search(fetch_rows=...); candidate rows come "
                        "from outside the device (chunks made again on the "
                        "card, or the stores below). Only codes stay on the "
                        "device")
    p.add_argument("--host-store", action="store_true",
                   help="with --refine-external: serve fetch_rows from a "
                        "host-RAM bf16 array holding the card's rows (n * "
                        "dim * 2 bytes) and re-rank on the host "
                        "(ivf_pq.search(host_rerank=True)): only candidate "
                        "ids leave the device")
    p.add_argument("--memmap-store", type=str, default="",
                   help="with --refine-external: path of a disk-backed bf16 "
                        "row store (rag/host_store.MemmapStore) written "
                        "chunk by chunk from the card (peak host memory one "
                        "chunk; capacity bounded by disk); re-rank on the "
                        "host. An existing store of the same shape at the "
                        "path is reused once its sample rows match")
    p.add_argument("--opq", action="store_true",
                   help="train an OPQ rotation")
    p.add_argument("--intrinsic-dim", type=int, default=64,
                   help="the corpus lies near an r-dim subspace of R^dim "
                        "(text embeddings' spectra decay fast). 0 = "
                        "full-rank pure-noise residuals, the adversarial "
                        "floor for ADC-only PQ")
    return p.parse_args(argv)


def geometry(args, dev):
    r = args.intrinsic_dim
    if r:
        # centres and noise in an r-dim subspace plus a small full-rank
        # jitter: clusters overlap (sigma 1.0), residuals stay codable
        return common.low_rank(SEED, args.n_lists, args.dim, r, 1.0, dev)
    return common.clustered(SEED, args.n_lists, args.dim, 1.0, dev)


def check_store(store_rows, chunk_fn, n_chunks: int, rows: int) -> int:
    """Hold SAMPLE_ROWS stored rows of SAMPLE_CHUNKS chunks bit-equal to the
    card's chunks; returns the rows held. store_rows(ids) -> float32 (bf16
    widens to fp32 exactly, so equal fp32 bits are equal bf16 bits)."""
    rng = np.random.default_rng(0)
    held = 0
    for i in sorted(set(np.linspace(0, n_chunks - 1, SAMPLE_CHUNKS,
                                    dtype=int).tolist())):
        local = np.sort(rng.choice(rows, min(SAMPLE_ROWS, rows),
                                   replace=False))
        c = chunk_fn(i)
        want = c[torch.as_tensor(local, device=c.device)].float().cpu()
        got = np.ascontiguousarray(store_rows(i * rows + local), np.float32)
        if not np.array_equal(got.view(np.uint32),
                              want.numpy().view(np.uint32)):
            raise AssertionError(f"stored rows of chunk {i} differ from the "
                                 "card's")
        held += len(local)
    return held


def refine_source(args, chunk_fn, n_chunks: int, rows: int, dev):
    """(fetch_rows, host_rerank, note) of --refine-external's source."""
    from cuvs_rag_tpu_torch.rag.host_store import (
        MemmapStore, _from_bf16_bits, _to_bf16_bits, materialize_from_chunks)

    n, d = args.n, args.dim
    if args.memmap_store:
        store = None
        if os.path.exists(MemmapStore._sidecar(args.memmap_store)):
            st = MemmapStore.open(args.memmap_store)
            if st.shape == (n, d) and st.dtype == "bfloat16":
                store = st
                print(f"reusing memmap store {args.memmap_store} "
                      f"({st._mm.nbytes/1e9:.1f} GB)", flush=True)
        if store is None:
            t0 = time.perf_counter()
            store = materialize_from_chunks(args.memmap_store, chunk_fn, n, d,
                                            n_chunks, dtype="bfloat16",
                                            log=20)
            print(f"memmap store materialized {store._mm.nbytes/1e9:.1f} GB "
                  f"in {time.perf_counter()-t0:.0f}s", flush=True)
        held = check_store(store.fetch_rows, chunk_fn, n_chunks, rows)
        return store.fetch_rows, True, f"memmap store ({held} rows held)"
    if args.host_store:
        t0 = time.perf_counter()
        host = np.empty((n, d), np.uint16)
        for i in range(n_chunks):
            host[i * rows:(i + 1) * rows] = _to_bf16_bits(
                chunk_fn(i).float().cpu().numpy())
        print(f"host store materialized {host.nbytes/1e9:.1f} GB "
              f"in {time.perf_counter()-t0:.0f}s", flush=True)

        def host_rows(uids):
            return _from_bf16_bits(host[uids])

        held = check_store(host_rows, chunk_fn, n_chunks, rows)
        return host_rows, True, f"host store ({held} rows held)"

    def fetch_rows(uids):
        # the rows of each touched chunk, made again on the device
        out = np.empty((len(uids), d), np.float32)
        cid = uids // rows
        for i in np.unique(cid):
            sel = np.where(cid == i)[0]
            local = torch.as_tensor(uids[sel] % rows, device=dev)
            out[sel] = chunk_fn(int(i))[local].float().cpu().numpy()
        return out

    return fetch_rows, False, "chunks made again on the device"


def exact_distance_error(queries: torch.Tensor, dist, ids, fetch_rows):
    """Largest |reported - exact| squared-L2 distance of the returned ids,
    the exact one scored in fp64 from the refine source's rows, and the
    distances' largest magnitude."""
    ids = common.to_numpy(ids)
    dist = common.to_numpy(dist).astype(np.float64)
    live = ids >= 0
    rows = fetch_rows(np.unique(ids[live])).astype(np.float64)
    pos = np.searchsorted(np.unique(ids[live]), ids[live])
    q = queries.double().cpu().numpy()
    qi = np.nonzero(live)[0]
    exact = ((q[qi] - rows[pos]) ** 2).sum(axis=1)
    return float(np.abs(dist[live] - exact).max(initial=0.0)), \
        float(np.abs(exact).max(initial=0.0))


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    n, d = args.n, args.dim
    if n % args.chunk_rows:
        raise SystemExit("--n must be a multiple of --chunk-rows")
    n_chunks, rows = n // args.chunk_rows, args.chunk_rows
    geo = geometry(args, dev)

    def chunk_fn(i):
        return common.make_chunk(SEED, i, rows, geo, dev)

    queries = common.make_queries(SEED, 0, args.batch, geo, dev)

    t0 = time.perf_counter()
    gt_d, gt = common.streamed_ground_truth(chunk_fn, n_chunks, rows, queries,
                                            args.k)
    print(f"exact GT (streamed, bf16) {time.perf_counter()-t0:.0f}s",
          flush=True)

    params = IVFPQParams(
        n_lists=args.n_lists, pq_bits=args.pq_bits, pq_dim=args.pq_dim,
        kmeans_sample=args.kmeans_sample, store_raw=args.store_raw,
        opq=args.opq)
    common.reset_peak_memory(dev)
    t0 = time.perf_counter()
    ix = ivf_pq.build_from_chunks(params, chunk_fn, n, d, n_chunks=n_chunks,
                                  device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    layout_gb = (ix.codes.nbytes + ix.row_ids.nbytes + ix.norm_corr.nbytes
                 + ix.raw_vectors.nbytes) / 1e9
    raw_gb = n * d * 2 / 1e9
    peak_build = common.peak_memory_gb(dev)
    print(f"build {build_s:.0f}s  codes {ix.codes.nbytes/1e9:.2f} GB "
          f"(layout total {layout_gb:.2f} GB, {n*d*4/1e9:.0f} GB fp32 raw) "
          f"window {ix.max_list_size}  levels {ix.levels}", flush=True)
    print(f"peak device memory {common.gb(peak_build)} (build) beside the "
          f"raw corpus's {raw_gb:.1f} GB of bf16", flush=True)

    fetch_rows, host_rerank, source = None, False, ""
    if args.refine_external:
        fetch_rows, host_rerank, source = refine_source(args, chunk_fn,
                                                        n_chunks, rows, dev)
        print(f"refine source: {source}", flush=True)

    reps = 3 if args.refine_external else 10
    qrs = common.perturbed(queries, SEED + 5000, reps)
    refine_cfg = (args.refine_external or
                  (args.refine if args.store_raw else 0))
    refine_modes = [0, refine_cfg] if refine_cfg else [0]
    out = {"build_s": build_s, "layout_gb": layout_gb, "raw_bf16_gb": raw_gb,
           "codes_gb": ix.codes.nbytes / 1e9, "window": ix.max_list_size,
           "peak_memory_build_gb": peak_build, "refine_source": source,
           "points": []}
    for np_ in args.probes:
        for rr in refine_modes:
            sp = IVFPQSearchParams(n_probes=np_, refine_ratio=rr)
            fr = fetch_rows if rr and args.refine_external else None
            hr = host_rerank if fr is not None else False
            # recall on the queries the ground truth is for; the timing
            # loop takes the moved copies
            dist, ids = ivf_pq.search(sp, ix, queries, args.k,
                                      fetch_rows=fr, host_rerank=hr)
            rec = common.recall(common.to_numpy(ids), gt, args.k)
            t = common.time_batches(
                lambda q: ivf_pq.search(sp, ix, q, args.k, fetch_rows=fr,
                                        host_rerank=hr), qrs)
            tag = (f"refine={rr}" + (" host-store" if hr else "")
                   if rr else "ADC-only")
            print(f"nprobe={np_} {tag}: {t*1e3:.2f} ms/batch "
                  f"{t/args.batch*1e3:.4f} ms/q  qps={args.batch/t:.0f}  "
                  f"recall@{args.k}={rec:.3f}", flush=True)
            point = {"n_probes": np_, "refine_ratio": rr,
                     "host_rerank": hr, "ms_per_batch": t * 1e3,
                     "ms_per_query": t / args.batch * 1e3,
                     "recall_at_k": rec}
            if fr is not None:
                point["distance_error"], point["distance_scale"] = \
                    exact_distance_error(queries, dist, ids, fr)
            out["points"].append(point)
    out["peak_memory_gb"] = common.peak_memory_gb(dev)
    print(f"peak device memory {common.gb(out['peak_memory_gb'])} (build and "
          "searches)", flush=True)
    out.update(gt=gt, gt_distances=gt_d, queries=queries, index=ix)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
