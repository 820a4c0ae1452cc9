"""Prebuilt-index pipeline: load from disk, place on the mesh, compare
shard vs replicate — the FAISS Wikipedia workflow (SURVEY.md §2 #13/#14,
Latest/faiss-main.ipynb: read_index -> distribute_to_gpus -> shard-vs-
replicate benchmark -> batch sweep).

The counterpart of the JAX package's `examples/wikipedia_pipeline.py`. The
reference used a 6.29M x 384 prebuilt FAISS index; this demo builds and
saves a synthetic stand-in at a chosen scale, loads it, and runs the
placement comparison the reference measured.

    python cuvs_rag_tpu_torch/examples/wikipedia_pipeline.py --n 200000 --dim 384
    python cuvs_rag_tpu_torch/examples/wikipedia_pipeline.py --positions 4
    python cuvs_rag_tpu_torch/examples/wikipedia_pipeline.py --device cpu --n 4096
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--index-path", default=None,
                   help="where the built index is saved (default: a "
                        "temporary directory)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="default: every visible card, one position each")
    p.add_argument("--positions", type=int, default=None,
                   help="mesh positions on --device (default 1)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        run(args, args.index_path or os.path.join(tmp, "wiki_index.npz"))


def run(args, index_path):
    from cuvs_rag_tpu_torch.eval import bench as bench_lib
    from cuvs_rag_tpu_torch.index import flat, io
    from cuvs_rag_tpu_torch.parallel import search as psearch
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    if args.device is None and args.positions is None:
        dmesh = DeviceMesh()
    else:
        dmesh = DeviceMesh([args.device or "cuda:0"] * (args.positions or 1))
    dev = dmesh.first
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    queries = rng.standard_normal((64, args.dim)).astype(np.float32)

    # --- build once, persist (replaces faiss.read_index on a prebuilt file)
    if not os.path.exists(index_path):
        t0 = time.perf_counter()
        ix = flat.build(FlatParams(dtype="bfloat16"), corpus, device=dev)
        io.save_index(index_path, ix)
        print(f"built+saved index in {time.perf_counter()-t0:.2f}s "
              f"-> {index_path} ({os.path.getsize(index_path)/1e6:.0f} MB)")
    t0 = time.perf_counter()
    ix = io.load_index(index_path, device=dev)
    print(f"loaded prebuilt index in {time.perf_counter()-t0:.2f}s")
    print(f"mesh: {dmesh.num_devices} positions")

    # --- sharded placement (faiss co.shard=True) ------------------------
    sindex = psearch.build_sharded("flat", FlatParams(dtype="bfloat16"),
                                   corpus, dmesh)

    def sharded_search(q, k):
        return psearch.search_sharded(None, sindex, q, k, dmesh)

    # --- replicated placement (co.shard=False) --------------------------
    rindex = psearch.build_replicated("flat", FlatParams(dtype="bfloat16"),
                                      corpus, dmesh)

    def replicated_search(q, k):
        return psearch.search_replicated(None, rindex, q, k, dmesh)

    # --- the reference's comparison: single query + batch sweep ---------
    for name, fn in [("single", lambda q, k: flat.search(None, ix, q, k)),
                     ("sharded", sharded_search),
                     ("replicated", replicated_search)]:
        rows = bench_lib.batch_size_sweep(fn, queries, args.k,
                                          batch_sizes=(1, 10, 50), iters=3,
                                          device=dev)
        print(f"\n{name}:")
        for r in rows:
            print(f"  batch={r.batch_size:3d}  {r.latency_ms_per_query:8.3f} ms/q"
                  f"  {r.qps:8.1f} qps")

    # correctness cross-check between placements
    _, i1 = sharded_search(queries[:4], args.k)
    _, i2 = replicated_search(queries[:4], args.k)
    assert np.array_equal(i1.cpu().numpy(), i2.cpu().numpy()), \
        "placement mismatch"
    print("\nplacements agree on results")


if __name__ == "__main__":
    main()
