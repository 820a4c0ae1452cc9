"""Multi-process worker: one rank of a torch.distributed job.

The counterpart of the JAX package's `infra/multihost_worker.py`. Every
rank builds its own shards of one common corpus for all four families
(parallel/distributed.build_sharded over its local mesh), searches them,
gathers every rank's candidates and merges them, so that every rank holds
the same global top-k; each family is checked against a numpy brute-force
oracle. With `CUVS_RAG_TPU_MULTIHOST_CKPT` set, the last index is saved
(each rank writes its own part files, rank 0 the manifest), loaded back
and searched again, and must answer identically.

    torchrun --standalone --nproc_per_node=2 \\
        -m cuvs_rag_tpu_torch.infra.multihost_worker --device cpu
    cuvs_rag_tpu_torch/infra/run_multihost.sh --standalone \\
        --nproc_per_node=<cards> -m cuvs_rag_tpu_torch.infra.multihost_worker

Without `--device` each rank takes its card, cuda:LOCAL_RANK, and NCCL
(one rank a card); `--device cpu` runs gloo ranks on the CPU. Prints
`MULTIHOST SUMS {family: sum of its global top-k ids}` and
`MULTIHOST OK <checksum>` on success; the checksum is the sum of flat's
global top-k ids for the fixed queries, identical on every rank and to the
oracle's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

N, D, K = 4096, 64, 10


def corpus_and_queries():
    """The common corpus and queries, the same on every rank."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = corpus[[7, 1033, 2048, 4000]] + 0.01 * rng.standard_normal(
        (4, D)).astype(np.float32)
    return corpus, queries


def oracle(corpus, queries) -> np.ndarray:
    """(Q, K) exact ids by numpy brute force: no device involved."""
    d2 = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :K]


def families():
    """(family, build params, search params, floor of agreement with the
    oracle): exact = 1.0; the approximate families at what their budget
    buys on iid Gaussian rows (the check is that the processes compute
    what one process computes, not a recall benchmark)."""
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
        IVFPQParams, IVFPQSearchParams,
    )

    return (
        ("flat", FlatParams(), None, 1.0),
        ("ivf_flat", IVFFlatParams(n_lists=8), None, 0.5),
        ("ivf_pq",
         IVFPQParams(n_lists=4, pq_dim=8, pq_bits=8, kmeans_iters=4,
                     pq_kmeans_iters=4),
         IVFPQSearchParams(n_probes=4, refine_ratio=8), 0.5),
        ("cagra",
         CagraParams(graph_degree=8, intermediate_graph_degree=16,
                     build_algo="exact"),
         CagraSearchParams(itopk_size=32), 0.5),
    )


def family_sums(build, search):
    """Build and search every family with build(family, params, corpus) and
    search(search_params, index, queries, k) -> (dists, ids); returns
    ({family: sum of its ids}, {family: agreement with the oracle}, the
    last index with its search params and ids)."""
    corpus, queries = corpus_and_queries()
    want = oracle(corpus, queries)
    sums, agree = {}, {}
    last = None
    for family, params, sp, _ in families():
        index = build(family, params, corpus)
        _, ids = search(sp, index, queries, K)
        ids = ids.cpu().numpy()
        agree[family] = float(np.mean([
            len(set(ids[r]) & set(want[r])) / K for r in range(len(queries))
        ]))
        sums[family] = int(ids.sum())
        last = (index, sp, ids)
    return sums, agree, last


def say(line: str) -> None:
    """One line in one write: the ranks share torchrun's stdout, and a
    write shorter than the pipe's buffer is not interleaved with another
    rank's."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the rank's device (default cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)

    import torch

    from cuvs_rag_tpu_torch.parallel import distributed
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    dev = distributed.init_from_env(args.device)
    try:
        if dev.type == "cpu":
            torch.set_num_threads(1)
        dmesh = DeviceMesh([dev])
        rank, world = distributed.rank_and_world()
        sums, agree, (index, sp, ids) = family_sums(
            lambda fam, params, corpus: distributed.build_sharded(
                fam, params, corpus, dmesh),
            lambda sp_, ix, q, k: distributed.search(sp_, ix, q, k, dmesh))
        floors = {f: floor for f, _, _, floor in families()}
        for family, a in agree.items():
            if a < floors[family]:
                say(f"MULTIHOST FAIL {family} agree={a}")
                return 1
        corpus, queries = corpus_and_queries()
        ckpt_dir = os.environ.get("CUVS_RAG_TPU_MULTIHOST_CKPT")
        if ckpt_dir:
            from cuvs_rag_tpu_torch.index import io as index_io

            prefix = os.path.join(ckpt_dir, "mh_ckpt")
            index_io.save_sharded(prefix, index)
            back = index_io.load_sharded(prefix, dmesh)
            _, ids2 = distributed.search(sp, back, queries, K, dmesh)
            if not np.array_equal(ids2.cpu().numpy(), ids):
                say("MULTIHOST FAIL ckpt roundtrip")
                return 1
        say(f"MULTIHOST SUMS {json.dumps(sums)}")
        say(f"MULTIHOST OK {sums['flat']} rank {rank} of {world}")
        return 0
    finally:
        distributed.dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
