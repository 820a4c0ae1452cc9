"""End-to-end synthetic pipeline + CLI — the port's primary entry point.

The counterpart of the JAX package's `main.py`, which mirrors
`improved_multi_gpu_rag.main()` (Latest/improved_multi_gpu_rag.py:
399-506): device discovery, memory status, synthetic corpus, parallel index
build, distributed batched search, recall@K sweep, plus a real CLI,
exact-ground-truth recall and a fit check before building. The flags, their
defaults and the JSON result keys are the JAX package's.

    python -m cuvs_rag_tpu_torch.main --n 100000 --dim 768 --family ivf_flat
    python -m cuvs_rag_tpu_torch.main --family all --placement shard

The mesh is every visible card (`DeviceMesh()`); without one the CLI
raises. `--device DEV` names the device instead and `--positions N` repeats
it N times (`--device cpu --positions 8` is the counterpart of the JAX
tests' eight virtual CPU devices; `--positions 4` puts four shards on the
card). Under `CUVS_RAG_TPU_MULTIHOST` (infra/run_multihost.sh, torchrun)
every rank joins the process group first and holds only its own shards
(parallel/distributed.py); every rank prints the same results.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("cuvs_rag_tpu_torch.main")


def _params(family: str, args):
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
        IVFFlatSearchParams, IVFPQParams, IVFPQSearchParams,
    )

    params = {
        "flat": FlatParams(dtype=args.dtype),
        "ivf_flat": IVFFlatParams(n_lists=args.n_lists, dtype=args.dtype),
        "ivf_pq": IVFPQParams(n_lists=args.n_lists, pq_dim=args.pq_dim,
                              pq_bits=args.pq_bits),
        "cagra": CagraParams(),
    }[family]
    sp = {
        "flat": None,
        "ivf_flat": IVFFlatSearchParams(n_probes=args.n_probes),
        "ivf_pq": IVFPQSearchParams(n_probes=args.n_probes,
                                    refine_ratio=args.refine_ratio),
        "cagra": CagraSearchParams(),
    }[family]
    return params, sp


def _tune(family, params, corpus, queries, k, args, dmesh, gt):
    """The cheapest search params that reach --tune-recall on a
    single-device index of the same corpus on the mesh's first device
    (the tuned knobs transfer to the per-shard searches), or None where
    that index does not fit one device or the target is not reached.
    In a process group rank 0's choice holds on every rank."""
    from cuvs_rag_tpu_torch.eval.tune import tune as tune_fn
    from cuvs_rag_tpu_torch.parallel import distributed
    from cuvs_rag_tpu_torch.parallel import search as psearch
    from cuvs_rag_tpu_torch.utils import memory as mem

    # the tune index is single-device even under --placement shard: check
    # IT fits one device (the shard plan validated the sharded layout only)
    # and skip tuning rather than run out of memory
    plan1 = mem.plan_shards(len(corpus), corpus.shape[1], 1, family=family,
                            dtype=args.dtype,
                            budget=mem.detect_budget(dmesh.first))
    res = None
    if not plan1["fits"]:
        logger.warning(
            "tune: corpus does not fit a single device (%s); skipping "
            "auto-tune, keeping CLI search params", plan1["suggestion"])
    else:
        single = psearch.FAMILIES[family].build(params, corpus,
                                                device=dmesh.first)
        res = tune_fn(family, single, queries, k=k,
                      target_recall=args.tune_recall, ground_truth=gt)
        del single
    if distributed.is_initialized():
        box = [res]
        distributed.dist.broadcast_object_list(box, src=0)
        res = box[0]
    return res


def run_family(family, corpus, queries, k, args, dmesh, gt):
    from cuvs_rag_tpu_torch.eval import recall as recall_lib
    from cuvs_rag_tpu_torch.parallel import distributed
    from cuvs_rag_tpu_torch.parallel import search as psearch
    from cuvs_rag_tpu_torch.utils import profiling

    params, sp = _params(family, args)
    tuned = None
    if getattr(args, "tune_recall", 0) and family != "flat":
        res = _tune(family, params, corpus, queries, k, args, dmesh, gt)
        if res is not None and res.met:
            sp = res.search_params
            tuned = {
                "params": str(sp),
                "recall": round(res.point.recall, 4),
                "ms_per_query": round(res.point.latency_ms_per_query, 4),
                "configs_tried": len(res.curve),
            }
            logger.info("tuned %s -> %s", family, tuned)
        elif res is not None:
            logger.warning(
                "tune: target recall %.3f not reachable for %s; keeping "
                "CLI search params", args.tune_recall, family,
            )

    multi = distributed.is_initialized()
    t0 = time.perf_counter()
    if args.placement == "shard" and multi:
        index = distributed.build_sharded(family, params, corpus, dmesh)

        def do_search(qb):
            return distributed.search(sp, index, qb, k, dmesh)
    elif args.placement == "shard":
        index = psearch.build_sharded(family, params, corpus, dmesh)

        def do_search(qb):
            return psearch.search_sharded(sp, index, qb, k, dmesh)
    else:
        index = psearch.build_replicated(family, params, corpus, dmesh)

        def do_search(qb):
            return psearch.search_replicated(sp, index, qb, k, dmesh)
    for dev in set(dmesh.devices):
        profiling.drain(dev)
    build_s = time.perf_counter() - t0

    qt = torch.from_numpy(queries).to(dmesh.first)
    # a warm-up call (the kernels' first launch), then CUDA events around
    # each timed call on a card (the host clock on the CPU)
    iters = 3
    search_s = float(np.mean(profiling.call_seconds(lambda: do_search(qt),
                                                    iters)))
    search_ms = search_s * 1e3
    dists, idx = do_search(qt)

    recalls = recall_lib.recall_multiple_k(
        idx.cpu().numpy(), gt, [kk for kk in (1, 5, 10) if kk <= k]
    )
    out = {
        "family": family,
        "build_s": round(build_s, 3),
        "search_ms_batch": round(search_ms, 3),
        "search_ms_per_query": round(search_ms / len(queries), 4),
        "recall": {k_: round(v, 4) for k_, v in recalls.items()},
    }
    if tuned is not None:
        out["tuned"] = tuned
    return out


def _mesh(args):
    """The run's mesh: --device repeated --positions times, every visible
    card where neither is given; in a process group the rank's device
    (cuda:LOCAL_RANK unless --device names another)."""
    from cuvs_rag_tpu_torch.parallel import distributed
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    if os.environ.get("CUVS_RAG_TPU_MULTIHOST"):
        # join the process group before any CUDA work (infra/
        # run_multihost.sh sets this; the counterpart of
        # jax.distributed.initialize())
        dev = distributed.init_from_env(args.device)
        return DeviceMesh([dev] * (args.positions or 1))
    if args.device is None and args.positions is None:
        return DeviceMesh()
    return DeviceMesh([args.device or "cuda:0"] * (args.positions or 1))


def main(argv=None, *, data=None):
    """Run the CLI on `argv` and return its results. `data`: the
    (corpus, topic_labels, centers) that rag/datasets.
    synthetic_topic_corpus makes for these --n, --dim and --topics, passed
    by a caller that runs the CLI more than once over one corpus instead
    of having it made again."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--n-queries", type=int, default=100)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--family", default="ivf_flat",
                   choices=["flat", "ivf_flat", "ivf_pq", "cagra", "all"])
    p.add_argument("--placement", default="shard", choices=["shard", "replicate"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--n-lists", type=int, default=0)
    p.add_argument("--n-probes", type=int, default=20)
    p.add_argument("--pq-dim", type=int, default=0)
    p.add_argument("--pq-bits", type=int, default=8, choices=[4, 8],
                   help="8 = two-level additive nibble PQ (default), "
                        "4 = fastscan")
    p.add_argument("--refine-ratio", type=int, default=2)
    p.add_argument("--topics", type=int, default=100)
    p.add_argument("--tune-recall", type=float, default=0.0,
                   help="auto-tune search params to this recall@k target "
                        "(0 = off; overrides --n-probes/--refine-ratio)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--device", default=None,
                   help="the mesh's device (default: every visible card; "
                        "'cpu' runs the plain versions on the CPU)")
    p.add_argument("--positions", type=int, default=None,
                   help="mesh positions on --device (default 1)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    dmesh = _mesh(args)

    from cuvs_rag_tpu_torch.eval import recall as recall_lib
    from cuvs_rag_tpu_torch.rag import datasets
    from cuvs_rag_tpu_torch.utils import memory as mem
    from cuvs_rag_tpu_torch.utils.config import Metric

    info = dmesh.device_infos()[0]
    logger.info("mesh: %d x %s", dmesh.num_devices, info.kind)
    mem.log_memory_status("start")

    plan = mem.plan_shards(args.n, args.dim, dmesh.num_devices,
                           family=args.family if args.family != "all" else "flat",
                           dtype=args.dtype,
                           budget=mem.detect_budget(dmesh.first))
    logger.info("shard plan: %s", plan)
    if not plan["fits"]:
        raise SystemExit(f"corpus does not fit: {plan['suggestion']}")

    if data is None:
        logger.info("generating %d x %d synthetic topic corpus", args.n,
                    args.dim)
        data = datasets.synthetic_topic_corpus(args.n, args.dim,
                                               n_topics=args.topics)
    corpus, topic_labels, centers = data
    if corpus.shape != (args.n, args.dim) or len(centers) != args.topics:
        raise ValueError(
            f"data holds {corpus.shape} rows around {len(centers)} topics; "
            f"the flags ask for ({args.n}, {args.dim}) and {args.topics}")
    queries, qlabels = datasets.topic_queries(centers, args.n_queries)

    logger.info("computing exact ground truth (flat oracle)")
    gt = recall_lib.exact_ground_truth(corpus, queries, args.k,
                                       Metric.SQEUCLIDEAN, device=dmesh.first)

    families = (["flat", "ivf_flat", "ivf_pq", "cagra"]
                if args.family == "all" else [args.family])
    results = []
    for fam in families:
        logger.info("=== %s (%s) ===", fam, args.placement)
        r = run_family(fam, corpus, queries, args.k, args, dmesh, gt)
        r["topic_purity"] = round(datasets.topic_recall(
            np.asarray(gt), topic_labels, qlabels), 4)
        results.append(r)
        logger.info("%s", r)

    mem.log_memory_status("end")
    if args.json:
        print(json.dumps(results))
    else:
        for r in results:
            print(f"{r['family']:10s} build {r['build_s']:8.2f}s  "
                  f"search {r['search_ms_per_query']:8.4f} ms/q  "
                  f"recall@{args.k} {r['recall'].get(args.k, r['recall'])}")
    return results


if __name__ == "__main__":
    main()
