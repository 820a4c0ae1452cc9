"""Recall ceilings on the CLI's synthetic topic corpus, at a size a CPU can
build: what bf16 rounding leaves of flat's recall over one topic, CAGRA's
recall by itopk and IVF-PQ's (pq_dim 96) by probes and refine ratio.

    python3 cuvs_rag_tpu_torch/eval/topic_recall.py [--device cpu]

The CLI's corpus (rag/datasets.synthetic_topic_corpus) is isotropic noise
of spread 0.5 around topic centres; at 2,000,000 rows and 100 topics a
topic holds 20,000 rows, as each of the two topics here does (40,000 x
768, 50 queries). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from cuvs_rag_tpu_torch.eval import recall as recall_lib
    from cuvs_rag_tpu_torch.index import cagra, ivf_pq
    from cuvs_rag_tpu_torch.rag import datasets
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams, CagraSearchParams, IVFPQParams, IVFPQSearchParams)

    dev = torch.device(args.device)
    out = {"device": str(dev)}
    # flat over one 20,000-row topic: the exact top-10 over bf16 rows (and
    # bf16 queries) against the fp32 one
    rng = np.random.default_rng(0)
    c = (rng.standard_normal(768) * 3).astype(np.float32)
    x = torch.from_numpy(c + 0.5 * rng.standard_normal((20_000, 768)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(c + 0.5 * rng.standard_normal((100, 768)).astype(
        np.float32)).to(dev)

    def top10(rows, qs):
        return (2 * qs @ rows.T - (rows * rows).sum(1)).topk(10, dim=1).indices

    exact = top10(x, q).cpu().numpy()
    xr = x.bfloat16().float()
    out["flat_bf16_rows_recall_at_10"] = recall_lib.recall_at_k(
        top10(xr, q).cpu().numpy(), exact, 10)
    out["flat_bf16_rows_and_queries_recall_at_10"] = recall_lib.recall_at_k(
        top10(xr, q.bfloat16().float()).cpu().numpy(), exact, 10)

    corpus, _, centers = datasets.synthetic_topic_corpus(40_000, 768,
                                                         n_topics=2)
    queries, _ = datasets.topic_queries(centers, 50)
    gt = recall_lib.exact_ground_truth(corpus, queries, 10, "sqeuclidean",
                                       device=dev)
    ix = cagra.build(CagraParams(), corpus, device=dev)
    for itopk in (32, 64, 128, 256, 512):
        _, i = cagra.search(CagraSearchParams(itopk_size=itopk), ix, queries,
                            10)
        out[f"cagra_itopk_{itopk}"] = recall_lib.recall_at_k(
            i.cpu().numpy(), gt, 10)
    del ix
    ix = ivf_pq.build(IVFPQParams(pq_dim=96), corpus, device=dev)
    for probes in (4, 16, 80):
        for refine in (16, 64, 100):
            _, i = ivf_pq.search(IVFPQSearchParams(n_probes=probes,
                                                   refine_ratio=refine),
                                 ix, queries, 10)
            out[f"ivf_pq_probes_{probes}_refine_{refine}"] = \
                recall_lib.recall_at_k(i.cpu().numpy(), gt, 10)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
