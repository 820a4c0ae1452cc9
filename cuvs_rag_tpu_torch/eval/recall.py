"""Recall@K against *exact* ground truth.

The counterpart of the JAX package's `eval/recall.py`: ground truth is the
exact brute-force result (the flat index, the recall oracle), so recall@K
is meaningful for every approximate index. The streamed and chunked
oracles keep only one chunk of the corpus and the running top-k in fp32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.index import flat as flat_family
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric


def recall_at_k(retrieved, relevant, k: int) -> float:
    """Mean fraction of `relevant`'s first-k ids (ignoring -1) found in
    `retrieved`'s first k. Both (Q, >= k) id arrays."""
    retrieved = np.asarray(retrieved)[:, :k]
    relevant = np.asarray(relevant)[:, :k]
    hits = 0.0
    for r_row, g_row in zip(retrieved, relevant):
        g = set(int(x) for x in g_row if x >= 0)
        if g:
            hits += len(g.intersection(int(x) for x in r_row)) / len(g)
    return hits / max(retrieved.shape[0], 1)


def recall_multiple_k(retrieved, relevant, ks: Sequence[int]) -> Dict[int, float]:
    """recall_at_k for every k in `ks` that the results are wide enough for."""
    max_k = np.asarray(retrieved).shape[1]
    return {k: recall_at_k(retrieved, relevant, k) for k in ks if k <= max_k}


def exact_ground_truth(corpus, queries, k: int, metric: str, *,
                       device=None) -> np.ndarray:
    """(Q, k) exact neighbor ids through an fp32 flat index — the oracle."""
    index = flat_family.build(FlatParams(metric=metric, dtype="float32"),
                              corpus, device=device)
    if not isinstance(queries, torch.Tensor):
        queries = np.asarray(queries, np.float32)
    _, idx = flat_family.search(None, index, queries, k)
    return idx.cpu().numpy()


def _prep_queries(queries, metric, device) -> torch.Tensor:
    q = torch.as_tensor(queries, device=device).float() \
        if isinstance(queries, torch.Tensor) \
        else torch.from_numpy(np.asarray(queries, np.float32)).to(device)
    return dist_ops.l2_normalize(q) if metric == Metric.COSINE else q


def _gt_chunk_step(start: int, rows: torch.Tensor, best_s, best_i, qn,
                   metric: str):
    """Merge one corpus chunk (fp32) into the running exact top-k."""
    inner = Metric.SQEUCLIDEAN if metric == Metric.SQEUCLIDEAN \
        else Metric.INNER_PRODUCT
    x = rows.float()
    if metric == Metric.COSINE:
        x = dist_ops.l2_normalize(x)
    scores = dist_ops.scores_from_tile(qn, x, dist_ops.sqnorms(x), inner)
    ids = start + torch.arange(x.shape[0], dtype=torch.int32,
                               device=x.device)
    return topk_ops.merge_topk(torch.cat([best_s, scores], dim=1),
                               torch.cat([best_i, ids.expand_as(scores)], dim=1),
                               best_s.shape[1])


def _running(q: torch.Tensor, k: int):
    return (torch.full((q.shape[0], k), topk_ops.NEG_INF, device=q.device),
            torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device))


def exact_ground_truth_streamed(corpus_dev: torch.Tensor, queries, k: int,
                                metric: str,
                                chunk_rows: int = 262_144) -> np.ndarray:
    """(Q, k) exact ids from a corpus already on its device, streamed in
    chunks: no copy of the corpus is made and only the (Q, k) result
    crosses to the host."""
    qn = _prep_queries(queries, metric, corpus_dev.device)
    best_s, best_i = _running(qn, k)
    for start in range(0, corpus_dev.shape[0], chunk_rows):
        best_s, best_i = _gt_chunk_step(
            start, corpus_dev[start:start + chunk_rows], best_s, best_i, qn,
            metric)
    return best_i.cpu().numpy()


def exact_ground_truth_chunks(chunk_fn, n_chunks: int, chunk_rows: int,
                              queries, k: int, metric: str, *,
                              device=None) -> np.ndarray:
    """(Q, k) exact ids from a corpus that is never resident whole: chunk i
    arrives as chunk_fn(i) -> (chunk_rows, D) (numpy or tensor), as in
    build_from_chunks."""
    qn = _prep_queries(queries, metric, base.resolve_device(device))
    best_s, best_i = _running(qn, k)
    for i in range(n_chunks):
        rows = torch.as_tensor(chunk_fn(i), device=qn.device)
        best_s, best_i = _gt_chunk_step(i * chunk_rows, rows, best_s, best_i,
                                        qn, metric)
    return best_i.cpu().numpy()
