"""Family-agnostic out-of-core exact re-rank.

The counterpart of the JAX package's `index/refine.py` (FAISS analogue:
`IndexRefine` over an on-disk store). Any search result — IVF-PQ ADC
candidates, IVF-Flat int8 results — can be re-ranked exactly against raw
rows that do NOT live in device memory: the candidate ids cross to the host
(a few KB), a caller's callback supplies the rows (host-RAM ndarray, disk
mmap, recompute), and the exact distance pass runs on the device
(`rerank_external`) or on the host (`rerank_host`). Typical use: over-fetch
candidates (k' = r*k), then

    d, i = ivf_flat.search(sp, ix, q, k=r * k)          # any family
    d, i = refine.rerank_external(q, i, k, lambda ids: host_rows[ids],
                                  metric=ix.metric)

`ivf_pq.search(..., fetch_rows=...)` wraps exactly this path.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import Metric


def _candidates(ids, n_queries: int):
    """ids (Q, C) as numpy, the sorted unique valid ids, and each
    candidate's slot among them (exact: every valid id is in uids)."""
    ids_h = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
        else np.asarray(ids)
    if ids_h.ndim != 2 or ids_h.shape[0] != n_queries:
        raise ValueError(f"ids must be (Q={n_queries}, C), got {ids_h.shape}")
    uids = np.unique(ids_h[ids_h >= 0])
    if uids.size == 0:
        return ids_h, uids, None
    slot = np.searchsorted(uids, np.clip(ids_h, 0, None))
    return ids_h, uids, np.minimum(slot, uids.size - 1).astype(np.int64)


def _fetch(fetch_rows, uids, dim: int) -> np.ndarray:
    rows = np.asarray(fetch_rows(uids), np.float32)
    if rows.shape != (uids.size, dim):
        raise ValueError(f"fetch_rows returned {rows.shape}, expected "
                         f"{(uids.size, dim)}")
    return rows


def rerank_external(queries: torch.Tensor, ids, k: int,
                    fetch_rows: Callable[[np.ndarray], np.ndarray], *,
                    metric: str = Metric.SQEUCLIDEAN, pad_dim_to: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of candidate `ids` (Q, C) down to top-k (Q, k), scored
    on the queries' device.

    fetch_rows receives the sorted unique ascending valid ids and must
    return `(len(ids), dim)` float rows of the ORIGINAL corpus (for cosine,
    unnormalized rows are fine). Returns (distances, ids) in the family
    `search` convention: squared distances (smaller = closer) for
    sqeuclidean, inner products (larger = closer) otherwise; -1 ids and inf
    distances on empty slots. pad_dim_to zero-pads the feature dim to a
    multiple (an IVF-PQ index's pq_dim); 0 keeps the raw dim."""
    if queries.ndim != 2:
        raise ValueError(f"queries must be (Q, D), got {tuple(queries.shape)}")
    q_n, dim = queries.shape
    dev = queries.device
    ids_h, uids, slot = _candidates(ids, q_n)
    if uids.size == 0:
        return (torch.full((q_n, k), float("inf"), device=dev),
                torch.full((q_n, k), -1, dtype=torch.int32, device=dev))
    rows = torch.from_numpy(_fetch(fetch_rows, uids, dim)).to(dev)
    q = queries.float()
    if metric == Metric.COSINE:
        rows, q = dist_ops.l2_normalize(rows), dist_ops.l2_normalize(q)
    if pad_dim_to > 0 and dim % pad_dim_to:
        pad = (0, pad_dim_to - dim % pad_dim_to)
        rows = torch.nn.functional.pad(rows, pad)
        q = torch.nn.functional.pad(q, pad)
    slot_t = torch.from_numpy(slot).to(dev)
    ids_t = torch.from_numpy(ids_h).to(dev)
    dist_ops._check_fp32_matmul(q)
    exact = torch.bmm(rows[slot_t], q[:, :, None])[:, :, 0]  # (Q, C)
    if metric == Metric.SQEUCLIDEAN:
        exact = 2.0 * exact - dist_ops.sqnorms(rows)[slot_t]
    exact = torch.where(ids_t >= 0, exact,
                        torch.full_like(exact, topk_ops.NEG_INF))
    scores, out_ids = topk_ops.merge_topk(exact, ids_t, k)
    return dist_ops.scores_to_distances(scores, dist_ops.sqnorms(q),
                                        metric), out_ids


def rerank_host(queries, ids, k: int,
                fetch_rows: Callable[[np.ndarray], np.ndarray], *,
                metric: str = Metric.SQEUCLIDEAN
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact re-rank of candidate `ids` (Q, C) down to top-k ON THE HOST:
    the serving shape when the raw corpus lives in host RAM or an mmap.
    Only the candidate ids leave the device; the gather and the scoring run
    in numpy (BLAS) and nothing is uploaded. Returns numpy (distances, ids)
    in the family search convention."""
    q = queries.float().cpu().numpy() if isinstance(queries, torch.Tensor) \
        else np.asarray(queries, np.float32)
    ids_h, uids, slot = _candidates(ids, q.shape[0])
    qn, c = ids_h.shape
    if uids.size == 0:
        return (np.full((qn, k), np.inf, np.float32),
                np.full((qn, k), -1, np.int32))
    rows = _fetch(fetch_rows, uids, q.shape[1])
    if metric == Metric.COSINE:
        rows = rows / np.maximum(
            np.linalg.norm(rows, axis=1, keepdims=True), 1e-30)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    cand = rows[slot.reshape(-1)].reshape(qn, c, -1)
    ip = np.einsum("qd,qcd->qc", q, cand, optimize=True)
    if metric == Metric.SQEUCLIDEAN:
        scores = 2.0 * ip - np.sum(cand * cand, axis=2)
    else:
        scores = ip
    scores = np.where(ids_h >= 0, scores, -np.inf)
    kk = min(k, c)
    part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
    ps = np.take_along_axis(scores, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    top = np.take_along_axis(part, order, axis=1)
    top_s = np.take_along_axis(scores, top, axis=1)
    top_i = np.take_along_axis(ids_h, top, axis=1).astype(np.int32)
    live = np.isfinite(top_s)
    top_i = np.where(live, top_i, -1)
    if metric == Metric.SQEUCLIDEAN:
        qsq = np.sum(q * q, axis=1, keepdims=True)
        dist = np.where(live, qsq - top_s, np.inf).astype(np.float32)
    else:
        dist = np.where(live, top_s, -np.inf).astype(np.float32)
    if kk < k:
        fill = np.inf if metric == Metric.SQEUCLIDEAN else -np.inf
        dist = np.pad(dist, ((0, 0), (0, k - kk)), constant_values=fill)
        top_i = np.pad(top_i, ((0, 0), (0, k - kk)), constant_values=-1)
    return dist, top_i
