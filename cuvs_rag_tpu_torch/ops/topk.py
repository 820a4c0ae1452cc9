"""Exact top-k search without a custom kernel: the streaming tile scan and
the one-shot dense variant.

These are the counterparts of the JAX package's XLA paths (`lax.scan` over
corpus tiles with a running top-k merge, and a single (Q, Np) matmul +
top_k). `index/flat.py` takes them where the CUDA kernels do not apply:
small corpora (dense), k above the large-k kernel's range, and the re-run
after a failed large-k certificate.

Internal convention: scores, larger-is-better (see ops/distance.py).
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops

NEG_INF = -float("inf")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(x: torch.Tensor, target_rows: int, fill=0.0) -> torch.Tensor:
    """Pad axis 0 of x up to target_rows with `fill`."""
    n = x.shape[0]
    if n == target_rows:
        return x
    pad = torch.full(
        (target_rows - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
        device=x.device,
    )
    return torch.cat([x, pad], dim=0)


def query_dtype(corpus_dtype: torch.dtype) -> torch.dtype:
    """Queries are scored in the storage dtype, or bf16 for int8 storage."""
    return torch.bfloat16 if corpus_dtype == torch.int8 else corpus_dtype


def merge_topk(scores: torch.Tensor, indices: torch.Tensor, k: int):
    """Merge candidate sets along the last axis into a global top-k.

    scores: (..., C) larger-is-better, indices: (..., C) global ids.
    Returns ((..., k) scores desc-sorted, (..., k) int32 indices). Slots that
    never saw a live candidate (pad rows, k > corpus, tombstone-deleted
    rows scoring below -DELETED_THRESHOLD) report score -inf and id -1.
    """
    c = scores.shape[-1]
    kk = min(k, c)
    top_scores, top_args = torch.topk(scores, kk, dim=-1)
    top_idx = torch.gather(indices, -1, top_args).to(torch.int32)
    live = top_scores > -dist_ops.DELETED_THRESHOLD
    top_scores = torch.where(live, top_scores, torch.full_like(top_scores, NEG_INF))
    top_idx = torch.where(live, top_idx, torch.full_like(top_idx, -1))
    if kk < k:  # pad out to k with invalid entries
        shape = tuple(scores.shape[:-1]) + (k - kk,)
        top_scores = torch.cat(
            [top_scores, torch.full(shape, NEG_INF, device=scores.device)], -1
        )
        top_idx = torch.cat(
            [top_idx, torch.full(shape, -1, dtype=torch.int32,
                                 device=scores.device)], -1
        )
    return top_scores, top_idx


def flat_topk_search(
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    corpus_scales: torch.Tensor | None = None,
    *,
    k: int,
    metric: str,
    tile_n: int = 2048,
):
    """Streaming exact top-k search.

    corpus: (Np, D) storage rows; corpus_sqnorms: (Np,) fp32 (tombstones
    included); queries: (Q, D); rows >= n_valid are padding and never
    returned. Peak memory is O(Q * (k + tile_n)).

    Returns (scores (Q,k) desc-sorted larger-better, indices (Q,k) int32;
    slots beyond the corpus size get score=-inf, index=-1).
    """
    n_padded = corpus.shape[0]
    q = queries.shape[0]
    dev = corpus.device
    if corpus_scales is None:
        corpus_scales = torch.ones(n_padded, dtype=torch.float32, device=dev)
    queries = queries.to(query_dtype(corpus.dtype))
    best_s = torch.full((q, k), NEG_INF, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n_padded, tile_n):
        stop = min(start + tile_n, n_padded)
        scores = dist_ops.scores_from_tile_scaled(
            queries, corpus[start:stop], corpus_sqnorms[start:stop],
            corpus_scales[start:stop], metric,
        )
        gidx = torch.arange(start, stop, dtype=torch.int32, device=dev)
        scores = scores.masked_fill((gidx >= n_valid)[None, :], NEG_INF)
        best_s, best_i = merge_topk(
            torch.cat([best_s, scores], dim=1),
            torch.cat([best_i, gidx[None, :].expand(q, -1)], dim=1),
            k,
        )
    return best_s, best_i


def flat_topk_search_dense(
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    corpus_scales: torch.Tensor | None = None,
    *,
    k: int,
    metric: str,
):
    """One-shot variant: full (Q, Np) score matrix then top-k. Faster for
    small corpora; memory O(Q * Np)."""
    n_padded = corpus.shape[0]
    dev = corpus.device
    if corpus_scales is None:
        corpus_scales = torch.ones(n_padded, dtype=torch.float32, device=dev)
    queries = queries.to(query_dtype(corpus.dtype))
    scores = dist_ops.scores_from_tile_scaled(
        queries, corpus, corpus_sqnorms, corpus_scales, metric
    )
    gidx = torch.arange(n_padded, dtype=torch.int32, device=dev)
    scores = scores.masked_fill((gidx >= n_valid)[None, :], NEG_INF)
    return merge_topk(scores, gidx[None, :].expand_as(scores), k)
