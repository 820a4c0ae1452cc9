"""Pairwise distance ops and the score algebra.

Squared L2 decomposes as ||q||^2 - 2 q.c + ||c||^2, so every distance is a
(Q,D)x(D,N) matmul plus rank-1 corrections. Internally scores are
larger-is-better; `scores_to_distances` converts at the API edge.

Precision policy: every product accumulates in fp32 with fp32 operands
(bf16 and int8 rows are upcast exactly), and TF32 must be off — a TF32
product keeps ~3 decimal digits and the exact index is the recall oracle.
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.utils.config import Metric

# Rows per chunk when a pass upcasts storage to fp32: bounds the temporary
# at chunk * D * 4 bytes instead of a full fp32 copy of a bf16 corpus.
_CHUNK_ROWS = 1 << 18


def _check_fp32_matmul(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "fp32 matmuls run in TF32 (torch.backends.cuda.matmul.allow_tf32 "
            "is True); the exact index needs full fp32 products"
        )


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, fp32 accumulation, computed in row chunks
    so a bf16 corpus never materializes a full fp32 copy."""
    if x.shape[0] <= _CHUNK_ROWS:
        xf = x.float()
        return (xf * xf).sum(dim=-1)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], _CHUNK_ROWS):
        xf = x[i : i + _CHUNK_ROWS].float()
        out[i : i + _CHUNK_ROWS] = (xf * xf).sum(dim=-1)
    return out


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.clamp(sqnorms(x), min=eps))
    return (x.float() / n[..., None]).to(x.dtype)


def pairwise_inner_product(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(Q,D),(N,D) -> (Q,N) fp32 inner products of the fp32-upcast operands
    (exact products, fp32 accumulation — the JAX package's
    preferred_element_type=float32 / Precision.HIGHEST policy)."""
    _check_fp32_matmul(queries)
    qf = queries.float()
    if corpus.shape[0] <= _CHUNK_ROWS:
        return qf @ corpus.float().T
    out = torch.empty(
        (queries.shape[0], corpus.shape[0]), dtype=torch.float32,
        device=queries.device,
    )
    for i in range(0, corpus.shape[0], _CHUNK_ROWS):
        out[:, i : i + _CHUNK_ROWS] = qf @ corpus[i : i + _CHUNK_ROWS].float().T
    return out


# --- tombstone-deletion convention ---------------------------------------
# A deleted row's fp32 sqnorm slot is raised past DELETED_THRESHOLD (by
# DELETED_PENALTY), which every score formula turns into a ~-2e30 score in
# ANY metric. For sqeuclidean the penalty rides the "- sqnorms" term; the
# inner_product/cosine formulas subtract deletion_penalty() (0.0 on live
# rows).
DELETED_THRESHOLD = 1e29
DELETED_PENALTY = 2e30


def deletion_penalty(slot_sqnorms: torch.Tensor) -> torch.Tensor:
    """Per-row additive penalty derived from the (possibly tombstoned)
    sqnorm slot: 0.0 for live rows, ~DELETED_PENALTY for deleted ones."""
    return torch.clamp(slot_sqnorms - DELETED_THRESHOLD, min=0.0)


def pairwise_sqeuclidean(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorms: torch.Tensor | None = None,
    query_sqnorms: torch.Tensor | None = None,
) -> torch.Tensor:
    """(Q,D),(N,D) -> (Q,N) squared euclidean distances, clamped at 0."""
    if corpus_sqnorms is None:
        corpus_sqnorms = sqnorms(corpus)
    if query_sqnorms is None:
        query_sqnorms = sqnorms(queries)
    ip = pairwise_inner_product(queries, corpus)
    d = query_sqnorms[:, None] - 2.0 * ip + corpus_sqnorms[None, :]
    return torch.clamp(d, min=0.0)


def scores_from_tile(
    queries: torch.Tensor,
    corpus_tile: torch.Tensor,
    tile_sqnorms: torch.Tensor,
    metric: str,
) -> torch.Tensor:
    """(Q,N_tile) scores, larger is better: 2 q.c - ||c||^2 for sqeuclidean
    (||q||^2 is re-added at the API edge), q.c for inner_product/cosine."""
    ip = pairwise_inner_product(queries, corpus_tile)
    if metric == Metric.SQEUCLIDEAN:
        return 2.0 * ip - tile_sqnorms[None, :]
    return ip - deletion_penalty(tile_sqnorms)[None, :]


def scores_from_tile_scaled(
    queries: torch.Tensor,
    corpus_tile: torch.Tensor,
    tile_sqnorms: torch.Tensor,
    tile_scales: torch.Tensor,
    metric: str,
) -> torch.Tensor:
    """scores_from_tile for scalar-quantized storage: rows reconstruct as
    x̂ = scale * v_int8, so score = 2·scale·(q·v) − ||x̂||² (sqeuclidean) or
    scale·(q·v) (ip/cosine). Float storage passes unit scales."""
    ip = pairwise_inner_product(queries, corpus_tile)
    scaled = ip * tile_scales[None, :]
    if metric == Metric.SQEUCLIDEAN:
        return 2.0 * scaled - tile_sqnorms[None, :]
    return scaled - deletion_penalty(tile_sqnorms)[None, :]


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization (SQ8): scale = amax / 127,
    round half to even, clip to ±127. Returns (int8 rows, fp32 scales)."""
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def scores_to_distances(
    scores: torch.Tensor, query_sqnorms: torch.Tensor, metric: str
) -> torch.Tensor:
    """Convert internal scores back to the metric's reported distances."""
    if metric == Metric.SQEUCLIDEAN:
        return torch.clamp(query_sqnorms[:, None] - scores, min=0.0)
    return scores
