"""FlatIndex — exact brute-force k-NN.

The PyTorch counterpart of the JAX package's `index/flat.py` (FAISS
`IndexFlatL2` parity). The corpus lives on one device, padded to a tile
multiple; search goes through the fused distance + top-k kernels of
ops/flat_kernels.py above _DENSE_THRESHOLD rows, and through one dense
matmul + top-k below it. This index is the recall oracle every approximate
index is evaluated against.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import flat_kernels
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric
from cuvs_rag_tpu_torch.utils.metrics import default_registry


@base.register_index
@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Exact index: tensors on one device plus static fields."""

    vectors: torch.Tensor  # (Np, D) padded corpus, storage dtype
    sqnorms: torch.Tensor  # (Np,) fp32 row sqnorms of the stored reconstruction
    scales: torch.Tensor  # (Np,) fp32 per-row dequant scales (1.0 for floats)
    n_valid: int  # true corpus size (pad rows excluded)
    metric: str
    tile_n: int

    @property
    def dim(self) -> int:
        return self.vectors.shape[-1]

    @property
    def size(self) -> int:
        """Padded capacity; the true size is n_valid."""
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def build(params: FlatParams, dataset, *, device=None) -> FlatIndex:
    """Build an exact index from a numpy array or tensor, on `device` (None:
    a tensor's own device, the card for numpy: base.resolve_device)."""
    base.validate_dataset(dataset)
    vectors = base.as_tensor(dataset, device)
    dtype = base.storage_dtype(params.dtype, vectors.dtype)
    n = vectors.shape[0]
    tile_n = min(params.tile_n, topk_ops.round_up(n, 8))
    n_padded = topk_ops.round_up(n, tile_n)

    if params.metric == Metric.COSINE:
        vectors = dist_ops.l2_normalize(vectors)
    if dtype == torch.int8:
        vectors, scales = dist_ops.quantize_rows(vectors)
        vectors = topk_ops.pad_rows(vectors, n_padded)
        scales = topk_ops.pad_rows(scales, n_padded)
        # sqnorms of the reconstruction keep the L2 decomposition exact
        # w.r.t. what is actually scored
        sq = dist_ops.sqnorms(vectors) * scales ** 2
    else:
        vectors = topk_ops.pad_rows(vectors.to(dtype), n_padded)
        scales = torch.ones(n_padded, dtype=torch.float32, device=vectors.device)
        sq = dist_ops.sqnorms(vectors)
    return FlatIndex(
        vectors=vectors, sqnorms=sq, scales=scales, n_valid=n,
        metric=params.metric, tile_n=tile_n,
    )


def build_local(params: FlatParams, block: torch.Tensor,
                n_valid: int) -> FlatIndex:
    """The exact index of one shard (parallel/search.build_sharded): a
    padded (per_shard, D) block whose rows past `n_valid` are dead, kept on
    its device and, where the storage dtype is the block's own, shared with
    it. A shard with n_valid 0 answers -1 / inf."""
    per = block.shape[0]
    dtype = base.storage_dtype(params.dtype, block.dtype)
    vectors = block
    if params.metric == Metric.COSINE:
        vectors = dist_ops.l2_normalize(vectors)
    tile_n = params.tile_n if per % params.tile_n == 0 else per
    if dtype == torch.int8:
        vectors, scales = dist_ops.quantize_rows(vectors)
        sq = dist_ops.sqnorms(vectors) * scales ** 2
    else:
        vectors = vectors.to(dtype)
        scales = torch.ones(per, dtype=torch.float32, device=vectors.device)
        sq = dist_ops.sqnorms(vectors)
    return FlatIndex(vectors=vectors, sqnorms=sq, scales=scales,
                     n_valid=int(n_valid), metric=params.metric,
                     tile_n=tile_n)


def extend(index: FlatIndex, new_vectors) -> FlatIndex:
    """Append rows; new rows get ids n_valid..n_valid+B-1."""
    if new_vectors.ndim != 2 or new_vectors.shape[1] != index.dim:
        raise ValueError(
            f"new vectors must be (B, {index.dim}), got {tuple(new_vectors.shape)}"
        )
    nv = index.n_valid
    old = index.vectors[:nv]
    add = base.as_tensor(new_vectors, index.device)
    if index.metric == Metric.COSINE:
        add = dist_ops.l2_normalize(add)
    total = nv + add.shape[0]
    n_padded = topk_ops.round_up(total, index.tile_n)
    if index.vectors.dtype == torch.int8:
        add_q, add_s = dist_ops.quantize_rows(add)
        vectors = topk_ops.pad_rows(torch.cat([old, add_q]), n_padded)
        scales = topk_ops.pad_rows(
            torch.cat([index.scales[:nv], add_s]), n_padded
        )
        sq = dist_ops.sqnorms(vectors) * scales ** 2
    else:
        add = add.to(index.vectors.dtype)
        vectors = topk_ops.pad_rows(torch.cat([old, add], dim=0), n_padded)
        scales = torch.ones(n_padded, dtype=torch.float32, device=index.device)
        sq = dist_ops.sqnorms(vectors)
    # recomputing sqnorms from storage would resurrect tombstone-deleted
    # rows — carry the FULL penalty over (carrying deletion_penalty() instead
    # would decay the slot by DELETED_THRESHOLD per extend and resurrect
    # deleted rows after ~20 extends: the slot must re-converge to
    # real + DELETED_PENALTY every time, a fixpoint)
    old_sq = index.sqnorms[:nv]
    sq[:nv] += torch.where(
        old_sq > dist_ops.DELETED_THRESHOLD, dist_ops.DELETED_PENALTY, 0.0
    )
    return FlatIndex(
        vectors=vectors, sqnorms=sq, scales=scales, n_valid=total,
        metric=index.metric, tile_n=index.tile_n,
    )


def delete(index: FlatIndex, ids) -> FlatIndex:
    """Tombstone-remove rows by id (FAISS `remove_ids` parity, id-stable):
    each valid id's sqnorm slot is raised to at least DELETED_PENALTY, so
    the row never appears in results in any metric. Shapes never change.
    Idempotent; unknown ids are ignored."""
    ids = torch.as_tensor(ids, device=index.device).reshape(-1).long()
    if ids.shape[0] == 0:
        return index
    ids = ids[(ids >= 0) & (ids < index.n_valid)]
    sq = index.sqnorms.clone()
    sq.scatter_reduce_(
        0, ids, torch.full(ids.shape, dist_ops.DELETED_PENALTY,
                           dtype=torch.float32, device=index.device),
        reduce="amax",
    )
    return dataclasses.replace(index, sqnorms=sq)


def live_row_mask(index: FlatIndex) -> torch.Tensor:
    """(n_valid,) bool — False where a row was tombstone-deleted."""
    return index.sqnorms[: index.n_valid] < dist_ops.DELETED_THRESHOLD


# Below this corpus size the one-shot dense path (single matmul + one top-k)
# beats the streaming scan; above it, the fused kernels bound memory at
# O(Q * (k + tile)). Chosen on the TPU; re-deciding it on the H100 is open.
_DENSE_THRESHOLD = 262_144


def _use_kernel(index: FlatIndex, k: int) -> bool:
    """K1/K2 eligibility: small k and a corpus above the dense threshold.
    Any device: on a CPU tensor the wrapper runs its plain version."""
    return k <= flat_kernels.MAX_KERNEL_K and index.size > _DENSE_THRESHOLD


def _use_kernel_large(index: FlatIndex, k: int, search_params) -> bool:
    if search_params is not None and getattr(search_params, "approx", False):
        return False  # approx large k keeps the exact scan
    return (
        flat_kernels.MAX_KERNEL_K < k <= flat_kernels.MAX_LARGE_K
        and index.size > _DENSE_THRESHOLD
    )


def _kernel_metric(metric: str) -> str:
    return Metric.SQEUCLIDEAN if metric == Metric.SQEUCLIDEAN \
        else Metric.INNER_PRODUCT


def search_scores(
    search_params, index: FlatIndex, queries: torch.Tensor, k: int,
    *, use_kernel=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Internal family-protocol entry: (scores larger-better, indices).

    Handles query prep (cosine normalization) but no metric conversion.
    `use_kernel` overrides the automatic kernel choice (None = _use_kernel).
    With approx=True and no kernel, the exact paths run (the JAX package's
    approx_max_k fallback has no counterpart: exact top-k is as cheap here).
    """
    if use_kernel is None:
        use_kernel = _use_kernel(index, k)
    if index.metric == Metric.COSINE:
        queries = dist_ops.l2_normalize(queries)
    approx = search_params is not None and getattr(search_params, "approx", False)
    if use_kernel:
        # sketch mode takes the int8 x int8 path on quantized storage (the
        # scores are already sketch-approximate); exact mode keeps bf16
        # compute so results match the storage exactly
        args = (index.vectors, index.sqnorms, queries, index.n_valid,
                index.scales)
        if approx:
            return flat_kernels.flat_topk_sketch(
                *args, k=k, metric=_kernel_metric(index.metric),
                tile_c=min(index.tile_n, 2048),
                int8_compute=index.vectors.dtype == torch.int8,
            )
        return flat_kernels.flat_topk_exact(
            *args, k=k, metric=_kernel_metric(index.metric)
        )
    if index.size <= _DENSE_THRESHOLD:
        return topk_ops.flat_topk_search_dense(
            index.vectors, index.sqnorms, queries, index.n_valid,
            index.scales, k=k, metric=index.metric,
        )
    return topk_ops.flat_topk_search(
        index.vectors, index.sqnorms, queries, index.n_valid, index.scales,
        k=k, metric=index.metric, tile_n=index.tile_n,
    )


def search_scores_large(search_params, index: FlatIndex,
                        queries: torch.Tensor, k: int):
    """The certified large-k scan (K3, 32 < k <= 8192): (scores desc, ids,
    (Q,) certified). An uncertified row must be recomputed by the caller
    (search re-runs the exact scan; parallel/search ANDs the shards'
    certificates first)."""
    if index.metric == Metric.COSINE:
        queries = dist_ops.l2_normalize(queries)
    return flat_kernels.flat_topk_large(
        index.vectors, index.sqnorms, queries, index.n_valid, index.scales,
        k=k, metric=_kernel_metric(index.metric),
    )


def default_search_params():
    return None


def _search_core(search_params, index, queries, k, use_kernel):
    scores, idx = search_scores(
        search_params, index, queries, k, use_kernel=use_kernel
    )
    qn = dist_ops.l2_normalize(queries) \
        if index.metric == Metric.COSINE else queries
    return dist_ops.scores_to_distances(
        scores, dist_ops.sqnorms(qn), index.metric
    ), idx


def search(
    search_params, index: FlatIndex, queries: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN. cuVS-style surface: search(search_params, index, queries, k).

    Returns (distances (Q,k), indices (Q,k) int32). For sqeuclidean the
    distances are squared-L2 ascending; for inner_product/cosine they are
    similarities descending.

    32 < k <= 8192 above the dense threshold takes the certified large-k
    kernel; when any row fails its certificate the exact scan re-runs (and
    `flat.certificate_reruns` counts it), so results are always exact.
    The call is the span `flat.search`.
    """
    with profiling.span("flat.search"):
        queries = base.validate_queries(
            base.as_tensor(queries, index.device), index.dim
        )
        if _use_kernel_large(index, k, search_params):
            scores, ids, certified = search_scores_large(
                search_params, index, queries, k)
            if bool(certified.all()):
                q = dist_ops.l2_normalize(queries) \
                    if index.metric == Metric.COSINE else queries
                return dist_ops.scores_to_distances(
                    scores, dist_ops.sqnorms(q), index.metric
                ), ids
            default_registry.inc("flat.certificate_reruns")
            return _search_core(search_params, index, queries, k, False)
        return _search_core(
            search_params, index, queries, k, _use_kernel(index, k)
        )
