"""Filtered (allow-list) search — FAISS `IDSelector` / cuVS prefilter parity.

The counterpart of the JAX package's `index/filters.py`. A filtered view
(`filtered_view(index, allow)`) is a same-type index that shares the
vector storage and replaces one (rows,)-shaped bookkeeping tensor, in each
family the one its tombstone deletion uses: for FlatIndex and IVFFlatIndex
the sqnorm slots of excluded rows are raised past the deletion threshold,
for IVFPQIndex their row_ids become -1. Every search path and kernel
already honours these, so a view searches at the cost of a normal search.
Views compose with deletion (deleted rows stay dead) and are positionally
exact: search(view) equals search restricted to the allowed rows.

CAGRA has no view: the beam must walk through excluded rows to keep the
graph connected (a scoring tombstone would cut their edges), so `search`
post-filters it: the beam over-fetches max(k, k·over_fetch) candidates,
capped at itopk_size, and excluded ones are masked afterwards. Results are
always ⊆ allow; recall under a selective filter follows over_fetch and
itopk_size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops


def allow_from_ids(n: int, ids) -> np.ndarray:
    """(n,) bool mask allowing exactly `ids` (out-of-range ids ignored)."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    mask = np.zeros((n,), dtype=bool)
    mask[ids[(ids >= 0) & (ids < n)]] = True
    return mask


def deny_from_ids(n: int, ids) -> np.ndarray:
    """(n,) bool mask allowing everything EXCEPT `ids`."""
    return ~allow_from_ids(n, ids)


def _as_mask(allow, n: int, device) -> torch.Tensor:
    """Validate an allow mask for an n-row corpus; a bool tensor on
    `device`."""
    mask = torch.as_tensor(allow, device=device)
    if mask.dtype != torch.bool:
        raise ValueError(
            f"allow must be a boolean mask, got dtype {mask.dtype}; build one "
            "with filters.allow_from_ids/deny_from_ids")
    if mask.ndim != 1 or mask.shape[0] != n:
        raise ValueError(f"allow mask must be ({n},) to match the corpus "
                         f"rows, got {tuple(mask.shape)}")
    return mask


def _penalize_slots(sqnorms: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """Raise excluded rows' sqnorm slots past the deletion threshold."""
    return sqnorms + torch.where(allow, 0.0, dist_ops.DELETED_PENALTY)


def _gather_by_row_ids(allow: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """Permute an original-id mask into a sorted-CSR layout:
    out[slot] = allow[row_ids[slot]], False on pads (row_ids -1) and on
    ids past the mask."""
    n = allow.shape[0]
    ext = torch.cat([allow, allow.new_zeros(1)])
    idx = torch.where((row_ids >= 0) & (row_ids < n), row_ids,
                      torch.full_like(row_ids, n))
    return ext[idx.long()]


def view_traced(index, allow: torch.Tensor):
    """Core of `filtered_view`, without validation. `allow` is a bool mask
    over original ids: for FlatIndex as wide as the padded row count, for
    the IVF families any width (ids past it read False)."""
    from cuvs_rag_tpu_torch.index import flat as flat_mod
    from cuvs_rag_tpu_torch.index import ivf_flat as ivf_mod
    from cuvs_rag_tpu_torch.index import ivf_pq as pq_mod

    if isinstance(index, flat_mod.FlatIndex):
        return dataclasses.replace(
            index, sqnorms=_penalize_slots(index.sqnorms, allow))
    if isinstance(index, ivf_mod.IVFFlatIndex):
        a = _gather_by_row_ids(allow, index.row_ids)
        return dataclasses.replace(
            index, sqnorms=_penalize_slots(index.sqnorms, a))
    if isinstance(index, pq_mod.IVFPQIndex):
        # the ADC scan drops id < 0 slots before selection and the refine
        # pool inherits its ids: one masked tensor filters both passes.
        # deleted_ids() on the VIEW reports excluded rows as deleted: call
        # it on the base index.
        a = _gather_by_row_ids(allow, index.row_ids)
        return dataclasses.replace(
            index, row_ids=torch.where(a, index.row_ids,
                                       torch.full_like(index.row_ids, -1)))
    raise _unsupported(index)


def _unsupported(index) -> Exception:
    name = type(index).__name__
    if name in ("ShardedIndex", "ReplicatedIndex"):
        return TypeError(f"{name} takes its views and filtered searches "
                         "through parallel/search.view and search")
    if name == "CagraIndex":
        return TypeError("CAGRA filtering is post-filter only: use "
                         "filters.search")
    return TypeError(f"filtered views do not support {name}")


def _families():
    from cuvs_rag_tpu_torch.index import flat as flat_mod
    from cuvs_rag_tpu_torch.index import ivf_flat as ivf_mod
    from cuvs_rag_tpu_torch.index import ivf_pq as pq_mod

    return {flat_mod.FlatIndex: flat_mod, ivf_mod.IVFFlatIndex: ivf_mod,
            pq_mod.IVFPQIndex: pq_mod}


def filtered_view(index, allow):
    """Same-type index restricted to `allow`, a (n_valid,) bool mask over
    ORIGINAL corpus ids (numpy or tensor). Shares the vector storage.
    Deleted rows stay deleted whatever the mask. Reusable across searches:
    build once per filter."""
    from cuvs_rag_tpu_torch.index import flat as flat_mod

    if type(index) not in _families():
        raise _unsupported(index)
    mask = _as_mask(allow, int(index.n_valid), index.device)
    if isinstance(index, flat_mod.FlatIndex) and index.size > mask.shape[0]:
        mask = torch.cat([mask, mask.new_zeros(index.size - mask.shape[0])])
    return view_traced(index, mask)


def _family_module(index):
    return _families()[type(index)]


def _cagra_postfilter(search_params, index, queries, allow, k: int,
                      kk: int):
    """The beam's top-kk, excluded ids masked, then the top k of what is
    left (ties to the lowest position, as the JAX package's top_k)."""
    from cuvs_rag_tpu_torch.index import cagra as cagra_mod
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    scores, ids = cagra_mod.search_scores(search_params, index, queries, kk)
    ok = _gather_by_row_ids(allow, ids.reshape(-1)).reshape(ids.shape)
    top_s, arg = graph_ops.topk_first(
        scores.masked_fill(~ok, graph_ops.NEG_INF), k)
    top_i = torch.gather(ids, 1, arg).masked_fill(
        top_s == graph_ops.NEG_INF, -1)
    return cagra_mod._to_distances(top_s, index, queries), top_i


def search(search_params, index, queries, k: int, allow,
           over_fetch: float = 4.0):
    """Filtered search for any ported family: (distances, original ids),
    always ⊆ allow; surplus slots report id -1 when fewer than k allowed
    rows are reachable.

    flat / ivf_flat / ivf_pq: exact view semantics. cagra: the beam runs at
    max(k, round(k·over_fetch)) <= itopk_size candidates and is masked
    afterwards; raise over_fetch or itopk_size for selective filters."""
    from cuvs_rag_tpu_torch.index import base
    from cuvs_rag_tpu_torch.index import cagra as cagra_mod

    if isinstance(index, cagra_mod.CagraIndex):
        queries = base.validate_queries(
            base.as_tensor(queries, index.device), index.dim)
        sp = search_params or cagra_mod.default_search_params()
        if k > sp.itopk_size:
            raise ValueError(f"k={k} exceeds itopk_size={sp.itopk_size}; "
                             "raise CagraSearchParams.itopk_size")
        kk = min(max(k, int(round(k * over_fetch))), sp.itopk_size)
        mask = _as_mask(allow, index.n_valid, index.device)
        return _cagra_postfilter(sp, index, queries, mask, k, kk)
    view = filtered_view(index, allow)
    return _family_module(view).search(search_params, view, queries, k)
