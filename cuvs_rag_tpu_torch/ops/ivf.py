"""IVF inverted-list layout and the probe and scan ops.

The counterpart of the JAX package's `ops/ivf.py`. Variable-length inverted
lists live in one *sorted-CSR* array: rows stably sorted by list id, every
list starting at a multiple of ALIGN, with per-list (offset, count).
Probing list c reads the window [offset_c, offset_c + count_c).

ALIGN = 128 is kept although no kernel here needs it: it is part of the
saved layout, which an index built by the JAX package brings with it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import kmeans as kmeans_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops

ALIGN = 128


def list_counts_device(labels: torch.Tensor, valid: torch.Tensor,
                       n_lists: int) -> torch.Tensor:
    """(N,) labels + (N,) valid -> (C,) int32 per-list counts."""
    return kmeans_ops._bincount(labels, n_lists, valid)


class IVFLayout(NamedTuple):
    sorted_vectors: torch.Tensor  # (cap, D) rows sorted by list id, then pad
    sorted_sqnorms: torch.Tensor  # (cap,)
    sorted_scales: torch.Tensor  # (cap,) dequant scales (1.0 float dtypes)
    sorted_row_ids: torch.Tensor  # (cap,) original row id, -1 on pad rows
    list_offsets: torch.Tensor  # (C,) int32 start of each list
    list_counts: torch.Tensor  # (C,) int32 list length (window-capped)
    truncated: int  # rows unreachable because of the window cap


def unreachable_live_rows(sorted_row_ids, list_offsets, list_counts) -> int:
    """Host-side: live rows sitting in slots no probe window reaches (a
    window-capped layout). build()/extend() layouts always give 0."""
    rid = sorted_row_ids.cpu().numpy()
    offs = list_offsets.cpu().numpy().astype(np.int64)
    cnts = list_counts.cpu().numpy().astype(np.int64)
    slots = np.arange(rid.shape[0], dtype=np.int64)
    li = np.searchsorted(offs, slots, side="right") - 1
    reachable = slots < offs[li] + cnts[li]
    return int(np.count_nonzero((rid >= 0) & ~reachable))


def tombstone_layout(sorted_row_ids: torch.Tensor, ids, n_valid: int):
    """Slots whose original row id is in `ids`: ((cap,) bool hit mask,
    (cap,) row_ids with the hits set to -1). Out-of-range ids are ignored;
    -1 slots never match."""
    ids = torch.as_tensor(ids, device=sorted_row_ids.device).reshape(-1)
    ids = ids[(ids >= 0) & (ids < int(n_valid))].to(sorted_row_ids.dtype)
    hit = torch.isin(sorted_row_ids, ids) & (sorted_row_ids >= 0)
    return hit, torch.where(hit, torch.full_like(sorted_row_ids, -1),
                            sorted_row_ids)


def capacity_for(n_pad: int, n_lists: int, max_list: int,
                 headroom: int = 0) -> int:
    """Capacity of the aligned layout: every row, up to ALIGN-1 pad rows
    per list, optional per-list headroom, and one full window of tail."""
    return topk_ops.round_up(n_pad + (ALIGN + headroom) * n_lists + max_list,
                             ALIGN)


def sort_by_list(labels: torch.Tensor, valid: torch.Tensor, n_lists: int,
                 capacity: int, headroom: int = 0):
    """Aligned-CSR ordering: (perm, target_pos, row_ids, counts, offsets).

    perm is the label-stable sort order (invalid rows last); target_pos maps
    perm order to the aligned buffer position; row_ids[slot] is the source
    row, -1 on gaps between lists and on the tail."""
    n = labels.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < rows {n}")
    dev = labels.device
    key = torch.where(valid, labels.to(torch.int64),
                      torch.full_like(labels, n_lists, dtype=torch.int64))
    perm = torch.argsort(key, stable=True)
    sorted_key = key[perm]
    counts = list_counts_device(labels, valid, n_lists)
    aligned = ((counts + headroom + (ALIGN - 1)) // ALIGN * ALIGN).to(torch.int32)
    offsets = kmeans_ops.exclusive_starts(aligned)
    contig = kmeans_ops.exclusive_starts(counts)
    total_valid = counts.sum()
    aligned_total = aligned.sum()
    pos_in_sort = torch.arange(n, dtype=torch.int64, device=dev)
    is_valid_row = sorted_key < n_lists
    safe_key = torch.clamp(sorted_key, max=n_lists - 1)
    rank = pos_in_sort - contig[safe_key]
    target_valid = offsets[safe_key] + rank
    target_invalid = aligned_total + (pos_in_sort - total_valid)
    target_pos = torch.clamp(
        torch.where(is_valid_row, target_valid, target_invalid), 0,
        capacity - 1)
    row_ids = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    row_ids[target_pos] = torch.where(
        is_valid_row, perm, torch.full_like(perm, -1)).to(torch.int32)
    return perm, target_pos, row_ids, counts, offsets


def build_layout(vectors: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, *, n_lists: int, capacity: int,
                 max_list_size: int, scales=None, sqnorms=None,
                 headroom: int = 0) -> IVFLayout:
    """Arrange (N, D) storage rows into the sorted-CSR layout. For SQ8 int8
    storage pass the per-row `scales` and the reconstruction `sqnorms`
    (||c + s r||^2), which the layout cannot recompute from residual codes.
    Rows of a list beyond `max_list_size` are counted in `truncated`."""
    _, _, row_ids, counts, offsets = sort_by_list(
        labels, valid, n_lists, capacity, headroom)
    # one gather over the rows (row_ids inverts the permutation), then
    # zero the gap slots in place
    slot_ok = row_ids >= 0
    src = torch.clamp(row_ids, min=0).long()
    sorted_vecs = vectors[src]
    sorted_vecs[~slot_ok] = 0
    truncated = int(torch.clamp(counts - max_list_size, min=0).sum())
    if scales is not None:
        if sqnorms is None:
            raise ValueError("int8 layouts need reconstruction sqnorms")
        sorted_scales = torch.where(slot_ok, scales[src].float(), 1.0)
        sorted_sq = torch.where(slot_ok, sqnorms[src].float(), 0.0)
    else:
        sorted_scales = torch.ones(capacity, dtype=torch.float32,
                                   device=vectors.device)
        sorted_sq = dist_ops.sqnorms(sorted_vecs)
    return IVFLayout(
        sorted_vectors=sorted_vecs, sorted_sqnorms=sorted_sq,
        sorted_scales=sorted_scales, sorted_row_ids=row_ids,
        list_offsets=offsets,
        list_counts=torch.clamp(counts, max=max_list_size),
        truncated=truncated,
    )


def probe_lists(queries: torch.Tensor, centroids: torch.Tensor,
                centroid_sqnorms: torch.Tensor, n_probes: int, metric: str):
    """(Q, D) -> ((Q, P) coarse scores, (Q, P) int32 nearest-list ids)."""
    scores = dist_ops.scores_from_tile(queries, centroids, centroid_sqnorms,
                                       metric)
    top_s, ids = torch.topk(scores, n_probes, dim=1)
    return top_s, ids.to(torch.int32)


# Elements of the gathered (queries, probes, window, D) block per chunk of
# queries in scan_probed_lists: bounds its fp32 temporary at 1 GiB.
_SCAN_ELEMS = 1 << 28


def scan_probed_lists(queries: torch.Tensor, probe_ids: torch.Tensor,
                      layout_vectors: torch.Tensor,
                      layout_sqnorms: torch.Tensor,
                      layout_row_ids: torch.Tensor,
                      list_offsets: torch.Tensor, list_counts: torch.Tensor,
                      *, max_list_size: int, metric: str, k: int,
                      layout_scales=None, coarse_ip=None):
    """Score each query against its probed windows; per-query top-k.

    queries (Q, D), probe_ids (Q, P). Returns (scores (Q, k), original row
    ids (Q, k)). Slots past a list's count and slots whose row id is -1
    never win. The counterpart of the JAX package's XLA scan: the path for
    k beyond the kernels and the re-run after a failed certificate.
    """
    q_n, d = queries.shape
    p_n = probe_ids.shape[1]
    cap = layout_vectors.shape[0]
    dev = queries.device
    L = max_list_size
    is_int8 = layout_vectors.dtype == torch.int8
    if layout_scales is None:
        layout_scales = torch.ones(cap, dtype=torch.float32, device=dev)
    if coarse_ip is None:
        coarse_ip = torch.zeros(probe_ids.shape, dtype=torch.float32,
                                device=dev)
    qs = queries.to(topk_ops.query_dtype(layout_vectors.dtype)).float()
    pos = torch.arange(L, device=dev)
    probes = probe_ids.long()
    offs = list_offsets.long()[probes]  # (Q, P)
    cnts = list_counts.long()[probes]
    mult = 2.0 if metric == "sqeuclidean" else 1.0
    out_s, out_i = [], []
    step = max(1, _SCAN_ELEMS // max(1, p_n * L * d))
    for q0 in range(0, q_n, step):
        q1 = min(q_n, q0 + step)
        slots = torch.clamp(offs[q0:q1, :, None] + pos, max=cap - 1)  # (q,P,L)
        win = layout_vectors[slots].float()  # (q, P, L, D)
        ip = torch.einsum("qpld,qd->qpl", win, qs[q0:q1])
        ip = ip * layout_scales[slots]
        sq = layout_sqnorms[slots]
        if metric == "sqeuclidean":
            s = mult * ip - sq
        else:
            s = ip - dist_ops.deletion_penalty(sq)
        if is_int8:
            s = s + coarse_ip[q0:q1, :, None].float()
        ids = layout_row_ids[slots]
        s = torch.where((pos < cnts[q0:q1, :, None]) & (ids >= 0), s,
                        torch.full_like(s, topk_ops.NEG_INF))
        top_s, top_i = topk_ops.merge_topk(s.reshape(q1 - q0, -1),
                                           ids.reshape(q1 - q0, -1), k)
        out_s.append(top_s)
        out_i.append(top_i)
    return torch.cat(out_s), torch.cat(out_i)


def invert_layout(row_ids: torch.Tensor, list_offsets: torch.Tensor, nv: int):
    """Inverse maps of an aligned sorted-CSR layout: (slot_of (nv,) the slot
    of each original row, label_of_slot (cap,) each slot's list id). Gap and
    pad slots map to the preceding list; only slots reached through slot_of
    are ever read."""
    cap = row_ids.shape[0]
    dev = row_ids.device
    slot_iota = torch.arange(cap, dtype=torch.int32, device=dev)
    rid = torch.where(row_ids >= 0, row_ids, torch.full_like(row_ids, nv))
    slot_of = torch.zeros(nv + 1, dtype=torch.int32, device=dev)
    slot_of[rid.long()] = slot_iota
    label_of_slot = (torch.searchsorted(list_offsets.long(), slot_iota.long(),
                                        right=True) - 1).to(torch.int32)
    return slot_of[:nv], label_of_slot


def append_targets(labels_new: torch.Tensor, counts: torch.Tensor,
                   offsets: torch.Tensor):
    """Scatter plan of an in-place aligned-CSR append: new rows go to
    offset[l] + count[l] + within-list rank. Returns (order, target,
    cnt_new): scatter payload[order] -> target, bump counts by cnt_new."""
    b = labels_new.shape[0]
    n_lists = counts.shape[0]
    cnt_new = list_counts_device(
        labels_new, torch.ones(b, dtype=torch.bool, device=labels_new.device),
        n_lists)
    starts = kmeans_ops.exclusive_starts(cnt_new)
    order = torch.argsort(labels_new, stable=True)
    lab_s = labels_new[order].long()
    rank = torch.arange(b, dtype=torch.int32, device=labels_new.device) \
        - starts[lab_s]
    target = offsets[lab_s] + counts[lab_s] + rank
    return order, target, cnt_new


def labels_with_counts(vectors, centroids, n_rows: int,
                       balance_factor: float, valid):
    """Assignment with a host-checked balance fast path: one top-t pass;
    the capacity-bounded spill runs only when some list exceeds
    cap = ceil(balance_factor * n_rows / C) (>= 8). Returns (labels (N,)
    on the device, counts (C,) numpy)."""
    n_lists = centroids.shape[0]
    if balance_factor <= 0 or n_lists <= 1:
        labels = kmeans_ops.assign_clusters(vectors, centroids)
        return labels, list_counts_device(labels, valid, n_lists).cpu().numpy()
    t = int(min(8, n_lists))
    top, margins = kmeans_ops.assign_topk_clusters(vectors, centroids, t=t)
    labels = top[:, 0].contiguous()
    counts = list_counts_device(labels, valid, n_lists).cpu().numpy()
    cap = max(8, int(-(-balance_factor * n_rows // n_lists)))
    if int(counts.max()) <= cap:
        return labels, counts
    labels = kmeans_ops.balance_assignments_device(
        top, margins, valid, n_lists=n_lists, cap=cap)
    return labels, list_counts_device(labels, valid, n_lists).cpu().numpy()
