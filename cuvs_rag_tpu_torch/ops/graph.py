"""Graph-index ops: kNN-graph construction and monotone-beam search.

The PyTorch counterpart of the JAX package's `ops/graph.py` (cuVS CAGRA's
build and search, reshaped for batched tensor ops):

  * Graph build: the intermediate graph is an exact kNN graph
    (`build_knn_graph`, chunked matmul + top-k) up to ~10^5 rows, beyond
    that the list-centric IVF bootstrap (`build_knn_graph_ivf`): each IVF
    list's rows are scored against its own rows and those of its
    `n_probes - 1` nearest sibling lists in one batched product. The
    final graph keeps half its slots for forward edges and fills the rest
    with reverse edges (`augment_reverse_edges`, one stable sort + a
    segment gather).
  * Search: a fixed-width beam over a fixed number of iterations, batched
    over queries as (Q, itopk) tensors. Deduplication uses the MONOTONE
    BEAM: the beam keeps the best `itopk` scores seen so far, so an id
    displaced from it can never re-enter, and "visited and still relevant"
    is "in the current beam". Two masks do it: new ids against the beam,
    and later copies within the new batch. An iteration is two steps, each
    one launch of a hand-written kernel on the card where
    `ops/graph_kernels` admits the shapes: the candidate step (the
    parents' graph rows, their scores, both masks: `candidates_plain`,
    routed by `candidate_step`), and the merge step (the new beam and the
    next iteration's picks: `merge_plain`, routed by `merge_step`, which
    refuses a card's beam wider than the kernel holds). The entry rows
    take the same two steps.

Every selection of the beam breaks ties by position, lowest first, as
`lax.top_k` does (`topk_first`): the JAX search relies on that order (a
masked -inf candidate never displaces an earlier -inf slot), and
`torch.topk` promises no order among ties. Tombstoned rows score a finite
~-2e30, so ties among them are ordinary, not rare.

Deliberate differences from the JAX package: `build_knn_graph_ivf` ranks
fp32 scores with exact `torch.topk` where the JAX package ranks bf16 scores
with `approx_max_k(recall_target=0.98)` (the graphs differ by a few percent
of edges and are held by recall); int8 IVF windows are scored as their fp32
reconstruction.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import graph_kernels
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import Metric
from cuvs_rag_tpu_torch.utils.metrics import default_registry

NEG_INF = topk_ops.NEG_INF

# Bytes of the fp32 score tile one step of the IVF bootstrap may hold:
# B lists x own rows x the r probed lists' rows x 4 bytes (64 MB a list of
# 2,000 rows probing 4 such lists).
_IVF_TILE_BYTES = 1 << 30
# Reverse-edge candidates whose forward rows one dedup step gathers.
_DEDUP_CHUNK = 1 << 22
# Queries one beam pass carries: bounds the (Q, e·G, width) gathered rows.
_BEAM_QUERY_CHUNK = 256


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lowest position
    (`lax.top_k`'s order): a stable descending sort."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def earlier_copy(v: torch.Tensor) -> torch.Tensor:
    """(..., M) ids -> (..., M) bool: True where an EARLIER element of the
    row equals v[i]. A stable sort puts each value's copies in position
    order, so every element of a run but its first has an earlier copy."""
    s, order = torch.sort(v, dim=-1, stable=True)
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return torch.zeros_like(dup).scatter_(-1, order, dup)


def linspace_rows(n_pad: int, count: int, device) -> torch.Tensor:
    """(count,) int32 `jnp.linspace(0, n_pad - 1, count).astype(int32)` as
    the JAX package computes it on the CPU: XLA evaluates stop·(i / div) as
    (stop·fl(1/div))·i in fp32 and truncates, and the evenly spaced entry
    rows must be the same rows."""
    if count == 1:
        return torch.zeros(1, dtype=torch.int32, device=device)
    stop = np.float32(n_pad - 1)
    scale = stop * (np.float32(1) / np.float32(count - 1))
    v = scale * np.arange(count - 1, dtype=np.float32)
    rows = np.append(v, stop).astype(np.int32)
    return torch.from_numpy(rows).to(device)


# ------------------------------------------------------------- build ---


def build_knn_graph(vectors: torch.Tensor, sqnorms: torch.Tensor,
                    n_valid: int, *, degree: int, metric: str,
                    query_chunk: int = 1024) -> torch.Tensor:
    """(Np, D) -> (Np, degree) int32 exact neighbour ids, self excluded.

    Chunks of rows are scored against the whole block (one matmul and one
    top-k each). Pad rows and slots without a valid neighbour self-loop;
    the search masks them through the augmented rows' tombstones."""
    n_pad = vectors.shape[0]
    dev = vectors.device
    graph = torch.empty((n_pad, degree), dtype=torch.int32, device=dev)
    for start in range(0, n_pad, query_chunk):
        q = vectors[start:start + query_chunk].float()
        scores, idx = topk_ops.flat_topk_search_dense(
            vectors, sqnorms, q, n_valid, k=degree + 1, metric=metric)
        rows = torch.arange(start, start + q.shape[0], dtype=torch.int32,
                            device=dev)[:, None]
        scores = scores.masked_fill(idx == rows, NEG_INF)
        _, order = torch.topk(scores, degree, dim=1)
        nbrs = torch.gather(idx, 1, order)
        graph[start:start + q.shape[0]] = torch.where(
            nbrs >= 0, nbrs, rows.expand_as(nbrs))
    return graph


def _windows(ivf_index, lists: torch.Tensor):
    """Rows of each list's window: (..., L) layout positions, (..., L) ids
    (-1 past the list's count) and the raw (..., L) row_ids there."""
    L = ivf_index.max_list_size
    pos = torch.arange(L, device=lists.device)
    slots = ivf_index.list_offsets[lists].long()[..., None] + pos
    slots = slots.clamp(max=ivf_index.size - 1)
    raw = ivf_index.row_ids[slots]
    live = pos < ivf_index.list_counts[lists][..., None]
    return slots, torch.where(live, raw, torch.full_like(raw, -1)), raw


def _window_rows(ivf_index, slots: torch.Tensor, lists: torch.Tensor):
    """(rows fp32, sqnorms) at layout `slots`: float storage as stored, int8
    residual SQ8 as its reconstruction c_list + scale·code (`lists`: each
    slot's list, the shape of `slots`)."""
    v = ivf_index.vectors[slots].float()
    if ivf_index.vectors.dtype != torch.int8:
        return v, ivf_index.sqnorms[slots]
    cents = ivf_index.centroids.float()[lists]
    return cents + ivf_index.scales[slots][..., None] * v, \
        ivf_index.sqnorms[slots]


def _bootstrap_steps(counts: np.ndarray, nbrs: np.ndarray, budget: int):
    """The steps of the IVF bootstrap: the non-empty lists in order of
    falling size, each step as many as keep its fp32 score tile (lists x
    own window x candidate window x 4 bytes) within `budget`, the windows
    sized to the step's largest own list and largest candidate total (the
    summed sizes of a list's probed lists), each rounded up to 8 rows.
    -> [(list ids, own window, candidate window)]."""
    def up8(v):
        return topk_ops.round_up(int(v), 8)

    totals = counts[nbrs].sum(axis=1)
    order = [int(i) for i in np.argsort(-counts, kind="stable")
             if counts[i] > 0]
    steps, i = [], 0
    while i < len(order):
        own, cand, j = up8(counts[order[i]]), up8(totals[order[i]]), i + 1
        while j < len(order):
            wider = max(cand, up8(totals[order[j]]))
            if (j - i + 1) * own * wider * 4 > budget:
                break
            cand, j = wider, j + 1
        steps.append((order[i:j], own, cand))
        i = j
    return steps


def build_knn_graph_ivf(vectors: torch.Tensor, n_valid: int, ivf_index, *,
                        degree: int, n_probes: int = 4) -> torch.Tensor:
    """Approximate kNN graph from an IVF clustering of the same rows.

    List-centric: each list's rows are scored against the rows of its r =
    n_probes nearest lists (itself included), laid end to end, in one
    product, and each own row keeps its top `degree` candidates. Lists go
    in steps of similar size (`_bootstrap_steps`), a step's windows sized
    to its own lists and candidate totals rather than to the longest list,
    and one batched product a step, its fp32 score tile within
    _IVF_TILE_BYTES. Self-matches are dropped; rows with fewer valid
    candidates than `degree` self-loop, as do rows no list holds.

    vectors: (n_pad, D) rows in original order (the graph's ids index it);
    ivf_index: an IVFFlatIndex over the same rows (any storage dtype)."""
    n_pad = vectors.shape[0]
    dev = vectors.device
    cents = ivf_index.centroids.float()
    n_lists = cents.shape[0]
    r = max(1, min(n_probes, n_lists))
    c_scores = dist_ops.scores_from_tile(cents, cents, dist_ops.sqnorms(cents),
                                         Metric.SQEUCLIDEAN)
    list_nbrs = torch.topk(c_scores, r, dim=1).indices  # (C, r), self incl.
    counts = ivf_index.list_counts.long()
    offsets = ivf_index.list_offsets.long()
    last = ivf_index.size - 1
    graph = torch.arange(n_pad, dtype=torch.int32, device=dev)[:, None] \
        .repeat(1, degree)
    steps = _bootstrap_steps(counts.cpu().numpy(), list_nbrs.cpu().numpy(),
                             _IVF_TILE_BYTES)
    for step, own_w, cand_w in steps:
        lists = torch.tensor(step, device=dev)
        b = lists.shape[0]
        # own windows: (b, own_w) slots of each list's rows
        pos = torch.arange(own_w, device=dev)
        own_slots = (offsets[lists][:, None] + pos).clamp(max=last)
        own_ids = torch.where(pos < counts[lists][:, None],
                              ivf_index.row_ids[own_slots].long(), -1)
        own_v, _ = _window_rows(ivf_index, own_slots,
                                lists[:, None].expand_as(own_slots))
        # candidate windows: the r probed lists' rows end to end, (b, cand_w)
        nb = list_nbrs[lists]  # (b, r)
        ends = torch.cumsum(counts[nb], dim=1)
        pos = torch.arange(cand_w, device=dev).expand(b, cand_w).contiguous()
        probe = torch.searchsorted(ends, pos, right=True)  # r: past the end
        at = probe.clamp(max=r - 1)
        cand_lists = torch.gather(nb, 1, at)
        first = torch.gather(ends - counts[nb], 1, at)
        cand_slots = (offsets[cand_lists] + pos - first).clamp(0, last)
        cand_ids = torch.where(probe < r,
                               ivf_index.row_ids[cand_slots].long(), -1)
        cand_v, cand_sq = _window_rows(ivf_index, cand_slots, cand_lists)
        dist_ops._check_fp32_matmul(own_v)
        scores = 2.0 * torch.bmm(own_v, cand_v.transpose(1, 2)) \
            - cand_sq[:, None, :]
        bad = (cand_ids < 0)[:, None, :] \
            | (cand_ids[:, None, :] == own_ids[:, :, None])
        scores.masked_fill_(bad, NEG_INF)
        kk = min(degree, cand_w)
        top_s, order = torch.topk(scores, kk, dim=2)
        nbrs = torch.gather(cand_ids[:, None, :].expand(b, own_w, cand_w), 2,
                            order)
        nbrs = torch.where(top_s > NEG_INF, nbrs, own_ids[..., None]
                           .expand_as(nbrs)).clamp(min=0)
        keep = own_ids.reshape(-1) >= 0
        rows = own_ids.reshape(-1)[keep]
        graph[rows, :kk] = nbrs.reshape(b * own_w, kk)[keep].to(torch.int32)
        del scores, bad, own_v, cand_v
    return graph


def list_medoids(ivf_index) -> torch.Tensor:
    """(C,) int32: per IVF list, the row id nearest its centroid (the beam's
    query-adaptive entry points). The argmax takes the lowest position on
    ties, as `jnp.argmax`; an empty list maps to whatever id its window's
    first slot holds, or 0."""
    cents = ivf_index.centroids
    n_lists, d = cents.shape
    L = ivf_index.max_list_size
    qdtype = torch.bfloat16 if ivf_index.vectors.dtype == torch.int8 \
        else ivf_index.vectors.dtype
    out = torch.empty(n_lists, dtype=torch.int32, device=cents.device)
    step = max(1, _IVF_TILE_BYTES // (L * d * 4))
    for c0 in range(0, n_lists, step):
        lists = torch.arange(c0, min(c0 + step, n_lists), device=cents.device)
        slots, ids, raw = _windows(ivf_index, lists)
        w, wsq = _window_rows(ivf_index, slots,
                              lists[:, None].expand_as(slots))
        q = cents[lists].to(qdtype).float()
        if ivf_index.vectors.dtype == torch.int8:
            # residual SQ8: the reconstruction already carries c, so the
            # centroid scores as itself (the JAX package's coarse term)
            q = cents[lists].float()
        dist_ops._check_fp32_matmul(w)
        s = 2.0 * torch.bmm(w, q[:, :, None])[..., 0] - wsq
        s = s.masked_fill(ids < 0, NEG_INF)
        best = torch.argmax(s, dim=1)
        out[lists] = torch.gather(raw, 1, best[:, None])[:, 0].clamp(min=0) \
            .to(torch.int32)
    return out


def augment_reverse_edges(graph: torch.Tensor, keep: int,
                          forward: int | None = None) -> torch.Tensor:
    """CAGRA-style pruning: `forward` forward edges (default keep // 2) +
    reverse-edge fill (who points at me), unfilled reverse slots falling
    back to the next distance-ranked forward edges.

    All (dst = graph[i, rank], rank, src = i) candidates, minus those that
    repeat one of dst's own forward edges, are sorted stably by (dst, rank):
    each dst's reverse slots take its lowest-rank sources in source order.
    Deterministic, collision-free and equal to the JAX package's result."""
    n = graph.shape[0]
    half = keep // 2 if forward is None else max(1, min(forward, keep))
    cap = keep - half
    if cap == 0:
        return graph[:, :keep].contiguous()
    dev = graph.device
    fwd = graph[:, :half]
    dst = fwd.reshape(-1).long()  # (n·half,), src-major then rank-minor
    dst = torch.where(dst >= 0, dst, torch.full_like(dst, n))
    # a reverse candidate that repeats one of dst's forward edges wastes a
    # slot; the check gathers fwd[dst] a chunk of candidates at a time
    for s in range(0, dst.shape[0], _DEDUP_CHUNK):
        d_c = dst[s:s + _DEDUP_CHUNK]
        src_c = torch.arange(s, s + d_c.shape[0], device=dev) // half
        dup = (fwd[d_c.clamp(max=n - 1)] == src_c[:, None]).any(dim=1)
        dst[s:s + _DEDUP_CHUNK] = torch.where(dup, n, d_c)
    counts = torch.bincount(dst, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts
    # sort key dst·half + rank; the sort is stable and the positions are
    # src·half + rank, so the sorted positions give the sources in order
    key = dst.mul_(half).view(n, half).add_(torch.arange(half, device=dev))
    order = torch.sort(key.view(-1), stable=True).indices
    del key, dst
    src_s = (order // half).to(torch.int32)
    del order
    slot = torch.arange(cap, device=dev)[None, :]
    gidx = (starts[:n, None] + slot).clamp(max=n * half - 1)
    rev = torch.where(slot < counts[:n, None], src_s[gidx],
                      torch.full((), -1, dtype=torch.int32, device=dev))
    rev = torch.where(rev >= 0, rev, graph[:, half:half + cap])
    return torch.cat([fwd, rev], dim=1).to(torch.int32)


def augment_rows(vectors: torch.Tensor, sqnorms: torch.Tensor, n_valid: int,
                 metric: str) -> torch.Tensor:
    """(Np, D) rows -> (Np, width) score-augmented rows, width = D + 2
    rounded up to 128: [v, hi, lo, 0...], so that one row gather carries
    everything a beam score needs.

      sqeuclidean: hi + lo = ||v||² split across two storage-dtype lanes
                   (hi = the storage dtype's round-to-nearest-even of the
                   fp32 sqnorm, lo = the rest); the query is [2q, -1, -1]:
                   q'·v' = 2 q·v - ||v||².
      ip/cosine:   [v, 0, 0]; the query [q, -1, -1].

    Pad rows (>= n_valid) carry hi = DELETED_PENALTY, the tombstone delete()
    writes: every metric scores them ~-2e30. Bit-equal to the JAX package's
    rows (the npz layout is shared)."""
    n_pad, d = vectors.shape
    storage = vectors.dtype
    dev = vectors.device
    if metric == Metric.SQEUCLIDEAN:
        sq = sqnorms.float()
        hi = sq.to(storage)
        lo = (sq - hi.float()).to(storage)
    else:
        hi = torch.zeros(n_pad, dtype=storage, device=dev)
        lo = torch.zeros(n_pad, dtype=storage, device=dev)
    pad = torch.arange(n_pad, device=dev) >= n_valid
    hi = hi.masked_fill(pad, dist_ops.DELETED_PENALTY)
    lo = lo.masked_fill(pad, 0.0)
    width = -(-(d + 2) // 128) * 128
    out = torch.zeros((n_pad, width), dtype=storage, device=dev)
    out[:, :d] = vectors
    out[:, d] = hi
    out[:, d + 1] = lo
    return out


def augmented_query(queries: torch.Tensor, metric: str,
                    width: int) -> torch.Tensor:
    """(Q, D) queries -> (Q, width) fp32, so that q'·v' is the beam score."""
    q = queries.float()
    scale = 2.0 if metric == Metric.SQEUCLIDEAN else 1.0
    out = torch.zeros((q.shape[0], width), dtype=torch.float32,
                      device=q.device)
    out[:, :q.shape[1]] = scale * q
    out[:, q.shape[1]:q.shape[1] + 2] = -1.0
    return out


# ------------------------------------------------------------ search ---


def _score_rows(aug_vectors, aq, ids):
    """(Q, M) ids -> (Q, M) fp32 beam scores q'·v' (one gather a row)."""
    q, m = ids.shape
    vecs = aug_vectors.index_select(0, ids.reshape(-1)).view(q, m, -1)
    return torch.bmm(vecs.float(), aq[:, :, None])[..., 0]


def candidates_plain(aug_vectors, aq, src, *, graph=None, src_scores=None,
                     beam=None):
    """The beam's candidate step in PyTorch ops: (news ids (Q, m) int32,
    their scores (Q, m) fp32, -inf where the merge must not take them).

    With `graph`: src (Q, e) holds the parents an iteration expands (-1
    reads graph row 0) and `src_scores` their pick scores; the news are
    their graph rows end to end, and a parent at or below the tombstone
    threshold spends no expansion (its news score -inf, yet still count as
    earlier copies). Without: src (Q, m) holds the news ids themselves (the
    entry rows). A news id that `beam` (Q, b) holds, or that an earlier
    position of the news holds, scores -inf (the monotone beam's dedup, see
    the module docstring). The plain version of the candidate kernel
    (ops/graph_kernels), which takes this step in one launch on the card."""
    nbrs = src
    if graph is not None:
        n_q, e = src.shape
        g = graph.shape[1]
        nbrs = graph[src.clamp(min=0).long()].reshape(n_q, e * g)
    scores = _score_rows(aug_vectors, aq, nbrs)
    if src_scores is not None:
        # gate on the tombstone threshold: pad and deleted rows score a
        # finite ~-2e30 and must not spend expansions
        valid = src_scores > -dist_ops.DELETED_THRESHOLD
        scores = scores.view(n_q, e, g).masked_fill(
            ~valid[:, :, None], NEG_INF).view(n_q, e * g)
    dup = earlier_copy(nbrs)
    if beam is not None:
        dup = (nbrs[:, :, None] == beam[:, None, :]).any(dim=2) | dup
    return nbrs, scores.masked_fill(dup, NEG_INF)


def candidate_step(aug_vectors, aq, src_cols: int, *, graph=None,
                   beam_width: int = 0):
    """(route, step): a search's candidate step, the kernel's prepared
    launch where graph_kernels.takes admits the shapes (route "kernel"),
    else candidates_plain ("torch"); step(src, src_scores=None, beam=None).
    On the card the kernel takes every CAGRA storage and width; a step of
    more than graph_kernels.MAX_CANDIDATES news a query or a beam of more
    than MAX_BEAM ids runs the plain step there, with a warning the first
    time."""
    m = src_cols * (1 if graph is None else graph.shape[1])
    if graph_kernels.takes(aug_vectors, m, beam_width, graph):
        return "kernel", graph_kernels.prepare(
            aug_vectors, aq, src_cols, graph=graph, beam_width=beam_width)
    if aug_vectors.is_cuda and not candidate_step.warned:
        candidate_step.warned = True
        warnings.warn(
            f"the CAGRA beam's candidate step runs as PyTorch ops on "
            f"{aug_vectors.device}: no kernel for {aug_vectors.dtype} rows "
            f"{tuple(aug_vectors.shape)}, {m} candidates a query and a beam "
            f"of {beam_width} (at most {graph_kernels.MAX_CANDIDATES} and "
            f"{graph_kernels.MAX_BEAM})", RuntimeWarning, stacklevel=2)
    return "torch", lambda src, src_scores=None, beam=None: candidates_plain(
        aug_vectors, aq, src, graph=graph, src_scores=src_scores, beam=beam)


candidate_step.warned = False


def merge_plain(n_scores, nbrs, beam=None, *, b: int, e: int):
    """The beam's merge step in PyTorch ops: -> (scores (Q, b) fp32, ids
    (Q, b) int32, expanded (Q, b) bool, pick_s (Q, e) fp32, pick_ids (Q, e)
    int32).

    With `beam` = (scores, ids, expanded), (Q, b) each with the scores
    sorted descending: the new beam is the b best of the beam and the news
    (n_scores, nbrs (Q, m)), ties to the lower position (the beam's before
    the news'), the news unexpanded. Without: the new beam is the news' b
    best (the entry rows), and its slots past the news hold -inf, -1,
    unexpanded. Then the picks of the next iteration: the e best slots of
    the new beam with its expanded ones as -inf, ties to the lower position
    (so past the live ones, expanded and -inf slots in order: their ids
    still count as earlier copies in the next candidate step); their scores
    (-inf where masked) and ids, their slots marked expanded. Scores are
    finite or -inf. The plain version of the merge kernel
    (ops/graph_kernels), which takes this step on the card; this one runs
    on CPU tensors."""
    n_q, m = n_scores.shape
    if beam is None:
        top, order = topk_first(n_scores, min(b, m))
        scores = torch.full((n_q, b), NEG_INF, device=n_scores.device)
        ids = torch.full((n_q, b), -1, dtype=torch.int32,
                         device=n_scores.device)
        scores[:, :top.shape[1]] = top
        ids[:, :top.shape[1]] = torch.gather(nbrs, 1, order)
        expanded = torch.zeros((n_q, b), dtype=torch.bool,
                               device=n_scores.device)
    else:
        scores, ids, expanded = beam
        fresh = torch.zeros((n_q, m), dtype=torch.bool, device=ids.device)
        scores, sel = topk_first(torch.cat([scores, n_scores], 1), b)
        ids = torch.gather(torch.cat([ids, nbrs], 1), 1, sel)
        expanded = torch.gather(torch.cat([expanded, fresh], 1), 1, sel)
    pick_s, picks = topk_first(scores.masked_fill(expanded, NEG_INF), e)
    pick_ids = torch.gather(ids, 1, picks)
    expanded = expanded.scatter(1, picks, True)
    return scores, ids, expanded, pick_s, pick_ids


def merge_step(aug_vectors, n_q: int, b: int, e: int):
    """(route, merge): a search's merge steps, the kernel's launches on the
    card (route "kernel") and merge_plain on CPU tensors ("torch");
    merge(n_scores, nbrs, beam=None) -> (scores, ids, expanded, pick_s,
    pick_ids), beam the first three of the previous call's outputs, which
    the kernel's launches rewrite in place. The kernel takes any number of
    news; a beam of more than graph_kernels.MERGE_MAX_BEAM slots on the
    card raises ValueError."""
    if graph_kernels.merge_takes(aug_vectors, b, e):
        return "kernel", graph_kernels.prepare_merge(aug_vectors.device, n_q,
                                                     b, e)
    if aug_vectors.is_cuda:
        raise ValueError(
            f"no merge kernel for a beam of {b} slots and {e} picks on "
            f"{aug_vectors.device}: at most "
            f"{graph_kernels.MERGE_MAX_BEAM} slots")
    return "torch", lambda n_scores, nbrs, beam=None: merge_plain(
        n_scores, nbrs, beam, b=b, e=e)


def beam_plan(itopk: int, k: int, expansions: int,
              max_iters: int = 0) -> Tuple[int, int, int]:
    """(beam width b = max(itopk, k), parents expanded an iteration, the
    fixed iteration count: max_iters, else 2·⌈b / e⌉ within [8, 64])."""
    b = max(itopk, k)
    e = max(1, min(expansions, b))
    return b, e, max_iters or min(64, max(8, 2 * -(-b // e)))


def beam_search(aug_vectors: torch.Tensor, graph: torch.Tensor,
                queries: torch.Tensor, *, k: int, metric: str,
                itopk: int = 64, max_iters: int = 0, n_entries: int = 32,
                expansions: int = 4, entry_ids: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration greedy beam search over the graph, all queries at
    once: beam tensors are (Q, b), b = max(itopk, k).

    aug_vectors: (Np, width) score-augmented rows (augment_rows); graph
    (Np, G). Entry points: `entry_ids` (Q, E) per query when given (the
    medoid map), else `n_entries` evenly spaced rows. Each iteration expands
    the `expansions` best unexpanded beam entries (cuVS's search_width).
    While the span recorder is on, the call adds queries x iterations to
    cagra.expand.kernel or cagra.expand.torch, by the candidate step's
    route, and to cagra.merge.kernel or cagra.merge.torch, by the merge
    step's. Returns (scores (Q, k) descending, ids (Q, k) int32); slots
    without a live row hold -inf and -1."""
    n_q = queries.shape[0]
    if n_q > _BEAM_QUERY_CHUNK:
        parts = [beam_search(
            aug_vectors, graph, queries[s:s + _BEAM_QUERY_CHUNK], k=k,
            metric=metric, itopk=itopk, max_iters=max_iters,
            n_entries=n_entries, expansions=expansions,
            entry_ids=None if entry_ids is None
            else entry_ids[s:s + _BEAM_QUERY_CHUNK])
            for s in range(0, n_q, _BEAM_QUERY_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    n_pad, width = aug_vectors.shape
    dev = aug_vectors.device
    b, e, iters = beam_plan(itopk, k, expansions, max_iters)
    aq = augmented_query(queries, metric, width)
    if entry_ids is None:
        entry_ids = linspace_rows(n_pad, n_entries, dev).expand(n_q, -1)
    entry_ids = entry_ids.to(torch.int32)
    n_e = entry_ids.shape[1]

    # the route of each step, from its shapes: the iterations' are counted
    # by queries x iterations while the recorder is on
    route, expand = candidate_step(aug_vectors, aq, e, graph=graph,
                                   beam_width=b)
    merge_route, merge = merge_step(aug_vectors, n_q, b, e)
    if profiling.recording():
        default_registry.inc(f"cagra.expand.{route}", iters * n_q)
        default_registry.inc(f"cagra.merge.{merge_route}", iters * n_q)
    # the entry rows, id-distinct (the monotone-beam dedup needs the first
    # beam so), are the first beam; the merge step also makes its picks
    nbrs, e_scores = candidate_step(aug_vectors, aq, n_e)[1](entry_ids)
    scores, ids, expanded, pick_s, pick_ids = merge(e_scores, nbrs)

    for _ in range(iters):
        # the news, masked where expanded from a tombstone, already in the
        # beam, or an earlier news' copy (candidates_plain)
        nbrs, n_scores = expand(pick_ids, pick_s, ids)
        scores, ids, expanded, pick_s, pick_ids = merge(
            n_scores, nbrs, (scores, ids, expanded))

    # the beam is sorted (ties by position), so its first k are its top k;
    # a tombstoned row can hold a slot when the beam saw fewer than k live
    # rows: report it empty, as a pad
    out_s, out_i = scores[:, :k], ids[:, :k]
    live = out_s > -dist_ops.DELETED_THRESHOLD
    return (out_s.masked_fill(~live, NEG_INF),
            out_i.masked_fill(~live, -1))
