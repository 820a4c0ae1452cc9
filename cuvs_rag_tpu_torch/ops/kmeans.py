"""K-means for the IVF coarse quantizer.

The counterpart of the JAX package's `ops/kmeans.py`: assignment is a
chunked (rows x centroids) score product + argmax or top-t, the centroid
update is a one-hot segment sum written as a product, the init is blocked
k-means++ with Gumbel top-B draws, and clusters are split biggest-with-
smallest. These are plain large products outside any kernel, so they go to
`torch.matmul` (fp32 operands, TF32 off: see ops/distance.py).

Scoring precision follows storage precision: bf16 data is scored on its
bf16 values (upcast exactly to fp32 operands, fp32 accumulation); centroid
state and the update sums stay fp32.

Deliberate difference: `assign_topk_clusters` takes the exact `torch.topk`
for every cluster count, where the JAX package takes `approx_max_k` from 64
clusters up. The top-1 (the assignment) agrees; ranks 2..t only order the
spill preferences of the balanced assignment.

Random draws come from a `torch.Generator`; they cannot reproduce the JAX
package's `jax.random` draws, so two builds from one seed differ by RNG.
"""

from __future__ import annotations

import math

import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops

_CHUNK = 8192  # rows per assignment chunk: bounds the (chunk, C) score tile


def _score_dtype(data: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if data.dtype == torch.bfloat16 else torch.float32


def _chunk_scores(x, cents_s, c_sq, sdt) -> torch.Tensor:
    """(chunk, C) sqeuclidean scores 2 x.c - ||c||^2 of rows `x` (any dtype,
    cast per chunk to the scoring dtype) against scoring-dtype centroids."""
    return dist_ops.scores_from_tile(x.to(sdt), cents_s, c_sq,
                                     "sqeuclidean")


def assign_topk_clusters(data: torch.Tensor, centroids: torch.Tensor,
                         t: int = 4, chunk: int = _CHUNK):
    """(N, D), (C, D) -> ((N, t) int32 nearest centroids, best first;
    (N,) fp32 margin between the best and the runner-up score)."""
    n = data.shape[0]
    sdt = _score_dtype(data)
    c_sq = dist_ops.sqnorms(centroids)
    cents = centroids.to(sdt)
    labels = torch.empty((n, t), dtype=torch.int32, device=data.device)
    margins = torch.empty(n, dtype=torch.float32, device=data.device)
    for i in range(0, n, chunk):
        scores = _chunk_scores(data[i:i + chunk], cents, c_sq, sdt)
        top_s, ids = torch.topk(scores, t, dim=1)
        labels[i:i + chunk] = ids.to(torch.int32)
        margins[i:i + chunk] = top_s[:, 0] - top_s[:, 1] if t > 1 \
            else top_s[:, 0] * 0
    return labels, margins


def assign_clusters(data: torch.Tensor, centroids: torch.Tensor,
                    chunk: int = _CHUNK) -> torch.Tensor:
    """(N, D), (C, D) -> (N,) int32 nearest-centroid labels (sq-L2), the
    first maximum on ties."""
    n = data.shape[0]
    sdt = _score_dtype(data)
    c_sq = dist_ops.sqnorms(centroids)
    cents = centroids.to(sdt)
    labels = torch.empty(n, dtype=torch.int32, device=data.device)
    for i in range(0, n, chunk):
        scores = _chunk_scores(data[i:i + chunk], cents, c_sq, sdt)
        labels[i:i + chunk] = torch.argmax(scores, dim=1).to(torch.int32)
    return labels


def exclusive_starts(counts: torch.Tensor) -> torch.Tensor:
    """(C,) per-segment counts -> (C,) exclusive-cumsum segment starts."""
    starts = torch.zeros_like(counts, dtype=torch.int32)
    starts[1:] = torch.cumsum(counts, 0)[:-1].to(torch.int32)
    return starts


def _bincount(labels: torch.Tensor, n: int, weights=None) -> torch.Tensor:
    """(n,) int32 counts of `labels` (weighted by 0/1 `weights`)."""
    out = torch.zeros(n, dtype=torch.int32, device=labels.device)
    ones = torch.ones_like(labels, dtype=torch.int32) if weights is None \
        else weights.to(torch.int32)
    return out.index_add_(0, labels.long(), ones)


def _sort2(key1: torch.Tensor, key2: torch.Tensor) -> torch.Tensor:
    """Row order sorted by (key1, key2, row), as the JAX package's
    `lax.sort(..., num_keys=2, is_stable=True)`: two stable sorts, the
    secondary key first."""
    order = torch.sort(key2, stable=True).indices
    return order[torch.sort(key1[order], stable=True).indices]


def balance_assignments_device(top: torch.Tensor, margins: torch.Tensor,
                               valid: torch.Tensor, *, n_lists: int,
                               cap: int, passes: int = 3) -> torch.Tensor:
    """Capacity-bounded assignment: rows spill from over-cap lists to their
    next preference (smallest margin first) in up to `passes` admission-
    controlled passes, then an exact dump pass places what is still over
    cap into the global leftover room, so the max list size is <= cap for
    balance factors >= 1. Pad rows (valid False) never spill and take no
    room. Returns (N,) int32 labels, identical to the JAX package's for
    identical (top, margins, valid)."""
    n, t = top.shape
    dev = top.device
    rows_iota = torch.arange(n, dtype=torch.int32, device=dev)
    neg_m = torch.where(valid, -margins.float(),
                        torch.full_like(margins, math.inf, dtype=torch.float32))
    top = top.to(torch.int32)

    def over_cap(labels):
        return bool((_bincount(labels, n_lists, valid) > cap).any())

    labels = top[:, 0].clone()
    choice = torch.zeros(n, dtype=torch.int32, device=dev)
    i = 0
    while i < passes and over_cap(labels):
        # 1) who must leave: in-list rank by descending margin >= cap
        counts = _bincount(labels, n_lists)
        vcounts = _bincount(labels, n_lists, valid)
        starts = exclusive_starts(counts)
        rows = _sort2(labels, neg_m)
        rank = rows_iota - starts[labels[rows].long()]
        over = torch.zeros(n, dtype=torch.bool, device=dev)
        over[rows] = rank >= cap
        can_move = over & valid & (choice < t - 1)
        nxt = torch.clamp(choice + 1, max=t - 1).long()
        target = top.gather(1, nxt[:, None])[:, 0]
        # 2) admission control: a target admits as many movers as it has
        #    room for (cap minus its own staying rows)
        prop_key = torch.where(can_move, target,
                               torch.full_like(target, n_lists))
        prows = _sort2(prop_key, neg_m)
        pcounts = _bincount(prop_key, n_lists + 1)[:n_lists]
        pstarts = exclusive_starts(pcounts)
        key_sorted = prop_key[prows]
        safe = torch.clamp(key_sorted, max=n_lists - 1).long()
        prank = rows_iota - pstarts[safe]
        room = cap - torch.clamp(vcounts, max=cap)
        admit = torch.zeros(n, dtype=torch.bool, device=dev)
        admit[prows] = (key_sorted < n_lists) & (prank < room[safe])
        # rejected movers advance to their next preference next pass
        choice = torch.where(can_move, choice + 1, choice)
        labels = torch.where(admit, target, labels)
        i += 1
    if over_cap(labels):
        labels = _balance_dump_pass(labels, n_lists=n_lists, cap=cap,
                                    valid=valid, neg_m=neg_m,
                                    rows_iota=rows_iota)
    return labels


def _balance_dump_pass(labels, *, n_lists, cap, valid, neg_m, rows_iota):
    """3) exact dump pass: every row still over cap goes into the global
    leftover room through a cumulative-room search, so the max list size
    is <= cap exactly (balance factor >= 1)."""
    n = labels.shape[0]
    dev = labels.device
    counts = _bincount(labels, n_lists)
    vcounts = _bincount(labels, n_lists, valid)
    starts = exclusive_starts(counts)
    rows = _sort2(labels, neg_m)
    rank = rows_iota - starts[labels[rows].long()]
    mover = torch.zeros(n, dtype=torch.bool, device=dev)
    mover[rows] = rank >= cap
    mover &= valid
    movers_per_list = _bincount(labels, n_lists, mover)
    room = torch.clamp(cap - (vcounts - movers_per_list), min=0)
    cum_room = torch.cumsum(room, 0)
    total_room = cum_room[-1]
    # global mover rank (most-committed rows dump last)
    mrows = _sort2((~mover).to(torch.int32), neg_m)
    mrank = torch.zeros(n, dtype=torch.int64, device=dev)
    mrank[mrows] = rows_iota.long()
    target = torch.searchsorted(cum_room.long(), mrank, right=True)
    placed = mover & (mrank < total_room)
    return torch.where(placed,
                       torch.clamp(target, max=n_lists - 1).to(torch.int32),
                       labels)


def _gumbel(n: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def kmeans(data: torch.Tensor, row_weights, gen: torch.Generator, *,
           n_clusters: int, iters: int = 10, chunk: int = _CHUNK,
           split_small_frac: float = 0.5):
    """Lloyd's k-means. Returns (centroids (C, D) fp32, labels (N,) int32).

    Init: blocked k-means++ (Gumbel top-B D^2 sampling, B <= 32, drawn from
    `gen`; zero-weight rows never picked). `row_weights` None means all
    rows weigh 1. Each iteration reassigns, re-centres by the one-hot
    segment sum, and then pairs the rank-j smallest cluster with the rank-j
    largest: while the large one holds > 1.5x the mean mass and the small
    one <= split_small_frac x the mean, the small centroid is reseeded as a
    perturbed copy of the large one (never on the last iteration).
    """
    n, d = data.shape
    dev = data.device
    sdt = _score_dtype(data)
    data = data.to(sdt)
    w = torch.ones(n, dtype=torch.float32, device=dev) if row_weights is None \
        else row_weights.float()

    # --- init: blocked k-means++ ------------------------------------------
    b = int(max(1, min(32, -(-n_clusters // 32), n)))
    nb = -(-n_clusters // b)
    x_sq = dist_ops.sqnorms(data)
    centroids = torch.zeros((nb * b, d), dtype=torch.float32, device=dev)
    neg = torch.full((n,), -math.inf, device=dev)
    idx = torch.topk(torch.where(w > 0, 0.0, neg) + _gumbel(n, gen, dev),
                     b).indices
    centroids[:b] = data[idx].float()
    min_d = torch.full((n,), math.inf, device=dev)
    for j in range(1, nb):
        prev = centroids[(j - 1) * b:j * b]
        d2 = (x_sq[:, None]
              - 2.0 * dist_ops.pairwise_inner_product(data, prev.to(sdt))
              + (prev * prev).sum(dim=1)[None, :])
        min_d = torch.minimum(min_d, d2.min(dim=1).values)
        logits = torch.where((w > 0) & (min_d > 0), torch.log(min_d + 1e-30),
                             neg)
        idx = torch.topk(logits + _gumbel(n, gen, dev), b).indices
        centroids[j * b:(j + 1) * b] = data[idx].float()
    centroids = centroids[:n_clusters].contiguous()

    total_w = w.sum()
    mean_w = total_w / n_clusters
    for it in range(iters):
        c_sq = dist_ops.sqnorms(centroids)
        cents = centroids.to(sdt)
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        counts = torch.zeros(n_clusters, dtype=torch.float32, device=dev)
        for i in range(0, n, chunk):
            x = data[i:i + chunk]
            labels = torch.argmax(_chunk_scores(x, cents, c_sq, sdt), dim=1)
            # one-hot in the scoring dtype (0/1 weights are exact in bf16)
            onehot = torch.nn.functional.one_hot(labels, n_clusters).to(sdt) \
                * w[i:i + chunk].to(sdt)[:, None]
            sums += dist_ops.pairwise_inner_product(onehot.T, x.T)
            counts += onehot.float().sum(dim=0)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        new = torch.where((counts <= 0)[:, None], centroids, new)
        big = torch.argsort(-counts, stable=True)
        small = torch.argsort(counts, stable=True)
        split_ok = ((counts[big] > 1.5 * mean_w)
                    & (counts[small] <= split_small_frac * mean_w)
                    & (it + 1 < iters))
        s = torch.sign(torch.randn((n_clusters, d), generator=gen, device=dev))
        cand = new[big] * (1.0 + 1e-3 * s)
        new[small] = torch.where(split_ok[:, None], cand, new[small])
        centroids = new
    return centroids, assign_clusters(data, centroids, chunk=chunk)
