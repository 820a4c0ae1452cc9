"""K-means for the IVF coarse quantizer and the PQ codebooks.

The counterpart of the JAX package's `ops/kmeans.py`: assignment is a
chunked (rows x centroids) score product + argmax or top-t, the centroid
update is a one-hot segment sum written as a product, the init is blocked
k-means++ with Gumbel top-B draws, and clusters are split biggest-with-
smallest. These are plain large products outside any kernel, so they go to
`torch.matmul` (fp32 operands, TF32 off: see ops/distance.py).

Scoring precision follows storage precision for the data: bf16 data is
scored on its bf16 values (upcast exactly to fp32 operands, fp32
accumulation). Centroids are scored as the fp32 values they are, with the
fp32 norms of those values; the update sums stay fp32.

Deliberate difference (a fault of the JAX package, ROADMAP §3): the JAX
package rounds the centroids to bf16 for the product of a bf16 corpus but
subtracts the fp32 centroids' norms, a bias of ~0.5 a centroid at D = 768
that decides which centroid a row takes where the centroids of one dense
cluster are near-equidistant, and a split's 1e-3 perturbation rounds away.
Lists then run from empty to the balance cap, and the cap spills rows into
other clusters' lists: on the CLI's 2M x 768 bf16 corpus IVF-Flat needed
1,764 of 2,000 lists for recall 0.95, and CAGRA, whose bootstrap is bf16,
did not reach it.

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
    cast per chunk to the scoring dtype) against fp32 centroids."""
    return dist_ops.scores_from_tile(x.to(sdt), cents_s, c_sq,
                                     "sqeuclidean")


def assign_topk_clusters(data: torch.Tensor, centroids: torch.Tensor,
                         t: int = 4, chunk: int = _CHUNK):
    """(N, D), (C, D) -> ((N, t) int32 nearest centroids, best first;
    (N,) fp32 margin between the best and the runner-up score)."""
    n = data.shape[0]
    sdt = _score_dtype(data)
    c_sq = dist_ops.sqnorms(centroids)
    cents = centroids.float()
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
    return assign_clusters_batched(data[None], centroids[None], chunk)[0]


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


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def assign_clusters_batched(data: torch.Tensor, centroids: torch.Tensor,
                            chunk: int = _CHUNK) -> torch.Tensor:
    """(m, N, D), (m, C, D) -> (m, N) int32: `assign_clusters` for m
    independent problems at once (the PQ subspaces), one batched product
    per row chunk."""
    m, n, _ = data.shape
    dist_ops._check_fp32_matmul(data)
    sdt = _score_dtype(data)
    c_sq = (centroids.float() ** 2).sum(dim=2)
    cents_t = centroids.float().transpose(1, 2)
    chunk = _batched_chunk(m, centroids.shape[1], chunk)
    labels = torch.empty((m, n), dtype=torch.int32, device=data.device)
    for i in range(0, n, chunk):
        x = data[:, i:i + chunk].to(sdt).float()
        scores = 2.0 * torch.bmm(x, cents_t) - c_sq[:, None, :]
        labels[:, i:i + chunk] = torch.argmax(scores, dim=2).to(torch.int32)
    return labels


def _batched_chunk(m: int, n_clusters: int, chunk: int) -> int:
    """Rows per chunk so that the (m, chunk, C) score and one-hot tiles stay
    near 2^27 elements however many problems run side by side."""
    return max(256, min(chunk, (1 << 27) // max(1, m * n_clusters)))


def kmeans_batched(data: torch.Tensor, row_weights, gen: torch.Generator, *,
                   n_clusters: int, iters: int = 10, chunk: int = _CHUNK,
                   split_small_frac: float = 0.5):
    """Lloyd's k-means on m independent problems at once: data (m, N, D) ->
    (centroids (m, C, D) fp32, labels (m, N) int32). The counterpart of the
    JAX package's `vmap` over `kmeans_nojit`: PQ trains one small k-means
    per subspace, and m Python-level loops of tiny launches would cost more
    than the arithmetic. `row_weights` (N,) is shared by the problems.

    Init: blocked k-means++ (Gumbel top-B D^2 sampling, B <= 32, drawn from
    `gen`; zero-weight rows never picked). Each iteration reassigns,
    re-centres by the one-hot segment sum, and then pairs the rank-j
    smallest cluster with the rank-j largest: while the large one holds
    > 1.5x the mean mass and the small one <= split_small_frac x the mean,
    the small centroid is reseeded as a perturbed copy of the large one
    (never on the last iteration). split_small_frac = 0 only recycles empty
    clusters (PQ codebooks, where unequal sizes are legitimate).
    """
    m, n, d = data.shape
    dev = data.device
    dist_ops._check_fp32_matmul(data)
    sdt = _score_dtype(data)
    data = data.to(sdt)
    w = torch.ones(n, dtype=torch.float32, device=dev) if row_weights is None \
        else row_weights.float()

    def rows_at(idx):  # (m, b) row numbers -> (m, b, D) fp32 rows
        return torch.gather(data, 1, idx[..., None].expand(-1, -1, d)).float()

    # --- init: blocked k-means++ ------------------------------------------
    b = int(max(1, min(32, -(-n_clusters // 32), n)))
    nb = -(-n_clusters // b)
    x_sq = torch.stack([dist_ops.sqnorms(x) for x in data])
    centroids = torch.zeros((m, nb * b, d), dtype=torch.float32, device=dev)
    neg = torch.full((n,), -math.inf, device=dev)
    idx = torch.topk(torch.where(w > 0, 0.0, neg) + _gumbel((m, n), gen, dev),
                     b, dim=1).indices
    centroids[:, :b] = rows_at(idx)
    min_d = torch.full((m, n), math.inf, device=dev)
    for j in range(1, nb):
        prev = centroids[:, (j - 1) * b:j * b]
        d2 = (x_sq[:, :, None]
              - 2.0 * _bmm_rows(data, prev.transpose(1, 2))
              + (prev * prev).sum(dim=2)[:, None, :])
        min_d = torch.minimum(min_d, d2.min(dim=2).values)
        logits = torch.where((w > 0) & (min_d > 0), torch.log(min_d + 1e-30),
                             neg)
        idx = torch.topk(logits + _gumbel((m, n), gen, dev), b, dim=1).indices
        centroids[:, j * b:(j + 1) * b] = rows_at(idx)
    centroids = centroids[:, :n_clusters].contiguous()

    mean_w = w.sum() / n_clusters
    step = _batched_chunk(m, n_clusters, chunk)
    code_iota = torch.arange(n_clusters, device=dev)
    for it in range(iters):
        c_sq = (centroids * centroids).sum(dim=2)
        cents_t = centroids.transpose(1, 2)
        sums = torch.zeros((m, n_clusters, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((m, n_clusters), dtype=torch.float32, device=dev)
        for i in range(0, n, step):
            x = data[:, i:i + step].float()
            labels = torch.argmax(2.0 * torch.bmm(x, cents_t)
                                  - c_sq[:, None, :], dim=2)
            # one-hot in the scoring dtype (0/1 weights are exact in bf16)
            onehot = ((labels[..., None] == code_iota).to(sdt)
                      * w[i:i + step].to(sdt)[None, :, None]).float()
            sums += torch.bmm(onehot.transpose(1, 2), x)
            counts += onehot.sum(dim=1)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        new = torch.where((counts <= 0)[..., None], centroids, new)
        big = torch.argsort(-counts, dim=1, stable=True)
        small = torch.argsort(counts, dim=1, stable=True)
        split_ok = ((counts.gather(1, big) > 1.5 * mean_w)
                    & (counts.gather(1, small) <= split_small_frac * mean_w)
                    & (it + 1 < iters))
        s = torch.sign(torch.randn((m, n_clusters, d), generator=gen,
                                   device=dev))
        big_rows = new.gather(1, big[..., None].expand(-1, -1, d))
        small_ix = small[..., None].expand(-1, -1, d)
        new.scatter_(1, small_ix, torch.where(
            split_ok[..., None], big_rows * (1.0 + 1e-3 * s),
            new.gather(1, small_ix)))
        centroids = new
    return centroids, assign_clusters_batched(data, centroids, chunk=chunk)


def _bmm_rows(data: torch.Tensor, rhs_t: torch.Tensor,
              rows: int = 1 << 18) -> torch.Tensor:
    """(m, N, D) storage rows x (m, D, B) fp32 -> (m, N, B), upcasting the
    rows a chunk at a time (no whole fp32 copy of a bf16 sample)."""
    return torch.cat([torch.bmm(data[:, i:i + rows].float(), rhs_t)
                      for i in range(0, data.shape[1], rows)], dim=1)


def kmeans(data: torch.Tensor, row_weights, gen: torch.Generator, *,
           n_clusters: int, iters: int = 10, chunk: int = _CHUNK,
           split_small_frac: float = 0.5):
    """Lloyd's k-means on one problem: `kmeans_batched` with m = 1. Returns
    (centroids (C, D) fp32, labels (N,) int32)."""
    centroids, labels = kmeans_batched(
        data[None], row_weights, gen, n_clusters=n_clusters, iters=iters,
        chunk=chunk, split_small_frac=split_small_frac)
    return centroids[0], labels[0]
