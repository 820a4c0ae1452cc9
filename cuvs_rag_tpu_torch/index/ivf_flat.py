"""IVF-Flat index — k-means coarse quantizer + exact scan of probed lists.

The PyTorch counterpart of the JAX package's `index/ivf_flat.py` (cuVS
`ivf_flat.build/search`). Build: k-means on a sample (ops/kmeans.py),
capacity-balanced assignment of every row, and the aligned sorted-CSR
layout (ops/ivf.py). Search: coarse top-P probe, then the probed-window
scan kernels of ops/ivf_kernels.py — K4 for k <= 32, the certified K5 for
larger k where the card's `large_k_config` admits it (a failed certificate
re-runs `scan_probed_lists` and counts `ivf_flat.certificate_reruns`), and
`scan_probed_lists` for anything else. On a CPU tensor the kernels' plain
versions run. `n_lists` defaults to the reference's N/1000.

Storage is fp32, bf16 or int8 residual SQ8 (codes quantize x - c_label, the
row's scale and the reconstruction's sqnorm ride beside it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
from cuvs_rag_tpu_torch.ops import ivf_kernels
from cuvs_rag_tpu_torch.ops import kmeans as kmeans_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import (
    IVFFlatParams, IVFFlatSearchParams, Metric)
from cuvs_rag_tpu_torch.utils.metrics import default_registry


@base.register_index
@dataclasses.dataclass(frozen=True)
class IVFFlatIndex:
    vectors: torch.Tensor  # (cap, D) rows sorted by list, storage dtype
    sqnorms: torch.Tensor  # (cap,) fp32 sqnorms of the stored reconstruction
    scales: torch.Tensor  # (cap,) fp32 per-row dequant scales (1.0 floats)
    row_ids: torch.Tensor  # (cap,) int32 original corpus ids, -1 on pads
    centroids: torch.Tensor  # (C, D) fp32
    centroid_sqnorms: torch.Tensor  # (C,)
    list_offsets: torch.Tensor  # (C,) int32
    list_counts: torch.Tensor  # (C,) int32
    n_valid: int
    metric: str
    max_list_size: int

    @property
    def dim(self) -> int:
        return self.vectors.shape[-1]

    @property
    def n_lists(self) -> int:
        return self.centroids.shape[-2]

    @property
    def size(self) -> int:
        return self.vectors.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def default_n_lists(n: int) -> int:
    """Reference heuristic: n_lists ≈ N/1000."""
    return max(1, min(n, n // 1000 or 1))


def _prep(params: IVFFlatParams, dataset, device) -> torch.Tensor:
    vectors = base.as_tensor(dataset, device)
    if params.metric == Metric.COSINE:
        vectors = dist_ops.l2_normalize(vectors)
    dtype = base.storage_dtype(params.dtype, vectors.dtype)
    # int8: SQ8 is applied at layout time; k-means and the assignment cast
    # per chunk, so no whole-corpus fp32 copy is made
    return vectors if dtype == torch.int8 else vectors.to(dtype)


def _train_dtype(vectors: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if vectors.dtype == torch.bfloat16 else torch.float32


def _quantize_residuals(vectors, labels, centroids, chunk: int = 131_072):
    """Residual SQ8: (codes int8, scales fp32, reconstruction sqnorms fp32)
    of x - c_label, where the reconstruction is x̂ = c_label + scale * codes.
    Chunked over rows, so the fp32 temporaries stay one chunk long."""
    n, d = vectors.shape
    dev = vectors.device
    codes = torch.empty((n, d), dtype=torch.int8, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    sq = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        x = vectors[i:i + chunk].float()
        cents = centroids.float()[labels[i:i + chunk].long()]
        c, s = dist_ops.quantize_rows(x - cents)
        codes[i:i + chunk] = c
        scales[i:i + chunk] = s
        sq[i:i + chunk] = dist_ops.sqnorms(cents + s[:, None] * c.float())
    return codes, scales, sq


def _float_layout(vectors, labels, valid, centroids, n, metric, *,
                  capacity, max_list, headroom=0):
    """The sorted-CSR index of resident float storage rows `vectors`."""
    layout = ivf_ops.build_layout(
        vectors, labels, valid, n_lists=centroids.shape[0],
        capacity=capacity, max_list_size=max_list, headroom=headroom)
    return IVFFlatIndex(
        vectors=layout.sorted_vectors, sqnorms=layout.sorted_sqnorms,
        scales=layout.sorted_scales, row_ids=layout.sorted_row_ids,
        centroids=centroids, centroid_sqnorms=dist_ops.sqnorms(centroids),
        list_offsets=layout.list_offsets, list_counts=layout.list_counts,
        n_valid=n, metric=metric, max_list_size=max_list,
    )


def _row_chunks(vectors, chunk: int = 131_072):
    """(row slice, rows) of resident `vectors`, one chunk at a time."""
    for i in range(0, vectors.shape[0], chunk):
        yield slice(i, i + chunk), vectors[i:i + chunk]


def _scatter_layout(chunks, labels, valid, centroids, n, metric, dtype, *,
                    capacity, max_list, headroom=0):
    """The sorted-CSR index of rows that arrive as (row slice, rows)
    `chunks`, each stored in `dtype` (int8: residual SQ8) and scattered to
    its slots: only the placement (int32 arrays) sees all rows at once, so
    the peak is the final layout + one chunk beside the source."""
    perm, target_pos, row_ids, counts, offsets = ivf_ops.sort_by_list(
        labels, valid, centroids.shape[0], capacity, headroom)
    pos_of_row = torch.empty_like(target_pos)
    pos_of_row[perm] = target_pos
    dev = centroids.device
    vec_buf = torch.zeros((capacity, centroids.shape[1]), dtype=dtype,
                          device=dev)
    sq_buf = torch.zeros(capacity, dtype=torch.float32, device=dev)
    sc_buf = torch.ones(capacity, dtype=torch.float32, device=dev)
    for sl, x in chunks:
        pos = pos_of_row[sl]
        if dtype == torch.int8:
            vec_buf[pos], sc_buf[pos], sq_buf[pos] = _quantize_residuals(
                x, labels[sl], centroids)
        else:
            q = x.to(dtype)
            vec_buf[pos] = q
            sq_buf[pos] = dist_ops.sqnorms(q)
    return IVFFlatIndex(
        vectors=vec_buf, sqnorms=sq_buf, scales=sc_buf, row_ids=row_ids,
        centroids=centroids, centroid_sqnorms=dist_ops.sqnorms(centroids),
        list_offsets=offsets, list_counts=torch.clamp(counts, max=max_list),
        n_valid=n, metric=metric, max_list_size=max_list,
    )


def _layout(vectors, labels, valid, centroids, n, metric, dtype, *,
            capacity, max_list, headroom=0):
    """Float rows: one gather into the layout. int8: residual-quantized
    and scattered a chunk at a time (no whole-corpus fp32 copy)."""
    kw = dict(capacity=capacity, max_list=max_list, headroom=headroom)
    if dtype == torch.int8:
        return _scatter_layout(_row_chunks(vectors), labels, valid, centroids,
                               n, metric, dtype, **kw)
    return _float_layout(vectors, labels, valid, centroids, n, metric, **kw)


def _window_and_capacity(counts: np.ndarray, n: int):
    """(max_list_size, capacity) of a fresh layout: the window covers the
    longest list's true count, so no row is ever truncated."""
    max_list = topk_ops.round_up(max(int(counts.max()), 8), ivf_ops.ALIGN)
    return max_list, ivf_ops.capacity_for(topk_ops.round_up(n, 8),
                                          counts.shape[0], max_list)


def _kmeans_sample(sample, n_lists, params, seed):
    gen = torch.Generator(device=sample.device).manual_seed(seed)
    centroids, _ = kmeans_ops.kmeans(sample, None, gen, n_clusters=n_lists,
                                     iters=params.kmeans_iters)
    return centroids


def build(params: IVFFlatParams, dataset, seed: int = 0, *,
          device=None) -> IVFFlatIndex:
    """Build on `device` (None: a tensor's own device, the card for numpy:
    base.resolve_device). k-means trains on the first `kmeans_sample` rows with a
    generator seeded by `seed`."""
    base.validate_dataset(dataset)
    n = dataset.shape[0]
    vectors = _prep(params, dataset, device)
    sample_n = min(n, params.kmeans_sample)
    n_lists = min(params.n_lists or default_n_lists(n), sample_n)
    centroids = _kmeans_sample(vectors[:sample_n].to(_train_dtype(vectors)),
                               n_lists, params, seed)
    valid = torch.ones(n, dtype=torch.bool, device=vectors.device)
    labels, counts = ivf_ops.labels_with_counts(
        vectors, centroids, n, params.balance_factor, valid)
    max_list, capacity = _window_and_capacity(counts, n)
    return _layout(vectors, labels, valid, centroids, n, params.metric,
                   base.storage_dtype(params.dtype, vectors.dtype),
                   capacity=capacity, max_list=max_list)


@dataclasses.dataclass
class _ShardPlan:
    """Phase A of a shard's build: its prepared rows, which are live, its
    coarse quantizer, the rows' lists and the lists' (C,) counts."""

    vectors: torch.Tensor
    valid: torch.Tensor
    n_valid: int
    centroids: torch.Tensor
    labels: torch.Tensor
    counts: np.ndarray


def _plan_shard(params: IVFFlatParams, block, n_valid: int, n_lists: int,
                seed: int) -> _ShardPlan:
    """k-means on the shard's leading `kmeans_sample` live rows (pad rows
    weigh 0) from a generator seeded by `seed`, then the capacity-bounded
    assignment of its live rows, as `build` does for a whole corpus."""
    vectors = _prep(params, block, None)
    per = vectors.shape[0]
    valid = torch.arange(per, device=vectors.device) < n_valid
    sample_n = min(per, max(params.kmeans_sample, n_lists))
    gen = torch.Generator(device=vectors.device).manual_seed(seed)
    centroids, _ = kmeans_ops.kmeans(
        vectors[:sample_n].to(_train_dtype(vectors)),
        valid[:sample_n].float(), gen, n_clusters=n_lists,
        iters=params.kmeans_iters)
    labels, counts = ivf_ops.labels_with_counts(
        vectors, centroids, n_valid, params.balance_factor, valid)
    return _ShardPlan(vectors, valid, int(n_valid), centroids, labels, counts)


def _lay_out_shard(params: IVFFlatParams, plan: _ShardPlan, *, capacity,
                   max_list) -> IVFFlatIndex:
    """Phase B: the shard's sorted-CSR layout (int8: residual SQ8)."""
    return _layout(plan.vectors, plan.labels, plan.valid, plan.centroids,
                   plan.n_valid, params.metric,
                   base.storage_dtype(params.dtype, plan.vectors.dtype),
                   capacity=capacity, max_list=max_list)


def build_local(params: IVFFlatParams, block: torch.Tensor, n_valid: int,
                *, n_lists: int, max_list_size: int,
                seed: int = 0) -> IVFFlatIndex:
    """The index of one padded (per_shard, D) block whose rows past
    `n_valid` are dead, at a given probe window: rows of a list longer
    than `max_list_size` are truncated (build_sharded_local picks the
    window from every shard's counts, so none is)."""
    plan = _plan_shard(params, block, n_valid, n_lists, seed)
    return _lay_out_shard(
        params, plan, max_list=max_list_size,
        capacity=ivf_ops.capacity_for(block.shape[0], n_lists, max_list_size))


def shard_n_lists(params, sc, default) -> int:
    """Lists a shard: `params.n_lists`, else `default` of the mean shard
    size (over every process's shards), at most that mean."""
    avg_valid = max(1, sc.total // sc.mesh_shards)
    return min(params.n_lists or default(avg_valid), avg_valid)


def common_window(plans, reduce_max=None) -> Tuple[int, int]:
    """(max_list_size, capacity) shared by every shard: the window covers
    the longest list of any shard, so no row is truncated and the scan
    kernels see one window across the mesh. `reduce_max` (a corpus
    sharded across processes) takes the longest over every process."""
    gmax = max(int(p.counts.max()) for p in plans)
    if reduce_max is not None:
        gmax = reduce_max(gmax)
    max_list = topk_ops.round_up(max(gmax, 8), ivf_ops.ALIGN)
    per = plans[0].vectors.shape[0]
    return max_list, ivf_ops.capacity_for(per, plans[0].counts.shape[0],
                                          max_list)


def build_sharded_local(params: IVFFlatParams, sc, dmesh,
                        seed: int = 0) -> list:
    """The per-shard indexes of a ShardedCorpus, each on its block's
    device, in two phases: phase A trains every shard's own coarse
    quantizer (the same seed on every shard) and assigns its rows; the
    longest list of any shard then fixes one probe window and one capacity
    for all; phase B lays each shard out at them."""
    n_lists = shard_n_lists(params, sc, default_n_lists)
    plans = [_plan_shard(params, blk, int(nv), n_lists, seed)
             for blk, nv in zip(sc.data, sc.n_valid)]
    max_list, capacity = common_window(plans, sc.reduce_max)
    return [_lay_out_shard(params, p, capacity=capacity, max_list=max_list)
            for p in plans]


def build_from_chunks(params: IVFFlatParams, chunk_fn, n: int, d: int, *,
                      n_chunks: int, seed: int = 0,
                      device=None) -> IVFFlatIndex:
    """Build from a corpus that arrives as `n_chunks` chunks,
    chunk_fn(i) -> (n // n_chunks, d) float rows (numpy or tensor, loaded
    or regenerated per call): the FAISS train-on-sample / add-in-batches
    flow. k-means trains on the leading `kmeans_sample` rows in fp32, the
    assignment runs chunk by chunk, and only the storage-dtype layout (plus
    the per-row placement) is ever resident with the working chunk. Equals
    build() on the concatenation for fp32 corpora."""
    if n % n_chunks != 0:
        raise ValueError(f"n ({n}) must divide into n_chunks ({n_chunks})")
    rows = n // n_chunks
    n_lists = min(params.n_lists or default_n_lists(n), n)

    def chunk(i):
        x = base.as_tensor(chunk_fn(i), device)
        if x.shape != (rows, d):
            raise ValueError(f"chunk {i} is {tuple(x.shape)}, not {(rows, d)}")
        return dist_ops.l2_normalize(x) if params.metric == Metric.COSINE else x

    # pass 0: coarse quantizer on a sample from the leading chunks
    sample_rows = min(n, params.kmeans_sample)
    pieces, got, dtype = [], 0, None
    for i in range(n_chunks):
        if got >= sample_rows:
            break
        x = chunk(i)
        dtype = dtype or base.storage_dtype(params.dtype, x.dtype)
        take = min(rows, sample_rows - got)
        pieces.append(x[:take].float())
        got += take
    centroids = _kmeans_sample(torch.cat(pieces), n_lists, params, seed)
    del pieces

    # pass 1: capacity-bounded assignment, chunk by chunk
    t_pref = int(min(8, n_lists))
    tops, margs = zip(*(kmeans_ops.assign_topk_clusters(chunk(i), centroids,
                                                         t=t_pref)
                        for i in range(n_chunks)))
    top, margins = torch.cat(tops), torch.cat(margs)
    del tops, margs
    valid = torch.ones(n, dtype=torch.bool, device=centroids.device)
    if params.balance_factor > 0 and n_lists > 1:
        cap_per = max(8, int(-(-params.balance_factor * n // n_lists)))
        labels = kmeans_ops.balance_assignments_device(
            top, margins, valid, n_lists=n_lists, cap=cap_per)
    else:
        labels = top[:, 0].contiguous()
    del top, margins
    max_list, capacity = _window_and_capacity(
        ivf_ops.list_counts_device(labels, valid, n_lists).cpu().numpy(), n)

    # pass 2: scatter the chunks into the storage-dtype layout
    return _scatter_layout(
        ((slice(i * rows, (i + 1) * rows), chunk(i)) for i in range(n_chunks)),
        labels, valid, centroids, n, params.metric, dtype,
        capacity=capacity, max_list=max_list)


def train(params: IVFFlatParams, sample, seed: int = 0, *,
          device=None) -> IVFFlatIndex:
    """FAISS-style `train` on a sample -> an empty index; add rows with
    extend()."""
    base.validate_dataset(sample)
    n, d = sample.shape
    vectors = _prep(params, sample, device)
    n_lists = min(params.n_lists or default_n_lists(n), n)
    centroids = _kmeans_sample(vectors.to(_train_dtype(vectors)), n_lists,
                               params, seed)
    cap = 8
    dev = vectors.device
    return IVFFlatIndex(
        vectors=torch.zeros((cap, d),
                            dtype=base.storage_dtype(params.dtype,
                                                     vectors.dtype),
                            device=dev),
        sqnorms=torch.zeros(cap, dtype=torch.float32, device=dev),
        scales=torch.ones(cap, dtype=torch.float32, device=dev),
        row_ids=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        centroids=centroids, centroid_sqnorms=dist_ops.sqnorms(centroids),
        list_offsets=torch.zeros(n_lists, dtype=torch.int32, device=dev),
        list_counts=torch.zeros(n_lists, dtype=torch.int32, device=dev),
        n_valid=0, metric=params.metric, max_list_size=8,
    )


def _recover_rows(index: IVFFlatIndex, nv: int):
    """Original-order rows ((nv, D), storage precision; the fp32
    reconstruction for int8) and their (nv,) int32 labels."""
    slot_of, label_of_slot = ivf_ops.invert_layout(
        index.row_ids, index.list_offsets, nv)
    slot_of = slot_of.long()
    vecs = index.vectors[slot_of]
    labels = label_of_slot[slot_of]
    if index.vectors.dtype == torch.int8:
        vecs = (index.centroids.float()[labels.long()]
                + index.scales[slot_of][:, None] * vecs.float())
    return vecs, labels


def delete(index: IVFFlatIndex, ids) -> IVFFlatIndex:
    """Tombstone-remove rows by original id (FAISS `remove_ids` parity):
    the hit slots' row_ids become -1 and their sqnorm slots
    DELETED_PENALTY, which masks them in the kernels in every metric. Shapes
    never change; remaining ids are stable. Idempotent; unknown ids are
    ignored."""
    ids = torch.as_tensor(ids, device=index.device).reshape(-1)
    if ids.shape[0] == 0:
        return index
    hit, rids = ivf_ops.tombstone_layout(index.row_ids, ids, index.n_valid)
    sq = torch.where(hit, dist_ops.DELETED_PENALTY, index.sqnorms)
    return dataclasses.replace(index, row_ids=rids, sqnorms=sq)


def deleted_ids(index) -> np.ndarray:
    """Host-side: original ids that were tombstone-deleted (ids 0..n_valid-1
    absent from row_ids). Refuses a window-capped layout, whose gaps are
    not deletions."""
    stranded = ivf_ops.unreachable_live_rows(
        index.row_ids, index.list_offsets, index.list_counts)
    if stranded:
        raise ValueError(f"layout has {stranded} live rows beyond the probe "
                         "window; id gaps are not deletions")
    rid = index.row_ids.cpu().numpy()
    return np.setdiff1d(np.arange(index.n_valid, dtype=np.int64),
                        rid[rid >= 0])


def extend(index: IVFFlatIndex, new_vectors) -> IVFFlatIndex:
    """Append rows (FAISS `add`); the coarse quantizer is frozen. New rows
    get ids n_valid..n_valid+B-1.

    When every touched list still fits its aligned region and the window,
    the rows land in place (O(batch)): the layout tensors of `index` are
    UPDATED IN PLACE and shared with the result, so `index` must not be
    used afterwards (as the JAX package's donated buffers). Otherwise the
    layout is rebuilt with per-list headroom of about half the mean list,
    and the tombstones of deleted rows are applied again."""
    if new_vectors.ndim != 2 or new_vectors.shape[1] != index.dim:
        raise ValueError(f"new vectors must be (B, {index.dim}), got "
                         f"{tuple(new_vectors.shape)}")
    add = base.as_tensor(new_vectors, index.device)
    if index.metric == Metric.COSINE:
        add = dist_ops.l2_normalize(add)
    is_int8 = index.vectors.dtype == torch.int8
    add = add.to(torch.float32 if is_int8 else index.vectors.dtype)
    b = add.shape[0]
    new_labels = kmeans_ops.assign_clusters(add.float(), index.centroids)
    nv = index.n_valid
    total = nv + b

    counts_h = index.list_counts.cpu().numpy().astype(np.int64)
    offsets_h = index.list_offsets.cpu().numpy().astype(np.int64)
    adds_h = np.bincount(new_labels.cpu().numpy(), minlength=index.n_lists)
    region = np.diff(np.append(offsets_h, offsets_h[-1] + index.max_list_size))
    if np.all(counts_h + adds_h <= np.minimum(region, index.max_list_size)):
        if is_int8:
            add_q, add_s, add_sq = _quantize_residuals(add, new_labels,
                                                       index.centroids)
        else:
            add_q = add
            add_s = torch.ones(b, dtype=torch.float32, device=index.device)
            add_sq = dist_ops.sqnorms(add)
        order, target, cnt_new = ivf_ops.append_targets(
            new_labels, index.list_counts, index.list_offsets)
        target = target.long()
        index.vectors[target] = add_q[order]
        index.sqnorms[target] = add_sq[order]
        index.scales[target] = add_s[order]
        index.row_ids[target] = (nv + order).to(torch.int32)
        return dataclasses.replace(
            index, list_counts=index.list_counts + cnt_new, n_valid=total)

    # overflow: full re-layout with regrown windows and per-list headroom
    old_vecs, old_labels = _recover_rows(index, nv)
    all_vecs = torch.cat([old_vecs.to(add.dtype), add])
    all_labels = torch.cat([old_labels, new_labels])
    valid = torch.ones(total, dtype=torch.bool, device=index.device)
    counts = ivf_ops.list_counts_device(all_labels, valid, index.n_lists)
    headroom = topk_ops.round_up(max(ivf_ops.ALIGN, total // (2 * index.n_lists)),
                                 ivf_ops.ALIGN)
    max_list = topk_ops.round_up(max(int(counts.max()) + headroom, 8),
                                 ivf_ops.ALIGN)
    capacity = ivf_ops.capacity_for(topk_ops.round_up(total, 8), index.n_lists,
                                    max_list, headroom=headroom)
    out = _layout(all_vecs, all_labels, valid, index.centroids, total,
                  index.metric, index.vectors.dtype, capacity=capacity,
                  max_list=max_list, headroom=headroom)
    # the re-layout recovered deleted rows with their original ids
    gone = deleted_ids(index)
    return delete(out, gone) if gone.size else out


# ---------------------------------------------------------------- search ---


def default_search_params() -> IVFFlatSearchParams:
    return IVFFlatSearchParams()


def _kernel_metric(metric: str) -> str:
    return Metric.SQEUCLIDEAN if metric == Metric.SQEUCLIDEAN \
        else Metric.INNER_PRODUCT


def probe(index: IVFFlatIndex, queries: torch.Tensor, n_probes: int,
          metric: str | None = None):
    """((Q, P) probed list ids, (Q, P) coarse_ip or None): the lists each
    query probes and, for int8 residual storage, the per-probe coarse
    inner product mult·q·c that joins the window score (x̂ = c + s·r).
    `metric` overrides the index's (the kernels' parity checks)."""
    metric = metric or index.metric
    coarse_scores, probes = ivf_ops.probe_lists(
        queries, index.centroids, index.centroid_sqnorms, n_probes, metric)
    coarse_ip = None
    if index.vectors.dtype == torch.int8:
        # probe scores are 2q·c - ||c||² (sqeuclidean) or q·c (ip)
        coarse_ip = coarse_scores + index.centroid_sqnorms[probes.long()] \
            if metric == Metric.SQEUCLIDEAN else coarse_scores
    return probes, coarse_ip


def _prep_queries(sp, index, queries):
    sp = sp or default_search_params()
    if index.metric == Metric.COSINE:
        queries = dist_ops.l2_normalize(queries)
    return queries.float(), min(sp.n_probes, index.n_lists)


def search_scores(search_params, index: IVFFlatIndex, queries: torch.Tensor,
                  k: int, *, use_kernel: bool | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Family-protocol entry: (scores larger-better, original row ids).
    K4 for k <= 32 (`use_kernel` None), else scan_probed_lists."""
    if use_kernel is None:
        use_kernel = k <= ivf_kernels.MAX_KERNEL_K
    queries, n_probes = _prep_queries(search_params, index, queries)
    probes, coarse_ip = probe(index, queries, n_probes)
    if use_kernel:
        p = probes.long()
        scores, pos = ivf_kernels.ivf_scan(
            index.vectors, index.sqnorms, index.scales, queries,
            index.list_offsets[p], index.list_counts[p], k=k,
            window=index.max_list_size, metric=_kernel_metric(index.metric),
            coarse_ip=coarse_ip)
        return scores, _ids_of(index, pos)
    return ivf_ops.scan_probed_lists(
        queries, probes, index.vectors, index.sqnorms, index.row_ids,
        index.list_offsets, index.list_counts,
        max_list_size=index.max_list_size, metric=index.metric, k=k,
        layout_scales=index.scales, coarse_ip=coarse_ip)


def _ids_of(index, pos):
    """Layout positions -> original corpus ids (-1 stays -1)."""
    ids = index.row_ids[torch.clamp(pos, min=0).long()]
    return torch.where(pos >= 0, ids, torch.full_like(ids, -1))


def search_scores_large(search_params, index: IVFFlatIndex, queries, k: int,
                        n_sub: int, r_planes: int):
    """Certified large-k probed scan (K5): (scores desc, original ids, (Q,)
    certified)."""
    queries, n_probes = _prep_queries(search_params, index, queries)
    probes, coarse_ip = probe(index, queries, n_probes)
    p = probes.long()
    scores, pos, cert = ivf_kernels.ivf_scan_large(
        index.vectors, index.sqnorms, index.scales, queries,
        index.list_offsets[p], index.list_counts[p], k=k,
        window=index.max_list_size, metric=_kernel_metric(index.metric),
        coarse_ip=coarse_ip, n_sub=n_sub, r_planes=r_planes)
    return scores, _ids_of(index, pos), cert


def _to_distances(scores, index, queries):
    qn = dist_ops.l2_normalize(queries) \
        if index.metric == Metric.COSINE else queries
    return dist_ops.scores_to_distances(scores, dist_ops.sqnorms(qn.float()),
                                        index.metric)


def search(search_params, index: IVFFlatIndex, queries, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cuVS surface: search(IVFFlatSearchParams(n_probes), index, queries,
    k) -> (distances (Q, k), ids (Q, k) int32).

    k <= 32 runs K4. 32 < k <= 8192 runs the certified K5 when the card's
    `large_k_config` admits it; a failed certificate (Poisson-rare) re-runs
    scan_probed_lists and counts `ivf_flat.certificate_reruns`, so results
    always equal the exact top-k of the probed lists. Anything else runs
    scan_probed_lists."""
    queries = base.validate_queries(base.as_tensor(queries, index.device),
                                    index.dim)
    if k <= ivf_kernels.MAX_KERNEL_K:
        scores, ids = search_scores(search_params, index, queries, k,
                                    use_kernel=True)
        return _to_distances(scores, index, queries), ids
    cfg = ivf_kernels.large_k_config(index.max_list_size, index.dim, k)
    if cfg is not None:
        scores, ids, cert = search_scores_large(search_params, index,
                                                queries, k, *cfg)
        if bool(cert.all()):
            return _to_distances(scores, index, queries), ids
        default_registry.inc("ivf_flat.certificate_reruns")
    scores, ids = search_scores(search_params, index, queries, k,
                                use_kernel=False)
    return _to_distances(scores, index, queries), ids
