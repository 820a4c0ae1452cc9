"""IVF-PQ index — coarse quantizer + residual product quantization + ADC.

The PyTorch counterpart of the JAX package's `index/ivf_pq.py` (cuVS
`ivf_pq.build/search`). Codes are pq_dim bytes a row (a 384-d bf16 corpus
compresses 16x); an optional exact re-rank ("refine") against the stored
raw rows, or against rows fetched from a host store, closes the
quantization recall gap. `n_lists` defaults to the reference's N/500 and
`pq_dim` to D/8.

Code forms: pq_bits = 8 with two_level (default) stores two 4-bit codes a
byte (c1 low, c2 high) plus a per-row cross-term correction; pq_bits = 4
with an even pq_dim packs two subspaces a byte; flat 8-bit codes
(two_level=False) and 4-bit with an odd pq_dim keep one byte per stream.
Packed codes are scanned by the K6 CUDA kernel (ops/pq_kernels.py),
unpacked ones by a torch.gather scan (ops/pq.scan_probed_lists_pq).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.index import ivf_flat as ivf_flat_mod
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
from cuvs_rag_tpu_torch.ops import kmeans as kmeans_ops
from cuvs_rag_tpu_torch.ops import pq as pq_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import (
    IVFPQParams, IVFPQSearchParams, Metric)

# Rows per encode chunk: bounds the fp32 residuals of a chunk.
_ENCODE_CHUNK = 131_072


@base.register_index
@dataclasses.dataclass(frozen=True)
class IVFPQIndex:
    codes: torch.Tensor  # (mb, cap) uint8 STREAM-MAJOR: codes[s, slot] is
    # slot's byte of stream s (rows sorted by list along the last axis). The
    # slot axis is contiguous, so a warp scoring 32 neighbouring slots reads
    # each stream coalesced; it is also the layout the saved files hold.
    row_ids: torch.Tensor  # (cap,) int32 original ids, -1 on pads
    centroids: torch.Tensor  # (C, Dp) fp32, zero-padded to a pq_dim multiple
    centroid_sqnorms: torch.Tensor  # (C,)
    codebooks: torch.Tensor  # (levels * m, n_codes, ds) fp32
    list_offsets: torch.Tensor  # (C,) int32
    list_counts: torch.Tensor  # (C,) int32
    raw_vectors: torch.Tensor  # (cap, Dp) storage for refine, or (0, Dp)
    raw_sqnorms: torch.Tensor  # (cap,) or (0,)
    norm_corr: torch.Tensor  # (cap,) fp32 two-level c1·c2 cross term, or (0,)
    rotation: torch.Tensor  # (Dp, Dp) OPQ rotation, or (0, 0) when disabled
    n_valid: int
    metric: str
    max_list_size: int
    dim: int  # original (unpadded) dim
    levels: int  # 1 = plain PQ; 2 = two-level additive nibble PQ (8-bit)

    @property
    def padded_dim(self) -> int:
        return self.centroids.shape[-1]

    @property
    def pq_dim(self) -> int:
        return self.codebooks.shape[-3] // self.levels

    @property
    def codes_packed(self) -> bool:
        """True when 4-bit codes are nibble-packed two per byte."""
        return self.codes.shape[-2] != self.codebooks.shape[-3]

    @property
    def n_lists(self) -> int:
        return self.centroids.shape[-2]

    @property
    def has_raw(self) -> bool:
        return self.raw_vectors.shape[-2] > 0

    @property
    def has_opq(self) -> bool:
        return self.rotation.shape[-1] > 0

    @property
    def device(self) -> torch.device:
        return self.codes.device


def default_n_lists(n: int) -> int:
    """Reference PQ heuristic: n_lists ≈ N/500."""
    return max(1, min(n, n // 500 or 1))


def default_pq_dim(d: int) -> int:
    """ds = 8 values per code by default (768-d -> m = 96)."""
    return max(1, d // 8)


def _pad_dim(x: torch.Tensor, m: int) -> torch.Tensor:
    """Zero-pad the feature axis so D % m == 0 (zeros never change scores)."""
    d = x.shape[-1]
    dp = topk_ops.round_up(d, m)
    return x if dp == d else torch.nn.functional.pad(x, (0, dp - d))


def _prep(x, metric: str, m: int, device) -> torch.Tensor:
    """Rows on the device in their own dtype (no whole-corpus fp32 copy),
    normalized for cosine, feature-padded."""
    x = base.as_tensor(x, device)
    if metric == Metric.COSINE:
        x = dist_ops.l2_normalize(x)
    return _pad_dim(x, m)


def _levels(params: IVFPQParams) -> int:
    return 2 if (params.pq_bits == 8 and params.two_level) else 1


def _packs(levels: int, n_codes: int, m: int) -> bool:
    return levels == 2 or (n_codes <= 16 and m % 2 == 0)


def _train_coarse(sample, raw_dtype, n_lists, params, gen, weights=None):
    """Coarse k-means on the fp32 sample (rows weighed by 0/1 `weights`),
    scored in the storage dtype (the same rule as ivf_flat)."""
    coarse = sample.to(torch.bfloat16) if raw_dtype == torch.bfloat16 \
        else sample
    centroids, _ = kmeans_ops.kmeans(coarse, weights, gen,
                                     n_clusters=n_lists,
                                     iters=params.kmeans_iters)
    return centroids


def _train_pq_quantizers(params, sample, centroids, gen, *, m, n_codes,
                         weights=None):
    """Residual PQ codebooks (+ optional OPQ rotation) on the leading
    `pq_train_sample` rows of the fp32 `sample` (weighed by 0/1 `weights`):
    (rotation, codebooks, levels). Codebooks train in fp32 whatever the
    storage: their entries ARE the reconstruction values."""
    levels = _levels(params)
    pq_n = min(sample.shape[0], params.pq_train_sample)
    pq_sample = sample[:pq_n]
    w = None if weights is None else weights[:pq_n]
    res = pq_sample - centroids[
        kmeans_ops.assign_clusters(pq_sample, centroids).long()]
    if params.opq:
        rotation = pq_ops.train_opq_rotation(
            res, w, gen, m=m, n_codes=n_codes, iters=params.opq_iters)
        res = res @ rotation.T
    else:
        rotation = torch.zeros((0, 0), dtype=torch.float32,
                               device=sample.device)
    if levels == 2:
        codebooks = pq_ops.train_two_level_codebooks(
            res, w, gen, m=m, iters=params.pq_kmeans_iters)
    else:
        codebooks = pq_ops.train_codebooks(
            res, w, gen, m=m, n_codes=n_codes,
            iters=params.pq_kmeans_iters)
    return rotation, codebooks, levels


def _encode_rows(x, labels, centroids, codebooks, rotation, levels):
    """Encode a batch with frozen quantizers -> ((B, code bytes) codes in
    their stored form, (B,) cross-term correction or (0,))."""
    r = x.float() - centroids[labels.long()]
    if rotation is not None:
        dist_ops._check_fp32_matmul(r)
        r = r @ rotation.T
    if levels == 2:
        codes2 = pq_ops.encode_two_level(r, codebooks)
        return (pq_ops.pack_nibbles(codes2),
                pq_ops.norm_correction(codes2, codebooks))
    codes = pq_ops.encode(r, codebooks)
    m, n_codes = codebooks.shape[0], codebooks.shape[1]
    if _packs(levels, n_codes, m):
        codes = pq_ops.pack_nibbles(codes)
    return codes, torch.zeros(0, dtype=torch.float32, device=x.device)


def _encode_chunked(vectors, labels, centroids, codebooks, rotation,
                    levels: int, chunk: int = _ENCODE_CHUNK):
    """_encode_rows over all rows, a chunk at a time: the fp32 residuals
    and the (m, rows, 256) joint-encode cost exist only per chunk."""
    codes, corr = zip(*(
        _encode_rows(vectors[i:i + chunk], labels[i:i + chunk], centroids,
                     codebooks, rotation, levels)
        for i in range(0, vectors.shape[0], chunk)))
    return torch.cat(codes), torch.cat(corr)


def _pq_layout(codes, vectors, labels, valid, norm_corr, *, n_lists,
               capacity, max_list_size, store_raw, headroom=0):
    """Sorted-CSR layout of PQ codes (+ optional raw rows): (sorted codes
    (code bytes, cap), row_ids, offsets, counts, raw, raw_sqnorms, sorted
    corr). The row move is one gather; `headroom` > 0 reserves per-list
    growth slack (extend's re-layout)."""
    _, _, row_ids, counts, offsets = ivf_ops.sort_by_list(
        labels, valid, n_lists, capacity, headroom)
    dev = codes.device
    slot_ok = row_ids >= 0
    src = torch.clamp(row_ids, min=0).long()
    sorted_codes = codes[src]
    sorted_codes[~slot_ok] = 0
    sorted_codes = sorted_codes.T.contiguous()  # -> stream-major
    if store_raw:
        raw = vectors[src]
        raw[~slot_ok] = 0
        raw_sq = dist_ops.sqnorms(raw)
    else:
        raw = torch.zeros((0, vectors.shape[1]), dtype=vectors.dtype,
                          device=dev)
        raw_sq = torch.zeros(0, dtype=torch.float32, device=dev)
    if norm_corr.shape[0] > 0:
        sorted_corr = torch.where(slot_ok, norm_corr[src], 0.0)
    else:
        sorted_corr = torch.zeros(0, dtype=torch.float32, device=dev)
    return (sorted_codes, row_ids, offsets,
            torch.clamp(counts, max=max_list_size), raw, raw_sq, sorted_corr)


def _window_and_capacity(counts: np.ndarray, n: int):
    max_list = topk_ops.round_up(max(int(counts.max()), 8), ivf_ops.ALIGN)
    return max_list, ivf_ops.capacity_for(topk_ops.round_up(n, 8),
                                          counts.shape[0], max_list)


def build(params: IVFPQParams, dataset, seed: int = 0, *,
          device=None) -> IVFPQIndex:
    """Build on `device` (None: a tensor's own device, the card for numpy:
    base.resolve_device). The coarse k-means trains on the first
    `kmeans_sample` rows and the codebooks on the first `pq_train_sample`,
    both from one generator seeded by `seed`."""
    base.validate_dataset(dataset)
    n, d = dataset.shape
    m = params.pq_dim or default_pq_dim(d)
    n_codes = 2 ** params.pq_bits
    vectors = _prep(dataset, params.metric, m, device)
    gen = torch.Generator(device=vectors.device).manual_seed(seed)

    sample_n = min(n, params.kmeans_sample)
    n_lists = min(params.n_lists or default_n_lists(n), sample_n)
    sample = vectors[:sample_n].float()
    centroids = _train_coarse(sample, vectors.dtype, n_lists, params, gen)
    rotation, codebooks, levels = _train_pq_quantizers(
        params, sample, centroids, gen, m=m, n_codes=n_codes)
    del sample

    valid = torch.ones(n, dtype=torch.bool, device=vectors.device)
    labels, counts = ivf_ops.labels_with_counts(
        vectors, centroids, n, params.balance_factor, valid)
    codes, norm_corr = _encode_chunked(
        vectors, labels, centroids, codebooks,
        rotation if params.opq else None, levels)
    max_list, capacity = _window_and_capacity(counts, n)
    sorted_codes, row_ids, offsets, counts_t, raw, raw_sq, sorted_corr = \
        _pq_layout(codes, vectors, labels, valid, norm_corr, n_lists=n_lists,
                   capacity=capacity, max_list_size=max_list,
                   store_raw=params.store_raw)
    return IVFPQIndex(
        codes=sorted_codes, row_ids=row_ids, centroids=centroids,
        centroid_sqnorms=dist_ops.sqnorms(centroids), codebooks=codebooks,
        list_offsets=offsets, list_counts=counts_t, raw_vectors=raw,
        raw_sqnorms=raw_sq, norm_corr=sorted_corr, rotation=rotation,
        n_valid=n, metric=params.metric, max_list_size=max_list, dim=d,
        levels=levels,
    )


def _plan_shard(params: IVFPQParams, block, n_valid: int, n_lists: int,
                m: int, seed: int):
    """Phase A of a shard's build (ivf_flat._ShardPlan, plus the fp32
    training sample, its weights and the shard's generator, which phase B
    continues): coarse k-means on the shard's leading `kmeans_sample` rows
    (pad rows weigh 0), then the capacity-bounded assignment."""
    vectors = _prep(block, params.metric, m, None)
    per = vectors.shape[0]
    valid = torch.arange(per, device=vectors.device) < n_valid
    sample_n = min(per, max(params.kmeans_sample, n_lists))
    sample = vectors[:sample_n].float()
    weights = valid[:sample_n].float()
    gen = torch.Generator(device=vectors.device).manual_seed(seed)
    centroids = _train_coarse(sample, vectors.dtype, n_lists, params, gen,
                              weights)
    labels, counts = ivf_ops.labels_with_counts(
        vectors, centroids, n_valid, params.balance_factor, valid)
    plan = ivf_flat_mod._ShardPlan(vectors, valid, int(n_valid), centroids,
                                   labels, counts)
    return plan, sample, weights, gen


def build_sharded_local(params: IVFPQParams, sc, dmesh,
                        seed: int = 0) -> list:
    """The per-shard indexes of a ShardedCorpus, in ivf_flat's two phases:
    phase A trains every shard's coarse quantizer (one seed) and assigns
    its rows; one probe window and capacity then cover every shard's
    longest list; phase B trains each shard's residual codebooks (and OPQ
    rotation), encodes its rows and lays them out."""
    d = sc.dim
    m = params.pq_dim or default_pq_dim(d)
    n_codes = 2 ** params.pq_bits
    n_lists = ivf_flat_mod.shard_n_lists(params, sc, default_n_lists)
    shards = [_plan_shard(params, blk, int(nv), n_lists, m, seed)
              for blk, nv in zip(sc.data, sc.n_valid)]
    max_list, capacity = ivf_flat_mod.common_window(
        [p for p, *_ in shards], sc.reduce_max)
    out = []
    for plan, sample, weights, gen in shards:
        rotation, codebooks, levels = _train_pq_quantizers(
            params, sample, plan.centroids, gen, m=m, n_codes=n_codes,
            weights=weights)
        codes, norm_corr = _encode_chunked(
            plan.vectors, plan.labels, plan.centroids, codebooks,
            rotation if params.opq else None, levels)
        sorted_codes, row_ids, offsets, counts, raw, raw_sq, sorted_corr = \
            _pq_layout(codes, plan.vectors, plan.labels, plan.valid,
                       norm_corr, n_lists=n_lists, capacity=capacity,
                       max_list_size=max_list, store_raw=params.store_raw)
        out.append(IVFPQIndex(
            codes=sorted_codes, row_ids=row_ids, centroids=plan.centroids,
            centroid_sqnorms=dist_ops.sqnorms(plan.centroids),
            codebooks=codebooks, list_offsets=offsets, list_counts=counts,
            raw_vectors=raw, raw_sqnorms=raw_sq, norm_corr=sorted_corr,
            rotation=rotation, n_valid=plan.n_valid, metric=params.metric,
            max_list_size=max_list, dim=d, levels=levels))
    return out


def build_from_chunks(params: IVFPQParams, chunk_fn, n: int, d: int, *,
                      n_chunks: int, seed: int = 0,
                      device=None) -> IVFPQIndex:
    """Memory-bounded build: the corpus arrives as `n_chunks` chunks,
    chunk_fn(i) -> (n // n_chunks, d) float rows (numpy or tensor, loaded or
    regenerated per call), and only the code layout (+ the optional raw
    store) is ever resident with the working chunk: the FAISS
    train-on-sample / add-in-batches flow at PQ compression. With
    store_raw=False the layout costs pq_dim bytes a row plus the int32 ids
    and fp32 correction, so a corpus far larger than the device builds and
    serves on one card. Gives the index build() gives on the concatenation.
    """
    if n % n_chunks != 0:
        raise ValueError(f"n ({n}) must divide into n_chunks ({n_chunks})")
    rows = n // n_chunks
    m = params.pq_dim or default_pq_dim(d)
    n_codes = 2 ** params.pq_bits

    def chunk(i):
        x = base.as_tensor(chunk_fn(i), device)
        if x.shape != (rows, d):
            raise ValueError(f"chunk {i} is {tuple(x.shape)}, not {(rows, d)}")
        return _prep(x, params.metric, m, None)

    # pass 0: coarse quantizer + PQ codebooks on a sample of leading chunks
    sample_rows = min(n, params.kmeans_sample)
    pieces, got, raw_dtype = [], 0, None
    for i in range(n_chunks):
        if got >= sample_rows:
            break
        x = chunk(i)
        raw_dtype = raw_dtype or x.dtype
        take = min(rows, sample_rows - got)
        pieces.append(x[:take].float())
        got += take
    sample = torch.cat(pieces)
    del pieces, x
    dev = sample.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_lists = min(params.n_lists or default_n_lists(n), got)
    centroids = _train_coarse(sample, raw_dtype, n_lists, params, gen)
    rotation, codebooks, levels = _train_pq_quantizers(
        params, sample, centroids, gen, m=m, n_codes=n_codes)
    del sample

    # pass 1: capacity-bounded assignment, chunk by chunk; the spill runs
    # only when some list exceeds its cap (as ivf_ops.labels_with_counts)
    t_pref = int(min(8, n_lists))
    tops, margs = zip(*(kmeans_ops.assign_topk_clusters(chunk(i), centroids,
                                                         t=t_pref)
                        for i in range(n_chunks)))
    top, margins = torch.cat(tops), torch.cat(margs)
    del tops, margs
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    labels = top[:, 0].contiguous()
    counts = ivf_ops.list_counts_device(labels, valid, n_lists).cpu().numpy()
    if params.balance_factor > 0 and n_lists > 1:
        cap_per = max(8, int(-(-params.balance_factor * n // n_lists)))
        if int(counts.max()) > cap_per:
            labels = kmeans_ops.balance_assignments_device(
                top, margins, valid, n_lists=n_lists, cap=cap_per)
            counts = ivf_ops.list_counts_device(
                labels, valid, n_lists).cpu().numpy()
    del top, margins
    max_list, capacity = _window_and_capacity(counts, n)
    perm, target_pos, row_ids, counts_t, offsets = ivf_ops.sort_by_list(
        labels, valid, n_lists, capacity)
    pos_of_row = torch.empty_like(target_pos)
    pos_of_row[perm] = target_pos
    del perm, target_pos

    # pass 2: encode + scatter the chunks into the code layout
    dp = topk_ops.round_up(d, m)
    code_cols = m // 2 if (levels == 1 and _packs(levels, n_codes, m)) else m
    code_buf = torch.zeros((code_cols, capacity), dtype=torch.uint8,
                           device=dev)
    corr_buf = torch.zeros(capacity if levels == 2 else 0,
                           dtype=torch.float32, device=dev)
    raw_rows = capacity if params.store_raw else 0
    raw_buf = torch.zeros((raw_rows, dp), dtype=raw_dtype, device=dev)
    raw_sq_buf = torch.zeros(raw_rows, dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * rows, (i + 1) * rows)
        x = chunk(i)
        codes, corr = _encode_chunked(
            x, labels[sl], centroids, codebooks,
            rotation if params.opq else None, levels)
        pos = pos_of_row[sl]
        code_buf[:, pos] = codes.T
        if levels == 2:
            corr_buf[pos] = corr
        if params.store_raw:
            raw_buf[pos] = x
            raw_sq_buf[pos] = dist_ops.sqnorms(x)
    return IVFPQIndex(
        codes=code_buf, row_ids=row_ids, centroids=centroids,
        centroid_sqnorms=dist_ops.sqnorms(centroids), codebooks=codebooks,
        list_offsets=offsets, list_counts=torch.clamp(counts_t, max=max_list),
        raw_vectors=raw_buf, raw_sqnorms=raw_sq_buf, norm_corr=corr_buf,
        rotation=rotation, n_valid=n, metric=params.metric,
        max_list_size=max_list, dim=d, levels=levels,
    )


def delete(index: IVFPQIndex, ids) -> IVFPQIndex:
    """Tombstone-remove rows by original id (FAISS IVFPQ `remove_ids`
    parity). One tombstone suffices for PQ: row_ids -> -1 masks the ADC scan
    (dead slots are dropped before selection), which also keeps deleted rows
    out of the refine pool. Shapes never change; remaining ids are stable.
    Idempotent; unknown ids are ignored."""
    ids = torch.as_tensor(ids, device=index.device).reshape(-1)
    if ids.shape[0] == 0:
        return index
    _, rids = ivf_ops.tombstone_layout(index.row_ids, ids, index.n_valid)
    return dataclasses.replace(index, row_ids=rids)


def deleted_ids(index: IVFPQIndex) -> np.ndarray:
    """Host-side: original ids that were tombstone-deleted. Refuses a
    window-capped layout, whose gaps are not deletions. On a filtered VIEW
    this reports the excluded rows too: call it on the base index."""
    return ivf_flat_mod.deleted_ids(index)


def extend(index: IVFPQIndex, new_vectors) -> IVFPQIndex:
    """Append rows with frozen quantizers (FAISS IVFPQ `add`): the coarse
    centroids, the codebooks and the OPQ rotation are train-once. New rows
    get ids n_valid..n_valid+B-1.

    When every touched list still fits its aligned region and the window,
    the rows land in place (O(batch)): the layout tensors of `index` are
    UPDATED IN PLACE and shared with the result, so `index` must not be
    used afterwards (the same contract as ivf_flat.extend). Otherwise the
    layout is rebuilt with per-list headroom of about half the mean list,
    and the tombstones of deleted rows are applied again."""
    if new_vectors.ndim != 2 or new_vectors.shape[1] != index.dim:
        raise ValueError(f"new vectors must be (B, {index.dim}), got "
                         f"{tuple(new_vectors.shape)}")
    add = _prep(new_vectors, index.metric, index.pq_dim, index.device)
    b = add.shape[0]
    nv = index.n_valid
    total = nv + b
    labels = kmeans_ops.assign_clusters(add.float(), index.centroids)
    codes_new, corr_new = _encode_rows(
        add, labels, index.centroids, index.codebooks,
        index.rotation if index.has_opq else None, index.levels)

    counts_h = index.list_counts.cpu().numpy().astype(np.int64)
    offsets_h = index.list_offsets.cpu().numpy().astype(np.int64)
    adds_h = np.bincount(labels.cpu().numpy(), minlength=index.n_lists)
    region = np.diff(np.append(offsets_h, offsets_h[-1] + index.max_list_size))
    if np.all(counts_h + adds_h <= np.minimum(region, index.max_list_size)):
        order, target, cnt_new = ivf_ops.append_targets(
            labels, index.list_counts, index.list_offsets)
        target = target.long()
        index.codes[:, target] = codes_new[order].T
        index.row_ids[target] = (nv + order).to(torch.int32)
        if index.levels == 2:
            index.norm_corr[target] = corr_new[order]
        if index.has_raw:
            raw_add = add[order].to(index.raw_vectors.dtype)
            index.raw_vectors[target] = raw_add
            index.raw_sqnorms[target] = dist_ops.sqnorms(raw_add)
        return dataclasses.replace(
            index, list_counts=index.list_counts + cnt_new, n_valid=total)

    # overflow: recover everything in original order and re-lay out with
    # growth headroom (the same amortization policy as ivf_flat.extend)
    gone = deleted_ids(index)
    slot_of, label_of_slot = ivf_ops.invert_layout(
        index.row_ids, index.list_offsets, nv)
    slot_of = slot_of.long()
    all_codes = torch.cat([index.codes.T[slot_of], codes_new])
    all_labels = torch.cat([label_of_slot[slot_of], labels])
    all_corr = torch.cat([index.norm_corr[slot_of], corr_new]) \
        if index.levels == 2 else corr_new
    # without a raw store the layout takes a (0, Dp) placeholder: a full
    # zeros buffer would cost what store_raw=False exists to save
    all_raw = torch.cat([index.raw_vectors[slot_of],
                         add.to(index.raw_vectors.dtype)]) \
        if index.has_raw else index.raw_vectors
    valid = torch.ones(total, dtype=torch.bool, device=index.device)
    headroom = topk_ops.round_up(
        max(ivf_ops.ALIGN, total // (2 * index.n_lists)), ivf_ops.ALIGN)
    max_list = topk_ops.round_up(int((counts_h + adds_h).max()) + headroom,
                                 ivf_ops.ALIGN)
    capacity = ivf_ops.capacity_for(topk_ops.round_up(total, 8),
                                    index.n_lists, max_list,
                                    headroom=headroom)
    sorted_codes, row_ids, offsets, counts_t, raw, raw_sq, sorted_corr = \
        _pq_layout(all_codes, all_raw, all_labels, valid, all_corr,
                   n_lists=index.n_lists, capacity=capacity,
                   max_list_size=max_list, store_raw=index.has_raw,
                   headroom=headroom)
    out = dataclasses.replace(
        index, codes=sorted_codes, row_ids=row_ids, norm_corr=sorted_corr,
        raw_vectors=raw, raw_sqnorms=raw_sq, list_offsets=offsets,
        list_counts=counts_t, n_valid=total, max_list_size=max_list)
    # the re-layout recovered deleted rows with their original ids
    return delete(out, gone) if gone.size else out


def strip_raw(index: IVFPQIndex) -> IVFPQIndex:
    """Drop the raw-vector store (refine off, full PQ memory savings)."""
    return dataclasses.replace(
        index,
        raw_vectors=index.raw_vectors.new_zeros((0, index.padded_dim)),
        raw_sqnorms=index.raw_sqnorms.new_zeros(0))


# ---------------------------------------------------------------- search ---


def default_search_params() -> IVFPQSearchParams:
    return IVFPQSearchParams()


def _refine_pool(k: int, refine_ratio: int) -> int:
    """ADC candidate-pool size of a refine pass. The k + 1024 cap bounds the
    ADC top-k and the re-rank while letting deep refine (ratio 64-100)
    widen the pool."""
    return min(k * refine_ratio, k + 1024)


def _prep_queries(index: IVFPQIndex, queries: torch.Tensor) -> torch.Tensor:
    if index.metric == Metric.COSINE:
        queries = dist_ops.l2_normalize(queries)
    return _pad_dim(queries.float(), index.pq_dim)


def search_scores(search_params: Optional[IVFPQSearchParams],
                  index: IVFPQIndex, queries: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Family-protocol entry: (scores larger-better, original row ids)."""
    sp = search_params or default_search_params()
    queries = _prep_queries(index, queries)
    n_probes = min(sp.n_probes, index.n_lists)
    coarse_scores, probes = ivf_ops.probe_lists(
        queries, index.centroids, index.centroid_sqnorms, n_probes,
        index.metric)

    do_refine = sp.refine_ratio > 0 and index.has_raw
    k_adc = _refine_pool(k, sp.refine_ratio) if do_refine else k

    # The ADC pass returns sorted-layout POSITIONS as its ids, so refine
    # gathers raw rows without an id -> position map; positions become row
    # ids at the end.
    scores, positions = pq_ops.scan_probed_lists_pq(
        queries, probes, index.centroids, coarse_scores, index.codebooks,
        index.codes, index.row_ids, index.list_offsets, index.list_counts,
        max_list_size=index.max_list_size, metric=index.metric, k=k_adc,
        rotation=index.rotation if index.has_opq else None,
        sorted_norm_corr=index.norm_corr if index.levels == 2 else None,
        levels=index.levels,
    )

    if do_refine:
        safe_pos = torch.clamp(positions, min=0).long()
        cand = index.raw_vectors[safe_pos].float()  # (Q, k_adc, Dp)
        dist_ops._check_fp32_matmul(cand)
        exact = torch.bmm(cand, queries[:, :, None])[:, :, 0]
        if index.metric == Metric.SQEUCLIDEAN:
            exact = 2.0 * exact - index.raw_sqnorms[safe_pos]
        exact = torch.where(positions >= 0, exact,
                            torch.full_like(exact, topk_ops.NEG_INF))
        scores, positions = topk_ops.merge_topk(exact, positions, k)

    row_ids = index.row_ids[torch.clamp(positions, min=0).long()]
    return scores, torch.where(positions >= 0, row_ids,
                               torch.full_like(row_ids, -1))


def _search_core(search_params, index, queries, k):
    scores, idx = search_scores(search_params, index, queries, k)
    return dist_ops.scores_to_distances(
        scores, dist_ops.sqnorms(_prep_queries(index, queries)),
        index.metric), idx


def search(search_params: Optional[IVFPQSearchParams], index: IVFPQIndex,
           queries, k: int, fetch_rows=None, host_rerank: bool = False):
    """cuVS surface: search(IVFPQSearchParams(n_probes, refine_ratio),
    index, queries, k) -> (distances (Q, k), ids (Q, k) int32).

    Without refine the distances are ADC approximations (as cuVS's); with
    refine they are exact for the re-ranked top-k.

    fetch_rows: optional OUT-OF-CORE refine source, a callable
    `fetch_rows(row_ids: np.ndarray) -> (len(row_ids), dim) float array`
    returning the ORIGINAL corpus rows of the given (sorted, unique,
    ascending) global ids: a host-RAM ndarray slice, an np.memmap over a
    disk file, a recompute hook. For `store_raw=False` indexes, where only
    the codes live on the device: the ADC pass selects k*refine_ratio
    candidates there, their ids cross to the host, and the exact re-rank
    runs against the callback's rows. FAISS analogue: IndexRefine over an
    on-disk / IVFPQ pair.

    host_rerank=True scores the candidates ON THE HOST (numpy) instead of
    uploading them for a device re-rank: the serving shape when the store is
    host RAM or an mmap. Returns numpy arrays in that mode."""
    queries = base.validate_queries(base.as_tensor(queries, index.device),
                                    index.dim)
    sp = search_params or default_search_params()
    if fetch_rows is not None and sp.refine_ratio > 0:
        return _search_refine_external(sp, index, queries, k, fetch_rows,
                                       host_rerank)
    return _search_core(sp, index, queries, k)


def _search_refine_external(sp, index, queries, k, fetch_rows, host_rerank):
    """ADC candidates -> host id fan-in -> callback rows -> exact re-rank
    (device upload + re-rank, or host numpy when host_rerank)."""
    from cuvs_rag_tpu_torch.index import refine as refine_mod

    k_adc = _refine_pool(k, sp.refine_ratio)
    _, ids = _search_core(dataclasses.replace(sp, refine_ratio=0), index,
                          queries, k_adc)
    if host_rerank:
        return refine_mod.rerank_host(queries, ids, k, fetch_rows,
                                      metric=index.metric)
    return refine_mod.rerank_external(queries, ids, k, fetch_rows,
                                      metric=index.metric,
                                      pad_dim_to=index.pq_dim)
