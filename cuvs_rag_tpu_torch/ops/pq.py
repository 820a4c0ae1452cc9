"""Product quantization: codebook training, encoding, ADC scan.

The counterpart of the JAX package's `ops/pq.py` (cuVS `ivf_pq`'s PQ
stages): per-subspace k-means codebooks (all m trainings run as one batched
k-means, ops/kmeans.kmeans_batched), residual encoding against the coarse
centroid (codes quantize x - c_coarse), and asymmetric-distance (ADC)
scoring through per-(query, probe) lookup tables.

Score algebra (larger-is-better scores, see ops/distance.py): with
x̂ = c_coarse + r̂ and r̂ the PQ reconstruction,
    score(q, x̂) = 2 q·x̂ - ||x̂||²
                = [2 q·c - ||c||²]  +  Σ_s [ 2(q-c)_s·r_sc - ||r_sc||² ]
                  (coarse part)         (LUT_s[c] part, per probed list)
so the LUT of a (query, probe) pair is built from the residual query
t = q - c_coarse. Inner product: score = q·x̂ = q·c + Σ_s q_s·r_sc (t = q).

Every product here is fp32 with TF32 off (ops/distance._check_fp32_matmul):
codebook entries are the reconstruction values, and the tables and the
cross term feed an exact algebra.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import kmeans as kmeans_ops
from cuvs_rag_tpu_torch.ops import pq_kernels
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import Metric

# Rows per chunk of the joint two-level encode: bounds its (m, chunk, 256)
# cost tensor.
_JOINT_CHUNK = 8192
# Elements of the gathered (queries, probes, streams, window) block per
# chunk of queries in the scan of unpacked codes: bounds its int64 index at
# 1 GiB.
_SCAN_ELEMS = 1 << 27


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (m, N, ds). Requires D % m == 0 (the index layer pads D)."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} is not a multiple of {m} subspaces")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def _bmm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, A, ds) x (m, B, ds) -> (m, A, B) fp32 inner products."""
    dist_ops._check_fp32_matmul(a)
    return torch.bmm(a.float(), b.float().transpose(1, 2))


def train_codebooks(residuals: torch.Tensor, weights, gen: torch.Generator,
                    *, m: int, n_codes: int, iters: int = 10) -> torch.Tensor:
    """(N, D) residuals -> (m, n_codes, ds) codebooks: one batched k-means
    over the m subspaces. split_small_frac = 0: only empty codewords are
    recycled (unequal codeword sizes are legitimate mass allocation)."""
    subs = split_subspaces(residuals.float(), m).contiguous()
    codebooks, _ = kmeans_ops.kmeans_batched(
        subs, weights, gen, n_clusters=n_codes, iters=iters,
        split_small_frac=0.0)
    return codebooks


def encode(residuals: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(N, D), (m, C, ds) -> (N, m) uint8 codes (nearest codebook entry, the
    first on ties)."""
    subs = split_subspaces(residuals.float(), codebooks.shape[0])
    codes = kmeans_ops.assign_clusters_batched(subs, codebooks)  # (m, N)
    return codes.T.to(torch.uint8)


def reconstruct(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(N, m) codes -> (N, D) approximate residuals."""
    m, _, ds = codebooks.shape
    s = torch.arange(m, device=codes.device)
    return codebooks[s[None, :], codes.long()].reshape(codes.shape[0], m * ds)


def train_opq_rotation(residuals: torch.Tensor, weights,
                       gen: torch.Generator, *, m: int, n_codes: int,
                       iters: int = 3, codebook_iters: int = 4
                       ) -> torch.Tensor:
    """OPQ (Ge et al.): an orthogonal (D, D) rotation R that lowers the
    quantization error, by alternating minimization: encode R·x with fresh
    codebooks, then solve the orthogonal Procrustes problem
    R = argmin ||R x - x̂||² = U Vᵀ of SVD(Σ x̂ xᵀ). Rotated vectors are
    R @ x; queries rotate the same way, so the score algebra is unchanged."""
    x = residuals.float()
    dist_ops._check_fp32_matmul(x)
    d = x.shape[1]
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    w = torch.ones(x.shape[0], device=x.device) if weights is None \
        else weights.float()
    for _ in range(iters):
        xr = x @ r.T
        cb = train_codebooks(xr, weights, gen, m=m, n_codes=n_codes,
                             iters=codebook_iters)
        xhat = reconstruct(encode(xr, cb), cb)
        cov = (xhat * w[:, None]).T @ x  # (D, D)
        u, _, vt = torch.linalg.svd(cov, full_matrices=False)
        r = u @ vt
    return r


def adc_lut(residual_queries: torch.Tensor, codebooks: torch.Tensor,
            metric: str, levels: int = 1) -> torch.Tensor:
    """(Q', D), (levels*m, C, ds) -> (Q', levels*m, C) score lookup tables.

    residual_queries: q - c_coarse per (query, probe) pair, flattened to Q'.
    sqeuclidean: LUT[s, c] = 2 t_s·r_sc - ||r_sc||²; ip/cosine: t_s·r_sc
    (callers pass t = q).

    levels = 2 (two-level additive nibble PQ): codebook rows [0:m] and
    [m:2m] quantize the SAME m query subspaces, so the query split is tiled;
    the c1·c2 cross term is the caller's (the stored norm correction)."""
    mv, _, ds = codebooks.shape
    m = mv // levels
    qs = residual_queries.reshape(-1, m, ds).permute(1, 0, 2)  # (m, Q', ds)
    if levels > 1:
        qs = torch.cat([qs] * levels, dim=0)
    ip = _bmm_t(qs, codebooks).permute(1, 0, 2)  # (Q', mv, C)
    if metric == Metric.SQEUCLIDEAN:
        cb_sq = (codebooks.float() ** 2).sum(dim=2)  # (mv, C)
        return 2.0 * ip - cb_sq[None]
    return ip.contiguous()


def _take_codes(cb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(m, C, ds) entries at (m, N) codes -> (m, N, ds)."""
    return torch.gather(cb, 1, codes.long()[..., None].expand(
        -1, -1, cb.shape[2]))


def train_two_level_codebooks(residuals: torch.Tensor, weights,
                              gen: torch.Generator, *, m: int,
                              iters: int = 10, refine_iters: int = 1
                              ) -> torch.Tensor:
    """Two-level additive nibble codebooks: (2m, 16, ds); [0:m] = CB1,
    [m:] = CB2. Each subspace residual is quantized additively as
    r̂_s = CB1_s[c1] + CB2_s[c2] (16 + 16 entries, 256 reconstructions) at
    m bytes a vector; the c1·c2 cross term of ||r̂||² is exact through a
    per-row correction (norm_correction).

    Training: greedy (16-means on the residuals, then 16-means on what
    level 1 leaves) + `refine_iters` rounds of alternating conditional
    refits under exact joint encoding."""
    subs = split_subspaces(residuals.float(), m).contiguous()  # (m, N, ds)
    w = torch.ones(subs.shape[1], device=subs.device) if weights is None \
        else weights.float()
    kw = dict(n_clusters=16, iters=iters, split_small_frac=0.0)
    cb1, lab1 = kmeans_ops.kmeans_batched(subs, w, gen, **kw)
    cb2, _ = kmeans_ops.kmeans_batched(subs - _take_codes(cb1, lab1), w, gen,
                                       **kw)
    iota = torch.arange(16, device=subs.device)

    def refit(cb_fit, target, codes_fit):
        """Weighted per-code mean of `target`; an empty code keeps its
        entry."""
        onehot = (codes_fit[..., None] == iota).float() * w[None, :, None]
        sums = torch.bmm(onehot.transpose(1, 2), target)  # (m, 16, ds)
        cnts = onehot.sum(dim=1)[..., None]
        return torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0),
                           cb_fit)

    for _ in range(refine_iters):
        c1, c2 = _joint_encode_subs(subs, cb1, cb2)
        cb1 = refit(cb1, subs - _take_codes(cb2, c2), c1)
        cb2 = refit(cb2, subs - _take_codes(cb1, c1), c2)
    return torch.cat([cb1, cb2], dim=0)


def _joint_encode_subs(subs, cb1, cb2, chunk: int = _JOINT_CHUNK):
    """(m, N, ds) + (m, 16, ds) x2 -> ((m, N) c1, (m, N) c2) int32: the
    exact joint argmin over all 256 additive combinations per subspace (the
    first minimum on ties, as idx // 16, idx % 16). Row-chunked: the
    (m, chunk, 256) cost tensor bounds the working memory."""
    m, n, _ = subs.shape
    cross = 2.0 * _bmm_t(cb1, cb2)  # (m, 16, 16)
    sq1 = (cb1 * cb1).sum(dim=2)
    sq2 = (cb2 * cb2).sum(dim=2)
    c1 = torch.empty((m, n), dtype=torch.int32, device=subs.device)
    c2 = torch.empty_like(c1)
    for i in range(0, n, chunk):
        x = subs[:, i:i + chunk]
        a1 = sq1[:, None, :] - 2.0 * _bmm_t(x, cb1)  # (m, c, 16)
        a2 = sq2[:, None, :] - 2.0 * _bmm_t(x, cb2)
        cost = a1[..., :, None] + a2[..., None, :] + cross[:, None, :, :]
        idx = torch.argmin(cost.reshape(m, x.shape[1], 256), dim=2)
        c1[:, i:i + chunk] = idx // 16
        c2[:, i:i + chunk] = idx % 16
    return c1, c2


def encode_two_level(residuals: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """(N, D), (2m, 16, ds) -> (N, 2m) uint8 nibble codes [c1 | c2], by
    exact joint encoding."""
    m = codebooks.shape[0] // 2
    subs = split_subspaces(residuals.float(), m)
    c1, c2 = _joint_encode_subs(subs, codebooks[:m], codebooks[m:])
    return torch.cat([c1.T, c2.T], dim=1).to(torch.uint8)


def norm_correction(codes2: torch.Tensor, codebooks: torch.Tensor,
                    chunk: int = 1 << 18) -> torch.Tensor:
    """(N, 2m) codes + (2m, 16, ds) -> (N,) fp32 cross term
    Σ_s 2·CB1_s[c1]·CB2_s[c2], read straight from the (m, 16, 16) cross
    table. score = Σ_s' LUT[s'] - corr then reproduces 2 t·r̂ - ||r̂||²
    exactly for the additive reconstruction."""
    m = codebooks.shape[0] // 2
    cross = 2.0 * _bmm_t(codebooks[:m], codebooks[m:])  # (m, 16, 16)
    s = torch.arange(m, device=codes2.device)[None, :]
    out = torch.empty(codes2.shape[0], dtype=torch.float32,
                      device=codes2.device)
    for i in range(0, codes2.shape[0], chunk):
        c = codes2[i:i + chunk].long()
        out[i:i + chunk] = cross[s, c[:, :m], c[:, m:]].sum(dim=1)
    return out


def adc_scan_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(m, C) LUT + (L, m) codes -> (L,) summed scores: one gather."""
    return torch.gather(lut, 1, codes.long().T).sum(dim=0)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(N, m) uint8 codes < 16 -> (N, m//2) packed (low nibble: stream s,
    high nibble: stream s + m//2). Split halves, not interleaved."""
    m = codes.shape[1]
    if m % 2 != 0:
        raise ValueError(f"cannot pack an odd number of streams ({m})")
    return (codes[:, :m // 2] | (codes[:, m // 2:] << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(N, m//2) packed -> (N, m) uint8 codes (inverse of pack_nibbles)."""
    if packed.shape[1] * 2 != m:
        raise ValueError(f"{tuple(packed.shape)} does not unpack to {m}")
    return torch.cat([packed & 15, (packed >> 4) & 15], dim=1)


def probe_luts(queries: torch.Tensor, probe_ids: torch.Tensor,
               coarse_centroids: torch.Tensor, codebooks: torch.Tensor,
               metric: str, *, rotation: torch.Tensor | None = None,
               levels: int = 1) -> torch.Tensor:
    """(Q, P, levels*m, C) lookup tables of every (query, probe) pair, from
    the residual query t = q - c_probe (t = q for ip/cosine), rotated by
    the OPQ matrix when there is one."""
    q_n, d = queries.shape
    p_n = probe_ids.shape[1]
    if metric == Metric.SQEUCLIDEAN:
        t = queries[:, None, :] - coarse_centroids[probe_ids.long()]
    else:
        t = queries[:, None, :].expand(q_n, p_n, d)
    t = t.reshape(q_n * p_n, d)
    if rotation is not None:
        dist_ops._check_fp32_matmul(t)
        t = t @ rotation.T
    luts = adc_lut(t, codebooks, metric, levels=levels)
    return luts.reshape(q_n, p_n, *luts.shape[1:])


def scan_probed_lists_pq(
    queries: torch.Tensor,
    probe_ids: torch.Tensor,
    coarse_centroids: torch.Tensor,
    coarse_scores_at_probes: torch.Tensor,
    codebooks: torch.Tensor,
    sorted_codes: torch.Tensor,
    sorted_row_ids: torch.Tensor,
    list_offsets: torch.Tensor,
    list_counts: torch.Tensor,
    *,
    max_list_size: int,
    metric: str,
    k: int,
    rotation: torch.Tensor | None = None,
    sorted_norm_corr: torch.Tensor | None = None,
    levels: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search over probed lists. Returns (scores (Q, k), sorted-layout
    positions (Q, k) int32) of the best k live slots, -1 where fewer than k
    are live; a slot is live where its row id in `sorted_row_ids` is >= 0,
    and `sorted_row_ids[position]` is its row id.

    queries: (Q, D) fp32 (padded to m*ds). probe_ids: (Q, P).
    sorted_codes: (mb or mv, cap) uint8 STREAM-MAJOR (codes[s, slot]).
    coarse_scores_at_probes: (Q, P), the coarse part of the score
    (2 q·c - ||c||² or q·c) from the prober. rotation: optional (D, D) OPQ
    matrix; codes quantize R·residual, so residual queries rotate the same
    way. levels = 2 + sorted_norm_corr: two-level additive nibble PQ, with
    the per-row c1·c2 cross term subtracted (sqeuclidean only).

    Nibble-packed codes go through the K6 kernel (ops/pq_kernels.py); codes
    of one byte per stream (flat 8-bit, or 4-bit with an odd pq_dim) are
    scanned here by one torch.gather over the tables. The top-k stays
    outside the kernel: under refine the ADC pool is up to k + 1024."""
    q_n = queries.shape[0]
    probes = probe_ids.long()
    luts = probe_luts(queries, probe_ids, coarse_centroids, codebooks,
                      metric, rotation=rotation, levels=levels)

    mv = codebooks.shape[0]
    packed = sorted_codes.shape[0] != mv
    corr = sorted_norm_corr \
        if sorted_norm_corr is not None and metric == Metric.SQEUCLIDEAN \
        else None
    offs = list_offsets[probes]
    cnts = list_counts[probes]
    coarse = coarse_scores_at_probes.float()
    if packed:
        scores, ids = pq_kernels.pq_adc_scores(
            sorted_codes, sorted_row_ids, corr, luts, offs, cnts, coarse,
            window=max_list_size, positions=True)
    else:
        scores, ids = _scan_unpacked(sorted_codes, sorted_row_ids, corr, luts,
                                     offs, cnts, coarse, max_list_size)
    return topk_ops.merge_topk(scores.reshape(q_n, -1),
                               ids.reshape(q_n, -1), k)


def _scan_unpacked(codes, row_ids, corr, luts, offs, cnts, coarse, window):
    """(Q, P, window) masked ADC scores and layout positions from (mv, cap)
    codes of one byte per stream; live where the row id is >= 0."""
    mv, cap = codes.shape
    q_n, p_n = offs.shape
    col = torch.arange(window, device=codes.device)
    out_s, out_i = [], []
    step = max(1, _SCAN_ELEMS // max(1, p_n * mv * window))
    for q0 in range(0, q_n, step):
        pos = offs[q0:q0 + step].long()[:, :, None] + col  # (q, P, window)
        slots = torch.clamp(pos, max=cap - 1)
        win = codes[:, slots].permute(1, 2, 0, 3).long()  # (q, P, mv, window)
        s = torch.gather(luts[q0:q0 + step], 3, win).sum(dim=2) \
            + coarse[q0:q0 + step, :, None]
        if corr is not None:
            s = s - corr[slots]
        live = ((col < cnts[q0:q0 + step].long()[:, :, None])
                & (row_ids[slots] >= 0) & (pos < cap))
        ids = slots.to(torch.int32)
        out_s.append(torch.where(live, s,
                                 torch.full_like(s, topk_ops.NEG_INF)))
        out_i.append(torch.where(live, ids, torch.full_like(ids, -1)))
    return torch.cat(out_s), torch.cat(out_i)
