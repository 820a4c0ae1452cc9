"""Fused distance + top-k kernels for exact flat search, and their plain
PyTorch versions.

The counterpart of the JAX package's `ops/pallas_flat.py`. Three wrappers,
one per TPU kernel path, each launching a hand-written CUDA kernel
(`csrc/flat_topk.cu`) on a CUDA tensor and running its plain version on a
CPU tensor — never a fallback from one to the other:

  flat_topk_exact   (K1) replaces flat_topk_pallas(mode="exact")
  flat_topk_sketch  (K2) replaces flat_topk_pallas(mode="sketch"),
                         including the int8 x int8 -> int32 path
  flat_topk_large   (K3) replaces flat_topk_large (certified large k)

Each wrapper counts its kernel launches in `<wrapper>.launches`, a plain
int that a run resets and reads to show which kernels it went through;
`flat_topk_exact.wide_launches` counts those of K1's wide route.
K1's launch call is the span `kernel.launch` (utils/profiling).

Shared input contract (as the TPU kernels'): corpus (N, D) fp32, bf16 or
int8 rows; corpus_sqnorms (N,) fp32 with tombstoned rows raised past
DELETED_THRESHOLD; queries (Q, D); rows >= n_valid are padding;
corpus_scales (N,) fp32 dequant scales (int8) or None. Queries are scored
in the storage dtype (bf16 for int8 storage). Scores are larger-is-better:
mult·(q·x)·scale − csq with mult = 2 for sqeuclidean, 1 for inner product,
csq = sqnorm + pad penalty (sqeuclidean) or pad penalty + deletion penalty
(inner product). A slot scoring <= −1e29 (pad, deleted, or k beyond the
live rows) comes back as score −inf, id −1. Unlike the TPU kernels, N need
not be a multiple of any tile: the CUDA kernels mask the ragged edge.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import Metric

MAX_KERNEL_K = 32  # K1/K2 keep a warp-held top-k: one lane per slot
MAX_LARGE_K = 8192
MAX_SKETCH_CLASSES = 2048  # K2's merge stages the class winners in shared memory
MAX_R_PLANES = 88  # K3's "cores" route keeps a query's planes in 88 KB
NEG_INF = -float("inf")
_PAD_PENALTY = 1e30
_VALID_MIN = -dist_ops.DELETED_THRESHOLD
# Tile shape of csrc/flat_topk.cu (TQ, TC): used only to size the splits.
_TQ, _TC = 16, 128
# Blocks per SM the split count aims for. The CUDA-core kernels (the "cores"
# routes of K1-K3) hide memory latency with 4 blocks of a 19 KB stage; the
# ring routes run two blocks of a three-stage ring an SM (one block's
# products under the other's copies), all in one wave, or one where K3's
# planes need the SM's shared memory (`topr_plan`).
_BLOCKS_PER_SM = 4
_RING_BLOCKS_PER_SM = 2
# Shared memory of an H100 SM, what a block may take of it, and what the
# card keeps back for each resident block (bytes).
_SM_SMEM = 228 * 1024
_MAX_SMEM = 227 * 1024
_BLOCK_RESERVED = 1024
# K1's ring (csrc/flat_topk.cu RING_STAGES, RING_CHUNK) and score tile row
_RING_STAGES, _RING_CHUNK, _SCORE_PITCH = 3, 128, 128 + 8
# K3's "cores" route: the planes of the queries of a block (csrc topr_scan_kernel)
_PLANE_SMEM = 88 * 1024
# K3's ring route by blocks an SM (1 or 2), or None for `topr_plan`'s rule;
# eval/large_k_times.py sets it to time both.
_TOPR_BLOCKS_PER_SM = None
# The ring routes stage the 16 x d query tile beside the ring: at d = 2048
# that is 66 KB of bf16 (131 KB of fp32) and a block already has its SM to
# itself; deeper rows stay with the older CUDA-core kernels.
_RING_MAX_DIM = 2048
# K1's wide route (csrc/flat_topk.cu exact_scan_wide_kernel, WIDE_*): the
# most query slots a pass (two warpgroups' products of N / 2 each), corpus
# rows a tile, the ring's stages and bytes a row of a stage, the pitch of
# the scores of a 64-row block and the alignment slack of the swizzled
# panels.
_WIDE_MAX_N, _WIDE_ROWS, _WIDE_STAGES, _WIDE_CHUNK = 128, 128, 5, 128
_WIDE_SCORE_PITCH, _WIDE_ALIGN = 68, 1024
# The crossover: calls of at most this many queries keep the 16-query
# kernel, one tile reading the corpus once; above it the wide kernel reads
# it once a pass (the sweep of eval/wrapper_times.py, PERF.md).
# eval/wrapper_times.py changes it to time one route against the other.
_NARROW_MAX_Q = 16
_SOURCE = "flat_topk.cu"
_COMBO = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT8_X_INT8 = 3


# --------------------------------------------------------------- inputs ---


def _prepare(corpus, corpus_sqnorms, queries, n_valid, corpus_scales, metric,
             int8_compute=False):
    """Validate, cast queries to the scoring dtype (or quantize them for
    int8 x int8), and default the scales. Returns (queries, qscales,
    scales); qscales is None unless int8_compute."""
    if corpus.ndim != 2 or queries.ndim != 2:
        raise ValueError("corpus and queries must be 2-D")
    if corpus.dtype not in _COMBO:
        raise ValueError(f"unsupported storage dtype {corpus.dtype}")
    n, d = corpus.shape
    if queries.shape[1] != d:
        raise ValueError(f"query dim {queries.shape[1]} != corpus dim {d}")
    if corpus_sqnorms.shape != (n,) or corpus_sqnorms.dtype != torch.float32:
        raise ValueError("corpus_sqnorms must be (N,) float32")
    if not 0 <= int(n_valid) <= n:
        raise ValueError(f"n_valid {n_valid} outside [0, {n}]")
    if metric not in (Metric.SQEUCLIDEAN, Metric.INNER_PRODUCT):
        raise ValueError(f"kernel metric must be sqeuclidean or inner_product, got {metric!r}")
    if corpus_scales is None:
        corpus_scales = torch.ones(n, dtype=torch.float32, device=corpus.device)
    elif corpus_scales.shape != (n,) or corpus_scales.dtype != torch.float32:
        raise ValueError("corpus_scales must be (N,) float32")
    for t in (corpus_sqnorms, queries, corpus_scales):
        if t.device != corpus.device:
            raise ValueError(f"tensors on {t.device} and {corpus.device}")
    if int8_compute:
        if corpus.dtype != torch.int8:
            raise ValueError("int8_compute requires an int8 corpus")
        q, qscales = dist_ops.quantize_rows(queries)
        return q, qscales, corpus_scales
    return queries.to(topk_ops.query_dtype(corpus.dtype)), None, corpus_scales


def _csq_slot(corpus_sqnorms, n_valid: int, metric: str) -> torch.Tensor:
    """The per-row term every score subtracts: sqnorm + pad penalty for
    sqeuclidean, pad penalty + deletion penalty for inner product."""
    n = corpus_sqnorms.shape[0]
    rows = torch.arange(n, device=corpus_sqnorms.device)
    pen = torch.where(rows < int(n_valid), 0.0, _PAD_PENALTY).to(torch.float32)
    if metric == Metric.SQEUCLIDEAN:
        return corpus_sqnorms + pen
    return pen + dist_ops.deletion_penalty(corpus_sqnorms)


def _scores_plain(corpus, corpus_sqnorms, queries, n_valid, scales, metric,
                  qscales=None) -> torch.Tensor:
    """(Q, N) fp32 scores exactly as the kernels' score tile forms them."""
    mult = 2.0 if metric == Metric.SQEUCLIDEAN else 1.0
    if qscales is None:
        ip = dist_ops.pairwise_inner_product(queries, corpus)
        t = mult * (ip * scales[None, :])
    else:
        # int8 x int8: integer products, exact in fp32 while D*127^2 < 2^24
        exact = torch.float32 if corpus.shape[1] * 127 * 127 < 2 ** 24 \
            else torch.float64
        ip = (queries.to(exact) @ corpus.to(exact).T).float()
        t = (mult * qscales[:, None]) * (ip * scales[None, :])
    return t - _csq_slot(corpus_sqnorms, n_valid, metric)[None, :]


def _mask_invalid(s, i):
    live = s > _VALID_MIN
    return (torch.where(live, s, torch.full_like(s, NEG_INF)),
            torch.where(live, i, torch.full_like(i, -1)))


def _by_class(scores, tile_c: int):
    """(Q, N) -> (Q, ceil(N / tile_c), tile_c): row r lands in class
    r % tile_c of tile r // tile_c; the ragged last tile pads with -inf."""
    q, n = scores.shape
    nt = -(-n // tile_c)
    if nt * tile_c != n:
        scores = torch.cat(
            [scores, torch.full((q, nt * tile_c - n), NEG_INF,
                                device=scores.device)], dim=1)
    return scores.view(q, nt, tile_c)


def _require_cuda(corpus):
    if corpus.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {corpus.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """SMs of a CUDA device, looked up once a device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def exact_route(dtype, d: int) -> str:
    """Which of K1's kernels takes rows of `dtype` and depth `d`. "ring":
    the tensor cores fed by the copy ring (bf16 rows, or int8 rows widened
    to bf16, whose bytes a row are a multiple of 32: mma steps are 16
    values deep and an ldmatrix reads 32-byte units). "ring_fp32": fp32
    rows of a multiple of 16 bytes through the same ring, multiplied on the
    CUDA cores in fp32 (fp32 storage means fp32 math). "cores": the older
    CUDA-core kernel, for every other depth. A pure function of its
    arguments; all three are kernels of csrc/flat_topk.cu."""
    if dtype not in _COMBO:
        raise ValueError(f"unsupported storage dtype {dtype}")
    if d > _RING_MAX_DIM:
        return "cores"
    if dtype == torch.float32:
        return "ring_fp32" if d % 4 == 0 else "cores"
    row_bytes = d * (1 if dtype == torch.int8 else 2)
    return "ring" if row_bytes % 32 == 0 else "cores"


def _exact_splits(n_rows: int, n_q: int, sm_count: int,
                  blocks_per_sm: int = _RING_BLOCKS_PER_SM):
    """(rows_per_split, n_splits) for K1: about `blocks_per_sm` blocks per
    SM over (query tiles x splits), a split a whole number of tiles. The
    splits are as even as tiles allow, so the one wave of the ring
    routes ends together (49,141 tiles over 2 x 132 blocks: 187 a split,
    the last one shorter)."""
    q_tiles = -(-n_q // _TQ)
    want = max(1, -(-blocks_per_sm * sm_count // q_tiles))
    n_splits = max(1, min(want, -(-n_rows // _TC)))
    per = topk_ops.round_up(-(-n_rows // n_splits), _TC)
    return per, -(-n_rows // per)


def _wide_smem(width: int, d: int, dtype, k: int) -> int:
    """Shared memory of the wide kernel at `width` queries a pass and k
    (csrc wide_smem_bytes): the alignment slack, the pass's queries as bf16
    panels of 64 values covering every chunk's depth (a chunk of int8 rows
    is 128 values, two panels), the ring, the half-tile of scores, a
    threshold and two flags a query, two 8-byte barriers a stage, and
    each query's top-k (k scores and ids)."""
    row_bytes = d * (1 if dtype == torch.int8 else 2)
    panels = -(-row_bytes // _WIDE_CHUNK) * (2 if dtype == torch.int8 else 1)
    n = topk_ops.round_up(width, 16)
    return (_WIDE_ALIGN + panels * n * 128 + _WIDE_STAGES * _WIDE_ROWS
            * _WIDE_CHUNK + n * (_WIDE_SCORE_PITCH + 3) * 4
            + _WIDE_STAGES * 2 * 8 + n * k * 8)


def _wide_width(d: int, dtype, k: int) -> int:
    """The most queries a pass of the wide kernel takes at depth d and k:
    the largest multiple of 16 up to _WIDE_MAX_N whose shared memory fits."""
    n = _WIDE_MAX_N
    while n > 16 and _wide_smem(n, d, dtype, k) > _MAX_SMEM:
        n -= 16
    return n


class ExactPlan(NamedTuple):
    """How K1 runs a call: `route` ("ring_wide" or one of `exact_route`'s),
    queries a block (`width`) in `passes` blocks over the query axis, and
    the corpus cut into `n_splits` splits of `rows_per_split` rows."""
    route: str
    width: int
    passes: int
    rows_per_split: int
    n_splits: int


def exact_plan(n_rows: int, n_q: int, d: int, dtype, sm_count: int,
               k: int) -> ExactPlan:
    """K1's kernel and grid for n_q queries at top-k over n_rows rows of
    `dtype` and depth d on a card of `sm_count` SMs. Where `exact_route`
    takes the tensor-core ring and the call has more than _NARROW_MAX_Q
    queries, the wide kernel: as few passes of at most `_wide_width`
    queries as cover the call, each pass's queries rounded up to 16 (two
    warpgroups of a multiple of 8: 100 queries at D = 384 are one pass of
    112 slots, 100 at D = 768 two of 64), and one block an SM over (passes
    x splits), in one wave where the passes allow, the splits as even as
    tiles of _WIDE_ROWS rows allow. Otherwise the 16-query tiles of
    `exact_route`'s kernel (`_exact_splits`). A pure function of its
    arguments."""
    route = exact_route(dtype, d)
    if route == "ring" and n_q > _NARROW_MAX_Q:
        passes = -(-n_q // _wide_width(d, dtype, k))
        width = topk_ops.round_up(-(-n_q // passes), 16)
        passes = -(-n_q // width)
        # at most one block an SM: a second wave of a few blocks would take
        # as long as the first
        n_splits = max(1, min(sm_count // passes, -(-n_rows // _WIDE_ROWS)))
        per = topk_ops.round_up(-(-n_rows // n_splits), _WIDE_ROWS)
        return ExactPlan("ring_wide", width, passes, per, -(-n_rows // per))
    per, n_splits = _exact_splits(
        n_rows, n_q, sm_count,
        _BLOCKS_PER_SM if route == "cores" else _RING_BLOCKS_PER_SM)
    return ExactPlan(route, _TQ, -(-n_q // _TQ), per, n_splits)


def sketch_route(dtype, d: int, int8_compute: bool = False) -> str:
    """Which of K2's kernels takes rows of `dtype` and depth `d`. "ring":
    bf16 rows, or int8 rows with bf16 queries, on the tensor cores fed by
    K1's copy ring (a row a whole number of 32-byte units); "ring_int8":
    int8 rows with int8 queries (`int8_compute`) on the same ring through
    the int8 tensor-core product (exact int32 sums), the same rule;
    "ring_fp32": fp32 rows of a multiple of 16 bytes through the ring, fp32
    multiply-adds on the CUDA cores; "cores": the older CUDA-core kernel,
    for every other depth. A pure function of its arguments; all four are
    kernels of csrc/flat_topk.cu."""
    if int8_compute and dtype != torch.int8:
        raise ValueError("int8_compute requires an int8 corpus")
    route = exact_route(dtype, d)
    return "ring_int8" if int8_compute and route == "ring" else route


def _class_splits(n_rows: int, n_q: int, tile_c: int, sm_count: int,
                  blocks_per_sm: int = _BLOCKS_PER_SM, qpb: int = _TQ):
    """(tiles_per_split, n_splits) for K2/K3, whose blocks cover (block of
    `qpb` queries x class chunk x split of the corpus tiles): at most
    `blocks_per_sm` blocks an SM, so the ring routes run in one wave (at
    W = 2,048, 16 class chunks x 16 splits = 256 blocks of the H100's 2 x
    132), and splits as even as whole tiles allow; split s covers tiles
    [s * per, min(n_tiles, (s + 1) * per)) in ascending order."""
    blocks = -(-n_q // qpb) * -(-tile_c // _TC)
    n_tiles = -(-n_rows // tile_c)
    want = max(1, blocks_per_sm * sm_count // blocks)
    per = -(-n_tiles // max(1, min(want, n_tiles)))
    return per, -(-n_tiles // per)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _aligned(t):
    """`t`, or a copy where its first byte is not 16-byte aligned (a view
    that starts inside an allocation): K1 copies rows 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------------------------------------------- K1 ---


def flat_topk_exact_plain(corpus, corpus_sqnorms, queries, n_valid,
                          corpus_scales=None, *, k: int, metric: str):
    """Plain PyTorch version of K1: full score matrix, then top-k."""
    queries, _, scales = _prepare(corpus, corpus_sqnorms, queries, n_valid,
                                  corpus_scales, metric)
    s = _scores_plain(corpus, corpus_sqnorms, queries, n_valid, scales, metric)
    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=s.device)
    return topk_ops.merge_topk(s, ids[None, :].expand_as(s), k)


# Units in the last place a running fp32 sum may lose per term when its
# adds truncate, as the tensor cores' accumulation does (round-to-nearest
# loses half as much): the c of `flat_rounding_bound`.
_TRUNCATION_ULPS = 2.0
_FP32_HALF_ULP = 2.0 ** -24


def flat_rounding_bound(corpus, corpus_sqnorms, queries, n_valid,
                        corpus_scales=None, *, metric: str, rows=None):
    """What K1's scores may differ by from exact arithmetic, elementwise:
    (want, allowed), fp64. `want` is the score of the same stored values
    (queries cast to the scoring dtype first, as the kernel casts them)
    computed in fp64; `allowed` is what the kernel's roundings can add up
    to,

        mult * |scale| * c * D * 2^-24 * sum_i |q_i| |x_i|   the D fp32 adds
        + 2^-24 * |mult * scale * (q . x)|                   the scale product
        + 2^-24 * |want|                                     the subtraction

    with c = 2: products of bf16 or int8 values are exact, and every add of
    the running fp32 sum, in whatever order and grouping (16-deep steps on
    the tensor cores, whose adds truncate; an FMA chain on the CUDA cores),
    loses at most one unit in the last place of a partial sum that never
    exceeds sum_i |q_i| |x_i|. For fp32 rows the products round too, which
    c = 2 covers under round-to-nearest. On unit rows at D = 384 this is a
    few 1e-5, some 30 times tighter than atol 1e-3: a dropped 16-deep step
    or a wrong scale is far outside it.

    With `rows` (Q, k) int ids only those pairs are scored: (Q, k) results,
    ids < 0 read row 0 and are the caller's to skip. Otherwise (Q, N).
    """
    queries, _, scales = _prepare(corpus, corpus_sqnorms, queries, n_valid,
                                  corpus_scales, metric)
    mult = 2.0 if metric == Metric.SQEUCLIDEAN else 1.0
    csq = _csq_slot(corpus_sqnorms, n_valid, metric).double()
    q = queries.double()
    scales = scales.double()
    if rows is None:
        x = corpus.double()
        ip, mag = q @ x.T, q.abs() @ x.abs().T
        scales, csq = scales[None, :], csq[None, :]
    else:
        idx = rows.long().clamp(min=0)
        x = corpus[idx].double()  # (Q, k, D)
        ip = torch.einsum("qd,qkd->qk", q, x)
        mag = torch.einsum("qd,qkd->qk", q.abs(), x.abs())
        scales, csq = scales[idx], csq[idx]
    term = mult * scales * ip
    want = term - csq
    allowed = (mult * scales.abs() * _TRUNCATION_ULPS * corpus.shape[1]
               * _FP32_HALF_ULP * mag
               + _FP32_HALF_ULP * term.abs() + _FP32_HALF_ULP * want.abs())
    return want, allowed


def flat_topk_exact(corpus, corpus_sqnorms, queries, n_valid,
                    corpus_scales=None, *, k: int, metric: str):
    """K1: exact top-k, k <= 32. Returns ((Q, k) fp32 scores descending,
    (Q, k) int32 ids).

    Replaces cuvs_rag_tpu/ops/pallas_flat.py flat_topk_pallas(mode="exact")
    (`_kernel`, `_score_tile`, `_select_topk_*`). Its floor on the H100 is
    the one HBM read of the corpus (about 16 multiply-adds per byte at a
    batch of 16). `exact_plan` chooses the kernel from the call's shape.
    bf16 and int8 rows take the tensor cores: at most 16 queries
    (`_NARROW_MAX_Q`), blocks over (16-query tile x corpus split), two an
    SM, stream their split through a three-stage cp.async ring in shared
    memory and multiply with mma.sync (bf16 x bf16 products are exact,
    sums fp32; int8 rows are widened in registers), so the read is what
    bounds it; the 16 x 128 score tile passes through shared memory into
    the selection. More queries take the wide kernel, which reads the
    corpus once a pass of up to 128 queries instead of once a 16-query
    tile: one block an SM, a TMA-fed ring, wgmma with corpus rows as M and
    the pass's queries as N, two warpgroups each selecting for half of
    them. fp32 rows come through the same ring and are multiplied on
    the CUDA cores in fp32 (no TF32), float4 reads from shared memory
    feeding FMA chains in depth order, which bound it; depths neither
    takes keep the older CUDA-core kernel, bound by its scalar inner loop.
    In all three each warp holds its two queries' running top-k in its lanes
    behind a k-th-best threshold, so selection costs one ballot per score;
    the per-split partials (Q, S, k) are reduced by a merge pass. Scores
    stay exact fp32 up to the order of the adds (`flat_rounding_bound`;
    the TPU's 11-bit key truncation is not copied).
    """
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"k must be in [1, {MAX_KERNEL_K}], got {k}")
    if corpus.device.type == "cpu":
        return flat_topk_exact_plain(corpus, corpus_sqnorms, queries, n_valid,
                                     corpus_scales, k=k, metric=metric)
    _require_cuda(corpus)
    queries, _, scales = _prepare(corpus, corpus_sqnorms, queries, n_valid,
                                  corpus_scales, metric)
    from cuvs_rag_tpu_torch.kernels import build

    dev = corpus.device
    n, d = corpus.shape
    n_q = queries.shape[0]
    plan = exact_plan(n, n_q, d, corpus.dtype, _sm_count(dev), k)
    wide = plan.route == "ring_wide"
    queries = _aligned(queries.contiguous())
    corpus = _aligned(corpus.contiguous())
    sqnorms = corpus_sqnorms.contiguous()
    scales = scales.contiguous()
    part_s = torch.empty((n_q, plan.n_splits, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((n_q, plan.n_splits, k), dtype=torch.int32,
                         device=dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    lib = build.load(_SOURCE)
    call = (_ptr(queries), _ptr(corpus), _ptr(sqnorms), _ptr(scales), n_q, d,
            n, int(n_valid), int(metric == Metric.SQEUCLIDEAN), k)
    out = (_ptr(part_s), _ptr(part_i), _ptr(out_s), _ptr(out_i),
           build.raw_stream(dev))
    with build.device_guard(dev), profiling.span(
            "kernel.launch", kernel="K1", device=dev.index):
        if wide:
            err = lib.flat_exact_wide_topk(
                _COMBO[corpus.dtype], *call, plan.width, plan.passes,
                plan.rows_per_split, plan.n_splits, *out)
        else:
            err = lib.flat_exact_topk(
                _COMBO[corpus.dtype], int(plan.route != "cores"), *call,
                plan.rows_per_split, plan.n_splits, *out)
    build.check(err, "flat_exact_wide_topk" if wide else "flat_exact_topk")
    flat_topk_exact.launches += 1
    flat_topk_exact.wide_launches += wide
    return out_s, out_i


flat_topk_exact.launches = 0
flat_topk_exact.wide_launches = 0  # of `launches`, those of the wide kernel


# ------------------------------------------------------------------- K2 ---


def flat_topk_sketch_plain(corpus, corpus_sqnorms, queries, n_valid,
                           corpus_scales=None, *, k: int, metric: str,
                           tile_c: int, int8_compute: bool = False):
    """Plain PyTorch version of K2: per-class first-max over the corpus
    tiles, then the top-k of the class winners (lower class first on ties)."""
    queries, qscales, scales = _prepare(corpus, corpus_sqnorms, queries,
                                        n_valid, corpus_scales, metric,
                                        int8_compute)
    s = _scores_plain(corpus, corpus_sqnorms, queries, n_valid, scales,
                      metric, qscales)
    best, tile = _by_class(s, tile_c).max(dim=1)  # first max = earliest row
    cls = torch.arange(tile_c, device=s.device)
    rows = (tile * tile_c + cls[None, :]).to(torch.int32)
    order = torch.sort(best, dim=1, descending=True, stable=True).indices
    top = order[:, :k]
    out_s, out_i = _mask_invalid(torch.gather(best, 1, top),
                                 torch.gather(rows, 1, top))
    if out_s.shape[1] < k:  # fewer classes than k
        out_s, out_i = topk_ops.merge_topk(out_s, out_i, k)
    return out_s, out_i


def flat_topk_sketch(corpus, corpus_sqnorms, queries, n_valid,
                     corpus_scales=None, *, k: int, metric: str, tile_c: int,
                     int8_compute: bool = False):
    """K2: sketch top-k, k <= 32 — the best (score, row) per column class
    (row mod tile_c), then the top-k over the class winners. Recall is about
    1 - C(k,2)/tile_c per query. With int8_compute (int8 storage), queries
    are quantized per row and the dot runs int8 x int8 -> int32.

    Replaces cuvs_rag_tpu/ops/pallas_flat.py flat_topk_pallas(mode="sketch")
    (`_sketch_kernel`, `_quantize_query_rows`). Like K1 it is bound by one
    HBM read of the corpus, and its ring routes (`sketch_route`) read it as
    K1 does: blocks over (16-query tile x 128-class chunk x split of the
    corpus tiles), two an SM in one wave, stream each tile's 128 rows of
    their classes (W rows apart from one tile to the next) through K1's
    three-stage cp.async ring and multiply on the tensor cores (bf16 rows;
    int8 rows widened to bf16; int8 x int8 by the int8 product, whose exact
    int32 sums make this route's scores bit-equal to the plain version's)
    or, for fp32 rows, with fp32 FMAs on the CUDA cores. Other depths keep
    the older CUDA-core kernel (score_tile's scalar loop). Each (query,
    class) winner stays in registers with a strict > over tiles in
    ascending order, so the earliest row wins a tie; the merge pass takes
    the per-class max across splits in row order, then the top-k of the
    winners, the lower class first on ties.
    """
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"k must be in [1, {MAX_KERNEL_K}], got {k}")
    if not 1 <= tile_c <= MAX_SKETCH_CLASSES:
        raise ValueError(f"tile_c must be in [1, {MAX_SKETCH_CLASSES}]")
    if corpus.device.type == "cpu":
        return flat_topk_sketch_plain(
            corpus, corpus_sqnorms, queries, n_valid, corpus_scales, k=k,
            metric=metric, tile_c=tile_c, int8_compute=int8_compute)
    _require_cuda(corpus)
    queries, qscales, scales = _prepare(corpus, corpus_sqnorms, queries,
                                        n_valid, corpus_scales, metric,
                                        int8_compute)
    from cuvs_rag_tpu_torch.kernels import build

    dev = corpus.device
    n, d = corpus.shape
    n_q = queries.shape[0]
    ring = sketch_route(corpus.dtype, d, int8_compute) != "cores"
    per, n_splits = _class_splits(
        n, n_q, tile_c, _sm_count(dev),
        _RING_BLOCKS_PER_SM if ring else _BLOCKS_PER_SM)
    queries = queries.contiguous()
    corpus = _aligned(corpus.contiguous())
    part_s = torch.empty((n_splits, n_q, tile_c), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, n_q, tile_c), dtype=torch.int32, device=dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    combo = _INT8_X_INT8 if int8_compute else _COMBO[corpus.dtype]
    with build.device_guard(dev):
        err = build.load(_SOURCE).flat_sketch_topk(
            combo, int(ring), _ptr(queries), _ptr(corpus),
            _ptr(corpus_sqnorms.contiguous()), _ptr(scales.contiguous()),
            _ptr(qscales), n_q, d, n, int(n_valid),
            int(metric == Metric.SQEUCLIDEAN), tile_c, k, per, n_splits,
            _ptr(part_s), _ptr(part_i), _ptr(out_s), _ptr(out_i),
            build.raw_stream(dev),
        )
    build.check(err, "flat_sketch_topk")
    flat_topk_sketch.launches += 1
    return out_s, out_i


flat_topk_sketch.launches = 0


# ------------------------------------------------------------------- K3 ---


def default_r_planes(k: int, tile_c: int) -> int:
    """Poisson-tail plane count: P(some class holds > R of the true top-k)
    small. lambda = k/tile_c true hits per class; mean + 5*sqrt + slack."""
    lam = k / tile_c
    return max(2, int(math.ceil(lam + 5.0 * math.sqrt(lam + 0.5) + 2.0)))


def _large_args(k, tile_c, r_planes):
    if not 1 <= k <= MAX_LARGE_K:
        raise ValueError(f"k must be in [1, {MAX_LARGE_K}], got {k}")
    r_planes = r_planes or default_r_planes(k, tile_c)
    if r_planes > MAX_R_PLANES:
        raise ValueError(f"r_planes={r_planes} > {MAX_R_PLANES}: raise tile_c")
    if k > r_planes * tile_c:
        raise ValueError(f"k={k} > r_planes*tile_c={r_planes * tile_c}")
    return r_planes


def finish_large(planes_s, planes_i, rej, k):
    """Top-k of the R*tile_c class candidates and the exactness certificate
    max(rej) < tau (ties conservatively fail), as the TPU wrapper does."""
    q = planes_s.shape[0]
    cand_s = planes_s.reshape(q, -1)
    top_s, arg = torch.topk(cand_s, k, dim=1)
    top_i = torch.gather(planes_i.reshape(q, -1), 1, arg)
    top_s, top_i = _mask_invalid(top_s, top_i)
    certified = rej.amax(dim=1) < top_s[:, k - 1]
    return top_s, top_i, certified


def _topr_select_plain(vals, ids, r_planes: int):
    """Each class's R best of (Q, T, W) scores `vals` (ids `ids`) over the
    T tiles: planes (Q, R, W) scores and ids, descending, and rej (Q, W),
    the (R+1)-th best value (-inf where a class has no more)."""
    q, nt, w = vals.shape
    if nt <= r_planes:  # fewer tiles than planes: empty planes, nothing rejected
        fill = r_planes + 1 - nt
        vals = torch.cat([vals, torch.full((q, fill, w), NEG_INF,
                                           device=vals.device)], dim=1)
        ids = torch.cat([ids, torch.full((q, fill, w), -1, dtype=ids.dtype,
                                         device=ids.device)], dim=1)
    v, arg = torch.topk(vals, r_planes + 1, dim=1)
    return v[:, :r_planes], torch.gather(ids, 1, arg[:, :r_planes]), v[:, r_planes]


def topr_merge_plain(part_s, part_i, part_rej):
    """Plain version of the merge of K3's and K5's splits
    (`topr_merge_kernel`): planes (S, Q, R, W) and rej (S, Q, W) of S
    splits -> each class's R best of the union of the splits' planes (Q,
    R, W) and its rej (Q, W), the max of the splits' rej values and of the
    (R+1)-th best of the union: every value the union holds beyond its R
    best, so max(rej) < tau proves as much as it does unsplit."""
    s, q, r, w = part_s.shape
    union_s = part_s.permute(1, 0, 2, 3).reshape(q, s * r, w)
    union_i = part_i.permute(1, 0, 2, 3).reshape(q, s * r, w)
    planes_s, planes_i, rej = _topr_select_plain(union_s, union_i, r)
    return planes_s, planes_i, torch.maximum(part_rej.amax(dim=0), rej)


def topr_planes_plain(vals, ids, r_planes: int, n_splits: int = 1):
    """The planes (Q, R, W) and rej (Q, W) of (Q, T, W) tile scores, as the
    kernels form them: the T tiles cut into `n_splits` runs of ceil(T / S)
    (the card's split of the tiles or probes), each run selected on its
    own and the runs merged by `topr_merge_plain`; n_splits = 1 selects
    once. Any split gives the same planes, up to the order of ties, and
    the same rej. The validity rule is applied to the planes."""
    nt = vals.shape[1]
    per = max(1, -(-nt // n_splits))
    parts = [_topr_select_plain(vals[:, t0:t0 + per], ids[:, t0:t0 + per],
                                r_planes)
             for t0 in range(0, max(nt, 1), per)]
    if len(parts) == 1:
        planes_s, planes_i, rej = parts[0]
    else:
        planes_s, planes_i, rej = topr_merge_plain(
            *(torch.stack(t) for t in zip(*parts)))
    planes_s, planes_i = _mask_invalid(planes_s, planes_i)
    return planes_s, planes_i, rej


def flat_topk_large_plain(corpus, corpus_sqnorms, queries, n_valid,
                          corpus_scales=None, *, k: int, metric: str,
                          tile_c: int = 1024, r_planes: int = 0,
                          planes: bool = False, n_splits: int = 1):
    """Plain PyTorch version of K3: each class's R best rows and its
    (R+1)-th best value (`rej`), then the top-k and the certificate; with
    `planes`, the planes (Q, R, W) scores and ids and rej (Q, W) instead.
    `n_splits` selects over that many runs of tiles and merges them, as
    the card does (`topr_planes_plain`)."""
    r_planes = _large_args(k, tile_c, r_planes)
    queries, _, scales = _prepare(corpus, corpus_sqnorms, queries, n_valid,
                                  corpus_scales, metric)
    s = _scores_plain(corpus, corpus_sqnorms, queries, n_valid, scales, metric)
    by_class = _by_class(s, tile_c)
    q, nt, _ = by_class.shape
    rows = torch.arange(nt * tile_c, dtype=torch.int32, device=s.device)
    out = topr_planes_plain(by_class, rows.view(1, nt, tile_c).expand(q, -1, -1),
                            r_planes, n_splits)
    return out if planes else finish_large(*out, k)


def _ring_bytes(dtype, d: int) -> int:
    """Shared memory of K3's ring walk before its planes (csrc/flat_topk.cu
    class_ring_bytes): the staged 16-query tile (bf16, or fp32 for fp32
    rows), the score tile (not for fp32 rows) and the ring's stages."""
    fp32 = dtype == torch.float32
    row_bytes = d * {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    chunk = min(_RING_CHUNK, row_bytes)
    return (_TQ * ((4 if fp32 else 2) * d + 16)
            + (0 if fp32 else _TQ * _SCORE_PITCH * 4)
            + _RING_STAGES * _TC * (chunk + 16))


def topr_plan(n_q: int, r_planes: int, d: int, dtype, n_tiles: int,
              blocks_per_sm: int = None):
    """(route, queries a block, bytes of a plane id, blocks an SM) of K3
    for n_q queries, R planes, rows of `dtype` and depth d over n_tiles
    class tiles. The ring routes are K1's (`exact_route`) and keep a
    block's planes (qpb x R x 128 classes) in shared memory behind the
    ring; an id is the 2-byte tile number while n_tiles <= 65,535, else the
    4-byte row. Of two blocks an SM (the ring's own occupancy: the planes
    get what is left of half the SM) and one (the planes get the rest of
    the block's 227 KB), the rule takes the one that reads the corpus
    fewest times, ceil(n_q / qpb), and two blocks on a tie: one query at
    R = 12 fits two blocks, 16 queries fit only one (144 KB of planes
    beside a 75 KB ring at D = 384 bf16; eval/large_k_times.py times one
    block with all 16 queries against two with 4 queries a block).
    `blocks_per_sm` (or
    _TOPR_BLOCKS_PER_SM) fixes one of the two. Where no plane fits beside
    the ring, and at depths the ring does not take, the route is "cores",
    topr_scan_kernel (4 bytes an id, 88 KB of planes, four blocks an SM).
    A pure function of its arguments."""
    route = exact_route(dtype, d)
    blocks_per_sm = blocks_per_sm or _TOPR_BLOCKS_PER_SM
    if route != "cores":
        id_bytes = 2 if n_tiles <= 0xFFFF else 4
        entry = r_planes * _TC * (4 + id_bytes)
        best = None
        for bps in (blocks_per_sm,) if blocks_per_sm else (2, 1):
            budget = min(_MAX_SMEM, _SM_SMEM // bps - _BLOCK_RESERVED)
            qpb = min(_TQ, n_q, (budget - _ring_bytes(dtype, d)) // entry)
            if qpb >= 1 and (best is None
                             or -(-n_q // qpb) < -(-n_q // best[1])):
                best = (route, qpb, id_bytes, bps)
        if best is not None:
            return best
    qpb = min(_TQ, n_q, _PLANE_SMEM // (r_planes * _TC * 8))
    return "cores", qpb, 4, _BLOCKS_PER_SM


def flat_topk_large(corpus, corpus_sqnorms, queries, n_valid,
                    corpus_scales=None, *, k: int, metric: str,
                    tile_c: int = 1024, r_planes: int = 0,
                    planes: bool = False):
    """K3: certified large-k selection (k up to 8192, the reference's
    top_k=2000 regime). Returns (scores (Q, k) descending, ids (Q, k),
    certified (Q,) bool); with `planes`, the planes (Q, R, tile_c) scores
    and ids and rej (Q, tile_c) that they come from. certified[q] PROVES
    row q exact: every class (row mod tile_c) kept its R best rows and
    `rej`, the best value it ever rejected; a true top-k member that was
    missed lies at or below its class's rej, so max(rej) < tau (the k-th
    collected score) rules it out. Uncertified rows must be recomputed by
    the caller.

    Replaces cuvs_rag_tpu/ops/pallas_flat.py flat_topk_large (`_topr_kernel`,
    `default_r_planes`). Bound, like K1 and K2, by one read of the corpus.
    Its ring routes (`topr_plan`: bf16 and int8 rows on the tensor cores,
    fp32 rows with fp32 FMAs, wherever K1 takes the ring) stream the corpus
    exactly as K2 does: blocks over (block of queries x 128-class chunk x
    split of the corpus tiles) walk their classes' rows, W rows apart
    from one tile to the next, through K1's three-stage cp.async ring, in
    one wave. Only the selection differs: each (query, class) keeps its R
    best in the block's shared memory behind the ring and plane R-1 and
    rej in registers, and the chain runs only for a score that beats plane
    R-1 (~R (1 + ln(T / R)) of T tiles). At one query a block's planes
    take 9 KB (R = 12) and two blocks share an SM as K1's and K2's do; 16
    queries' planes take most of an SM, so such blocks run one an SM and
    read the corpus once; one block an SM keeps fewer copies in flight, and
    that, not the selection, bounds K3 at 16 queries (PERF.md). Other depths, and planes that fit no ring block, keep
    the older CUDA-core kernel. The merge pass keeps each class's R best of
    the union of the splits and folds every value it displaces into rej,
    which keeps the certificate sound.
    """
    r_planes = _large_args(k, tile_c, r_planes)
    if corpus.device.type == "cpu":
        return flat_topk_large_plain(
            corpus, corpus_sqnorms, queries, n_valid, corpus_scales, k=k,
            metric=metric, tile_c=tile_c, r_planes=r_planes, planes=planes)
    _require_cuda(corpus)
    queries, _, scales = _prepare(corpus, corpus_sqnorms, queries, n_valid,
                                  corpus_scales, metric)
    from cuvs_rag_tpu_torch.kernels import build

    dev = corpus.device
    n, d = corpus.shape
    n_q = queries.shape[0]
    route, qpb, id_bytes, bps = topr_plan(n_q, r_planes, d, corpus.dtype,
                                          -(-n // tile_c))
    per, n_splits = _class_splits(n, n_q, tile_c, _sm_count(dev), bps, qpb)
    queries = queries.contiguous()
    corpus = _aligned(corpus.contiguous())
    part_s = torch.empty((n_splits, n_q, r_planes, tile_c), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((n_splits, n_q, r_planes, tile_c), dtype=torch.int32,
                         device=dev)
    part_rej = torch.empty((n_splits, n_q, tile_c), dtype=torch.float32,
                           device=dev)
    planes_s = torch.empty((n_q, r_planes, tile_c), dtype=torch.float32,
                           device=dev)
    planes_i = torch.empty((n_q, r_planes, tile_c), dtype=torch.int32,
                           device=dev)
    rej = torch.empty((n_q, tile_c), dtype=torch.float32, device=dev)
    with build.device_guard(dev):
        err = build.load(_SOURCE).flat_topr(
            _COMBO[corpus.dtype], int(route != "cores"), qpb, id_bytes,
            _ptr(queries), _ptr(corpus),
            _ptr(corpus_sqnorms.contiguous()), _ptr(scales.contiguous()),
            n_q, d, n, int(n_valid), int(metric == Metric.SQEUCLIDEAN),
            tile_c, r_planes, per, n_splits, _ptr(part_s), _ptr(part_i),
            _ptr(part_rej), _ptr(planes_s), _ptr(planes_i), _ptr(rej),
            build.raw_stream(dev),
        )
    build.check(err, "flat_topr")
    flat_topk_large.launches += 1
    if planes:
        return planes_s, planes_i, rej
    return finish_large(planes_s, planes_i, rej, k)


flat_topk_large.launches = 0
