"""Probed-list scan kernels of IVF-Flat, and their plain PyTorch versions.

The counterpart of the JAX package's `ops/pallas_ivf.py`. Two wrappers,
one per TPU kernel, each launching a hand-written CUDA kernel
(`csrc/ivf_scan.cu`) on a CUDA tensor and running its plain version on a
CPU tensor — never a fallback from one to the other:

  ivf_scan        (K4) replaces ivf_scan_pallas (k <= 32)
  ivf_scan_large  (K5) replaces ivf_scan_pallas_large (certified large k)

Each launches through `kernels/build.launcher`, which counts the launches
of each C entry point in `build.launches` and makes the call the span
`kernel.launch` (kernel "K4", "K5").

Input contract (ivf_scan_pallas's, without its 128-alignment asserts):
sorted_vectors (cap, D) fp32, bf16 or int8 residual rows; sorted_sqnorms
(cap,) fp32 reconstruction sqnorms, raised past DELETED_THRESHOLD for
deleted or filtered-out rows; sorted_scales (cap,) fp32 (1.0 for floats);
queries (Q, D); probe_offsets and probe_counts (Q, P) int32 window starts
and list lengths; coarse_ip (Q, P) fp32, added for int8 storage only.
A window is [offset, offset + min(count, window)). Queries are cast to the
storage dtype (bf16 for int8). Scores are larger-is-better: 2(q.w) - sqn
(sqeuclidean) or (q.w) - max(sqn - 1e29, 0) (inner product), with q.w
times the row scale plus coarse_ip for int8. A slot scoring <= -1e29 comes
back as -inf / -1. Outputs are positions in the sorted layout.
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import distance as dist_ops
from cuvs_rag_tpu_torch.ops import flat_kernels
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils.config import Metric

MAX_KERNEL_K = 32  # K4 keeps a warp-held top-k: one lane per slot
MAX_LARGE_K = 8192
MAX_R_PLANES = 64  # past this the insertion chain rivals the window read
_K4_CHUNK = 256  # window rows per block of K4's "cores" route (csrc CHUNK)
# Window rows per block of K4's ring route (`k4_pieces`): the largest of
# _K4_PIECES that still gives _K4_BLOCKS_PER_SM blocks an SM over a call's
# (query, probe) pairs.
_K4_PIECES = (1024, 512, 256)
_K4_BLOCKS_PER_SM = 4
_K4_TILE = 128  # the ring's tile (csrc/ring.cuh TC)
_K5_CLASSES = 128  # classes per K5 block (csrc/ivf_scan.cu CLASSES, ring TC)
# Shared memory a K5 block may take (`_k5_smem` says what it takes): the
# card's limit for one block; each of two blocks an SM (the ring's
# occupancy, as K4's) gets half the SM.
_K5_SMEM = build.MAX_SMEM
_K5_BLOCKS_PER_SM = 2
_SOURCE = "ivf_scan.cu"
_COMBO = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# Elements of the gathered (queries, probes, window, D) block per chunk of
# queries in the plain versions: bounds the fp32 temporary at 1 GiB.
_PLAIN_ELEMS = 1 << 28


def _prepare(vectors, sqnorms, scales, queries, offsets, counts, coarse_ip,
             window, metric):
    """Validate; return (queries in the scoring dtype, offsets, counts,
    coarse) with int32 offsets/counts and fp32 coarse (zeros when None)."""
    if vectors.ndim != 2 or queries.ndim != 2:
        raise ValueError("sorted_vectors and queries must be 2-D")
    if vectors.dtype not in _COMBO:
        raise ValueError(f"unsupported storage dtype {vectors.dtype}")
    cap, d = vectors.shape
    if queries.shape[1] != d:
        raise ValueError(f"query dim {queries.shape[1]} != layout dim {d}")
    for name, t in (("sorted_sqnorms", sqnorms), ("sorted_scales", scales)):
        if t.shape != (cap,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({cap},) float32")
    shape = (queries.shape[0], offsets.shape[-1])
    if offsets.shape != shape or counts.shape != shape:
        raise ValueError(f"probe offsets/counts must be {shape}")
    if coarse_ip is None:
        coarse_ip = torch.zeros(shape, dtype=torch.float32,
                                device=vectors.device)
    elif coarse_ip.shape != shape:
        raise ValueError(f"coarse_ip must be {shape}")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if metric not in (Metric.SQEUCLIDEAN, Metric.INNER_PRODUCT):
        raise ValueError(f"kernel metric must be sqeuclidean or "
                         f"inner_product, got {metric!r}")
    for t in (sqnorms, scales, queries, offsets, counts, coarse_ip):
        if t.device != vectors.device:
            raise ValueError(f"tensors on {t.device} and {vectors.device}")
    return (queries.to(topk_ops.query_dtype(vectors.dtype)),
            offsets.to(torch.int32), counts.to(torch.int32),
            coarse_ip.to(torch.float32))


def _window_scores_plain(vectors, sqnorms, scales, queries, offsets, counts,
                         coarse, window, metric):
    """(Q, P, window) fp32 scores and int32 layout positions of every probed
    window, -inf past each window's count, as the kernels form them."""
    cap, d = vectors.shape
    q_n, p_n = offsets.shape
    dev = vectors.device
    col = torch.arange(window, device=dev)
    scaled = vectors.dtype == torch.int8
    qf = queries.float()
    out_s = []
    step = max(1, _PLAIN_ELEMS // max(1, p_n * window * d))
    pos = offsets.long()[:, :, None] + col  # (Q, P, window)
    slots = torch.clamp(pos, max=cap - 1)
    for q0 in range(0, q_n, step):
        sl = slots[q0:q0 + step]
        ip = torch.einsum("qpwd,qd->qpw", vectors[sl].float(), qf[q0:q0 + step])
        aux0 = sqnorms[sl]
        if scaled:
            ip = ip * scales[sl]
        cf = coarse[q0:q0 + step, :, None]
        if metric == Metric.SQEUCLIDEAN:
            s = 2.0 * ip - aux0
            if scaled:
                s = s + cf
        else:
            s = (ip + cf if scaled else ip) - dist_ops.deletion_penalty(aux0)
        out_s.append(s)
    s = torch.cat(out_s)
    live = col < torch.clamp(counts.long(), max=window)[:, :, None]
    return (torch.where(live, s, torch.full_like(s, topk_ops.NEG_INF)),
            pos.to(torch.int32))


def ivf_route(dtype, d: int) -> str:
    """Which of K4's kernels takes layout rows of `dtype` and depth `d`.
    "ring": rows of a multiple of 16 bytes (any window start is then a
    16-byte boundary of the layout), streamed by K1's copy ring and
    multiplied in fp32 on the CUDA cores, the query held in shared memory
    (up to the ring routes' depth of 2,048); "cores": the older kernel,
    2- or 4-byte loads a lane. A pure function of its arguments."""
    if dtype not in _COMBO:
        raise ValueError(f"unsupported storage dtype {dtype}")
    if d > flat_kernels.RING_MAX_DIM or d * _ELEMENT_BYTES[dtype] % 16:
        return "cores"
    return "ring"


def k4_pieces(window: int, route: str, pairs: int = 1, sm_count: int = 132,
              piece: int = None):
    """(rows a block, blocks a probe) of K4 for this window and a call of
    `pairs` (query, probe) pairs on `sm_count` SMs. The cores route takes
    256 rows a block. The ring takes `piece` rows (0 = the whole window,
    rounded up to the ring's tile) or, where it is None, the largest of
    _K4_PIECES that still gives _K4_BLOCKS_PER_SM blocks an SM (the
    smallest where none does): a block's copies stream at a rate its ring
    depth bounds, so few pairs want short pieces, while many pairs fill the
    card either way and long pieces start fewer blocks (on the H100: 1,024
    rows best at 16 queries x 20 probes, 256 at one query). Block c of a probe with `count` rows scans
    window rows [c * rows, min(count, window, (c + 1) * rows)) and none at
    all past the count."""
    if route == "cores":
        per = _K4_CHUNK
    else:
        if piece is None:
            want = _K4_BLOCKS_PER_SM * sm_count
            piece = next((p for p in _K4_PIECES if pairs * -(-window // p) >= want),
                         _K4_PIECES[-1])
        per = topk_ops.round_up(piece if piece > 0 else window, _K4_TILE)
    return per, -(-window // per)


# ------------------------------------------------------------------- K4 ---


def ivf_scan_plain(sorted_vectors, sorted_sqnorms, sorted_scales, queries,
                   probe_offsets, probe_counts, *, k: int, window: int,
                   metric: str, coarse_ip=None):
    """Plain PyTorch version of K4: gather every probed window, score it,
    top-k. Takes any k (it is also the exact reference for K5)."""
    q, offs, cnts, coarse = _prepare(
        sorted_vectors, sorted_sqnorms, sorted_scales, queries, probe_offsets,
        probe_counts, coarse_ip, window, metric)
    s, pos = _window_scores_plain(sorted_vectors, sorted_sqnorms,
                                  sorted_scales, q, offs, cnts, coarse,
                                  window, metric)
    q_n = s.shape[0]
    return topk_ops.merge_topk(s.reshape(q_n, -1), pos.reshape(q_n, -1), k)


def ivf_rounding_bound(sorted_vectors, sorted_sqnorms, sorted_scales,
                       queries, probe_offsets, probe_counts, *, window: int,
                       metric: str, coarse_ip=None, positions=None):
    """What K4's scores may differ by from exact arithmetic, elementwise:
    (want, allowed), fp64. The counterpart of
    `flat_kernels.flat_rounding_bound` over the probed windows: `want` is
    the score of the same stored values (queries cast to the scoring dtype,
    as the kernel casts them) computed in fp64, with the row scale and the
    probe's coarse term of int8 residual rows; `allowed` is what the
    kernel's roundings can add up to,

        mult * |scale| * c * D * 2^-24 * sum_i |q_i| |x_i|   the D fp32 adds
        + 2^-24 * |mult * scale * (q . x)|                   the scale product
        + 2^-24 * |first sum|                                the first add
        + 2^-24 * |want|                                     the last one

    with c = 2 (any order and grouping of the adds, truncating or not; the
    products of bf16 or int8 values with bf16 queries are exact, those of
    fp32 rows round, which c = 2 covers) and the first sum 2 (q . x) scale -
    sqnorm (sqeuclidean) or (q . x) scale + coarse (inner product).

    Without `positions`: (Q, P, window), every slot of every probed window
    scored (slots past a count too; the caller masks them). With
    `positions` (Q, k) layout positions: only those, each with the coarse
    term of the probe whose window holds it; positions < 0 or in no window
    read row 0 and are the caller's to skip.
    """
    q, offs, cnts, coarse = _prepare(
        sorted_vectors, sorted_sqnorms, sorted_scales, queries, probe_offsets,
        probe_counts, coarse_ip, window, metric)
    cap, d = sorted_vectors.shape
    scaled = sorted_vectors.dtype == torch.int8
    qd = q.double()
    if positions is None:
        col = torch.arange(window, device=q.device)
        idx = torch.clamp(offs.long()[:, :, None] + col, max=cap - 1)
        x = sorted_vectors[idx].double()  # (Q, P, window, D)
        ip = torch.einsum("qpwd,qd->qpw", x, qd)
        mag = torch.einsum("qpwd,qd->qpw", x.abs(), qd.abs())
        cf = coarse.double()[:, :, None]
    else:
        idx = positions.long().clamp(min=0)
        x = sorted_vectors[idx].double()  # (Q, k, D)
        ip = torch.einsum("qkd,qd->qk", x, qd)
        mag = torch.einsum("qkd,qd->qk", x.abs(), qd.abs())
        live = torch.clamp(cnts.long(), max=window)
        start = offs.long()
        inside = ((idx[:, :, None] >= start[:, None, :])
                  & (idx[:, :, None] < (start + live)[:, None, :]))
        cf = torch.gather(coarse.double(), 1, inside.int().argmax(dim=2))
    scale = sorted_scales[idx].double() if scaled else torch.ones_like(ip)
    aux0 = sorted_sqnorms[idx].double()
    if not scaled:
        cf = torch.zeros_like(ip)
    mult = 2.0 if metric == Metric.SQEUCLIDEAN else 1.0
    term = mult * scale * ip
    if metric == Metric.SQEUCLIDEAN:
        first = term - aux0
        want = first + cf
    else:
        first = term + cf
        want = first - dist_ops.deletion_penalty(aux0)
    u = flat_kernels.FP32_HALF_ULP
    allowed = (mult * scale.abs() * flat_kernels.TRUNCATION_ULPS * d * u * mag
               + u * term.abs() + u * first.abs() + u * want.abs())
    return want, allowed


def ivf_scan(sorted_vectors, sorted_sqnorms, sorted_scales, queries,
             probe_offsets, probe_counts, *, k: int, window: int,
             metric: str, coarse_ip=None):
    """K4: exact top-k (k <= 32) of each query's probed windows. Returns
    ((Q, k) fp32 scores descending, (Q, k) int32 layout positions).

    Replaces cuvs_rag_tpu/ops/pallas_ivf.py ivf_scan_pallas (`_kernel`,
    `_window_scores`). It is bound by reading the probed windows' bytes
    (<= 0.5 GB per batch of 16 at 20 probes of 2,048 x 384 bf16 rows).
    Blocks over (query x probe x piece of the window: `k4_pieces`) put more
    than nprobe blocks on the card even for one query and take the list
    count as their loop bound (no row past it is read; pieces past it exit
    at once). On the ring route (`ivf_route`: rows of a multiple of 16
    bytes) a block streams its rows by 16-byte cp.async copies through K1's
    three-stage ring and two threads a row multiply them with the query in
    fp32 on the CUDA cores; other depths keep the older kernel, 32 rows a
    warp with 2- or 4-byte loads. Each warp keeps a warp-held top-k behind
    a k-th-best threshold; a merge pass reduces the (query, probe, piece)
    partials to (Q, k). Scores stay fp32 sums of exact products (bf16 and
    int8 rows), within `ivf_rounding_bound` of exact arithmetic.
    """
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"k must be in [1, {MAX_KERNEL_K}], got {k}")
    if sorted_vectors.device.type == "cpu":
        return ivf_scan_plain(sorted_vectors, sorted_sqnorms, sorted_scales,
                              queries, probe_offsets, probe_counts, k=k,
                              window=window, metric=metric,
                              coarse_ip=coarse_ip)
    build.require_cuda(sorted_vectors)
    q, offs, cnts, coarse = _prepare(
        sorted_vectors, sorted_sqnorms, sorted_scales, queries, probe_offsets,
        probe_counts, coarse_ip, window, metric)
    dev = sorted_vectors.device
    q_n, p_n = offs.shape
    d = sorted_vectors.shape[1]
    route = ivf_route(sorted_vectors.dtype, d)
    per, n_pieces = k4_pieces(window, route, q_n * p_n,
                              build.sm_count(dev))
    part_s = torch.empty((q_n, p_n * n_pieces, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q_n, p_n * n_pieces, k), dtype=torch.int32,
                         device=dev)
    out_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    args = [q, build.aligned(sorted_vectors.contiguous()),
            sorted_sqnorms, sorted_scales, offs, cnts, coarse]
    args = [t.contiguous() for t in args]  # held until the call returns
    build.launcher(_SOURCE, "ivf_scan_topk", dev, kernel="K4")(
        _COMBO[sorted_vectors.dtype], int(route == "ring"),
        *(t.data_ptr() for t in args), q_n, p_n, d, window,
        int(metric == Metric.SQEUCLIDEAN),
        int(sorted_vectors.dtype == torch.int8), k, per, n_pieces,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr())
    return out_s, out_i


# ------------------------------------------------------------------- K5 ---


def _k5_smem(dim: int, r_planes: int, row_bytes: int = 128) -> int:
    """Shared memory of a K5 ring block at depth `dim`, R planes and rows
    of `row_bytes` (a stage row is min(128, row_bytes) + 16 bytes): the
    fp32 query, the ring and the planes. The most either K5 kernel takes."""
    chunk = min(128, row_bytes)
    return (-(-4 * dim // 128) * 128 + 3 * _K4_TILE * (chunk + 16)
            + r_planes * _K5_CLASSES * 8)


def large_k_config(window: int, dim: int, k: int):
    """(n_sub, r_planes) of K5 on the card, or None when K5 does not take
    this k. A block holds 128 classes of one query whatever the class
    width, so the width is the whole window (n_sub = 1): splitting it, as
    the TPU did to fit its VMEM double buffer, would only raise R. R =
    default_r_planes(k, window) must stay <= MAX_R_PLANES, and a ring
    block's query, ring and planes must fit the 227 KB one block may take
    (`_k5_smem`, 67 KB at window 2,048, D = 384, k = 2,000); that admits
    everything the older kernel's 96 KB of query and planes admitted."""
    if not MAX_KERNEL_K < k <= MAX_LARGE_K or window < 1:
        return None
    r = flat_kernels.default_r_planes(k, window)
    if k > r * window or r > MAX_R_PLANES:
        return None
    if _k5_smem(dim, r) > _K5_SMEM:
        return None
    return 1, r


def k5_plan(n_q: int, window: int, n_sub: int, n_probe: int, r_planes: int,
            d: int, dtype, sm_count: int = 132):
    """(route, tiles a split, splits) of K5 for a call of n_q queries over
    n_probe probes of `window` rows cut into n_sub sub-windows. "ring"
    (`ivf_route`: rows of a multiple of 16 bytes, d <= 2,048): blocks
    (query, 128-class chunk, split of the query's n_probe x n_sub tiles),
    as many splits as still fit the call's blocks in one wave of
    _K5_BLOCKS_PER_SM blocks an SM (one where the planes need it), the
    tiles cut as evenly as whole tiles allow: at one query, window 2,048
    and 20 probes, 16 chunks x 10 splits of 2 probes; at 16 queries, 256
    blocks of all 20. Each chunk of each query is a block whatever the
    counts (a chunk past every count streams nothing). "cores": the older
    kernel, one split. A pure function of its arguments."""
    tiles = n_probe * n_sub
    route = ivf_route(dtype, d)
    if route != "ring":
        return "cores", tiles, 1
    half = build.SM_SMEM // 2 - build.BLOCK_RESERVED
    bps = _K5_BLOCKS_PER_SM if _k5_smem(
        d, r_planes, d * _ELEMENT_BYTES[dtype]) <= half else 1
    blocks = n_q * -(-(window // n_sub) // _K5_CLASSES)
    want = max(1, min(tiles, bps * sm_count // blocks))
    per = -(-tiles // want)
    return "ring", per, -(-tiles // per)


def _large_args(k, window, n_sub, r_planes):
    if not 1 <= k <= MAX_LARGE_K:
        raise ValueError(f"k must be in [1, {MAX_LARGE_K}], got {k}")
    if n_sub < 1 or window % n_sub:
        raise ValueError(f"n_sub={n_sub} must divide window={window}")
    subwin = window // n_sub
    r_planes = r_planes or flat_kernels.default_r_planes(k, subwin)
    if r_planes > MAX_R_PLANES:
        raise ValueError(f"r_planes={r_planes} > {MAX_R_PLANES}")
    if k > r_planes * subwin:
        raise ValueError(f"k={k} > r_planes*subwin={r_planes * subwin}")
    return subwin, r_planes


def ivf_scan_large_plain(sorted_vectors, sorted_sqnorms, sorted_scales,
                         queries, probe_offsets, probe_counts, *, k: int,
                         window: int, metric: str, coarse_ip=None,
                         n_sub: int = 1, r_planes: int = 0,
                         planes: bool = False, n_splits: int = 1):
    """Plain PyTorch version of K5: the same classes (column of the
    sub-window), each class's R best and its (R+1)-th best (`rej`), then
    the top-k and the certificate; with `planes`, the planes (Q, R, subwin)
    scores and positions and rej (Q, subwin) instead. `n_splits` selects
    over that many runs of the (probe, sub-window) tiles and merges them,
    as the card does (`flat_kernels.topr_planes_plain`)."""
    subwin, r_planes = _large_args(k, window, n_sub, r_planes)
    q, offs, cnts, coarse = _prepare(
        sorted_vectors, sorted_sqnorms, sorted_scales, queries, probe_offsets,
        probe_counts, coarse_ip, window, metric)
    s, pos = _window_scores_plain(sorted_vectors, sorted_sqnorms,
                                  sorted_scales, q, offs, cnts, coarse,
                                  window, metric)
    q_n, p_n, _ = s.shape
    # (query, sub-window, class)
    out = flat_kernels.topr_planes_plain(
        s.reshape(q_n, p_n * n_sub, subwin),
        pos.reshape(q_n, p_n * n_sub, subwin), r_planes, n_splits)
    return out if planes else flat_kernels.finish_large(*out, k)


def ivf_scan_large(sorted_vectors, sorted_sqnorms, sorted_scales, queries,
                   probe_offsets, probe_counts, *, k: int, window: int,
                   metric: str, coarse_ip=None, n_sub: int = 1,
                   r_planes: int = 0, planes: bool = False):
    """K5: certified large-k probed scan. Returns ((Q, k) scores descending,
    (Q, k) layout positions, (Q,) certified bool); with `planes`, the
    planes (Q, R, subwin) scores and positions and rej (Q, subwin) that
    they come from. certified[q] PROVES row q is the exact top-k of the
    probed lists (every class kept its R best and the best value it ever
    displaced, and max(rej) < the k-th score); uncertified rows must be
    recomputed by the caller.

    Replaces cuvs_rag_tpu/ops/pallas_ivf.py ivf_scan_pallas_large
    (`_kernel_large`; its VMEM budget `large_k_config` becomes this
    module's shared-memory one). Bound like K4 by the bytes of the probed
    windows. On the card a class is a column of the window, so a 128-class
    chunk of one probe's window is 128 consecutive layout rows: one tile
    of K4's copy ring. The ring route (`k5_plan`) runs blocks over (query x
    128-class chunk x split of the probes), each streaming one tile per
    probe of its split through K4's ring (tiles past a count issue no
    copy) and multiplying as K4 does (two threads a row, fp32 FMAs); each
    class keeps its R best in the block's shared memory behind the ring,
    plane R-1 and rej in registers, and runs the chain only for a score
    that beats plane R-1. The splits fill the card in one wave (16 chunks
    x 10 splits at one query, window 2,048, 20 probes), and K3's merge
    pass folds their planes together, every displaced value into rej.
    Depths the ring does not take keep the older kernel, one block per
    (query, chunk) walking every probe. The final top-k and the
    certificate run in PyTorch, as they ran outside the TPU kernel.
    """
    subwin, r_planes = _large_args(k, window, n_sub, r_planes)
    if sorted_vectors.device.type == "cpu":
        return ivf_scan_large_plain(
            sorted_vectors, sorted_sqnorms, sorted_scales, queries,
            probe_offsets, probe_counts, k=k, window=window, metric=metric,
            coarse_ip=coarse_ip, n_sub=n_sub, r_planes=r_planes,
            planes=planes)
    build.require_cuda(sorted_vectors)
    q, offs, cnts, coarse = _prepare(
        sorted_vectors, sorted_sqnorms, sorted_scales, queries, probe_offsets,
        probe_counts, coarse_ip, window, metric)
    dev = sorted_vectors.device
    q_n, p_n = offs.shape
    d = sorted_vectors.shape[1]
    route, per, n_splits = k5_plan(q_n, window, n_sub, p_n, r_planes, d,
                                   sorted_vectors.dtype,
                                   build.sm_count(dev))
    planes_s = torch.empty((q_n, r_planes, subwin), dtype=torch.float32,
                           device=dev)
    planes_i = torch.empty((q_n, r_planes, subwin), dtype=torch.int32,
                           device=dev)
    rej = torch.empty((q_n, subwin), dtype=torch.float32, device=dev)
    parts = [planes_s, planes_i, rej]  # one split writes the outputs
    if n_splits > 1:
        parts = [torch.empty((n_splits,) + t.shape, dtype=t.dtype, device=dev)
                 for t in parts]
    args = [q, build.aligned(sorted_vectors.contiguous()),
            sorted_sqnorms, sorted_scales, offs, cnts, coarse]
    args = [t.contiguous() for t in args]  # held until the call returns
    build.launcher(_SOURCE, "ivf_scan_topr", dev, kernel="K5")(
        _COMBO[sorted_vectors.dtype], int(route == "ring"),
        *(t.data_ptr() for t in args),
        q_n, p_n, d, window, n_sub,
        int(metric == Metric.SQEUCLIDEAN),
        int(sorted_vectors.dtype == torch.int8), r_planes, per, n_splits,
        *(t.data_ptr() for t in parts),
        planes_s.data_ptr(), planes_i.data_ptr(), rej.data_ptr())
    if planes:
        return planes_s, planes_i, rej
    return flat_kernels.finish_large(planes_s, planes_i, rej, k)
