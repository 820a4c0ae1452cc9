"""The IVF-PQ ADC window-scan kernel, and its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_pq.py`. One wrapper,
`pq_adc_scores` (K6), launches the hand-written CUDA kernel of
`csrc/pq_adc.cu` on a CUDA tensor and runs `pq_adc_scores_plain` on a CPU
tensor — never a fallback from one to the other. It launches through
`kernels/build.launcher` (kernel "K6"), which counts the launches in
`build.launches["pq_adc_scores"]`; a check may hand it `route_counts`,
in which the kernel counts its blocks by route (32-bit or one-byte code
loads) on the card.

Input contract (pq_adc_scores_pallas's, without its 128-alignment asserts):
packed_codes (mb, cap) uint8, stream-major, two nibbles a byte (low nibble
= stream s, high nibble = stream s + mb: ops/pq.pack_nibbles);
sorted_row_ids (cap,) int32, -1 on pads, tombstones and filtered-out rows;
norm_corr (cap,) fp32 or None; luts (Q, P, 2 mb, 16) fp32; probe_offsets
and probe_counts (Q, P) int32 window starts and list lengths; coarse (Q, P)
fp32. A window is [offset, offset + min(count, window)), cut at the end of
the layout.

score[q, p, j] = coarse[q, p] + sum_s luts[q, p, s, nibble_s] - corr[slot]
for live slots; -inf and id -1 where j >= count or row id < 0. The id of a
live slot is its row id, or with `positions=True` its layout position
`slot` (int32: cap < 2^31). The sum runs over the streams in another order
in the kernel, the plain version and the TPU kernel, so scores agree to
rounding (rtol 1e-5 / atol 1e-4); ids and the -inf pattern agree exactly.
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import topk as topk_ops

_SOURCE = "pq_adc.cu"
# The kernel's block plan (csrc/pq_adc.cu): a block scores _MAX_CHUNK
# window slots, four a thread, from the pair's (2 mb, 16) fp32 table in
# shared memory beside its 16-byte barrier.
_MAX_CHUNK = 512
_MAX_MB = (build.MAX_SMEM - 16) // 128  # the most streams whose table fits
_MAX_POSITION = (1 << 31) - 1
# Elements of the gathered (queries, probes, 2 mb, window) block per chunk
# of queries in the plain version: bounds its int64 index at 1 GiB.
_PLAIN_ELEMS = 1 << 27
ROUTES = ("words", "bytes")  # the order of `route_counts`


def adc_plan(mb: int) -> tuple:
    """(chunk, threads, shared bytes) of K6's blocks for mb byte streams:
    chunks of _MAX_CHUNK window slots, four a thread, beside the (2 mb, 16)
    fp32 table and its 16-byte barrier. Raises past _MAX_MB streams, whose
    table does not fit a block."""
    if not 1 <= mb <= _MAX_MB:
        raise ValueError(f"{mb} byte streams: the lookup table does not fit "
                         f"a block's shared memory (1 to {_MAX_MB})")
    return _MAX_CHUNK, _MAX_CHUNK // 4, 128 * mb + 16


def adc_route_blocks(packed_codes, probe_offsets, probe_counts, *,
                     window: int) -> dict:
    """{"words": n, "bytes": m}: the blocks of one K6 call that read their
    codes by each route, as the kernel decides them (a block reads codes
    when its chunk starts inside the list; it takes the words route where
    its first code byte is 4-byte aligned and cap is a multiple of 4). A
    check for tests and the smoke: it reads the offsets on the host."""
    mb, cap = packed_codes.shape
    chunk = adc_plan(mb)[0]
    offs = probe_offsets.reshape(-1).long().cpu()
    live = torch.clamp(probe_counts.reshape(-1).long().cpu(), max=window)
    live = torch.where(offs < 0, torch.zeros_like(live), live)
    live = torch.clamp(torch.minimum(live, cap - offs), min=0)
    j0 = torch.arange(0, window, chunk)
    reads = j0[None, :] < live[:, None]
    start = packed_codes.data_ptr() + offs[:, None] + j0[None, :]
    words = reads & (start % 4 == 0) & (cap % 4 == 0)
    return {"words": int(words.sum()), "bytes": int((reads & ~words).sum())}


def _as(t, dtype):
    """`t` as a contiguous tensor of `dtype`, without a call where it is one."""
    return t if t.dtype == dtype and t.is_contiguous() else \
        t.to(dtype).contiguous()


def _prepare(packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
             probe_counts, coarse, window, positions):
    """Validate (shapes and devices only: nothing here reads the card);
    return (luts, offsets, counts, coarse) as contiguous fp32 / int32.
    Written for the launch path: each check is one cheap attribute read."""
    if packed_codes.ndim != 2 or packed_codes.dtype != torch.uint8:
        raise ValueError("packed_codes must be (mb, cap) uint8")
    mb, cap = packed_codes.shape
    if mb < 1 or cap < 1:
        raise ValueError(f"packed_codes is empty: {tuple(packed_codes.shape)}")
    if sorted_row_ids.shape != (cap,) or sorted_row_ids.dtype != torch.int32:
        raise ValueError(f"sorted_row_ids must be ({cap},) int32")
    if norm_corr is not None and (norm_corr.shape != (cap,)
                                  or norm_corr.dtype != torch.float32):
        raise ValueError(f"norm_corr must be ({cap},) float32 or None")
    if probe_offsets.ndim != 2:
        raise ValueError("probe_offsets must be (Q, P)")
    q_n, p_n = probe_offsets.shape
    if luts.shape != (q_n, p_n, 2 * mb, 16):
        raise ValueError(f"luts must be {(q_n, p_n, 2 * mb, 16)}, got "
                         f"{tuple(luts.shape)}")
    if probe_counts.shape != (q_n, p_n) or coarse.shape != (q_n, p_n):
        raise ValueError(f"probe_counts and coarse must be {(q_n, p_n)}")
    if q_n < 1 or p_n < 1:
        raise ValueError("no (query, probe) pairs")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if positions and cap > _MAX_POSITION:
        raise ValueError(f"positions are int32: a layout of {cap} slots has "
                         f"positions past {_MAX_POSITION}")
    dev = packed_codes.get_device()
    for t in (sorted_row_ids, norm_corr, luts, probe_offsets, probe_counts,
              coarse):
        if t is not None and t.get_device() != dev:
            raise ValueError(f"tensors on {t.device} and "
                             f"{packed_codes.device}")
    return (_as(luts, torch.float32), _as(probe_offsets, torch.int32),
            _as(probe_counts, torch.int32), _as(coarse, torch.float32))


def pq_adc_scores_plain(packed_codes, sorted_row_ids, norm_corr, luts,
                        probe_offsets, probe_counts, coarse, *, window: int,
                        positions: bool = False):
    """Plain PyTorch version of K6: gather each probed window, unpack the
    nibbles, index the tables with torch.gather, sum the streams."""
    luts, offs, cnts, coarse = _prepare(
        packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
        probe_counts, coarse, window, positions)
    mb, cap = packed_codes.shape
    q_n, p_n = offs.shape
    dev = packed_codes.device
    col = torch.arange(window, device=dev)
    out_s, out_i = [], []
    step = max(1, _PLAIN_ELEMS // max(1, p_n * 2 * mb * window))
    for q0 in range(0, q_n, step):
        pos = offs[q0:q0 + step].long()[:, :, None] + col  # (q, P, window)
        slots = torch.clamp(pos, 0, cap - 1)
        win = packed_codes[:, slots].permute(1, 2, 0, 3)  # (q, P, mb, window)
        nib = torch.cat([win & 15, win >> 4], dim=2).long()  # (q, P, 2mb, w)
        s = torch.gather(luts[q0:q0 + step], 3, nib).sum(dim=2) \
            + coarse[q0:q0 + step, :, None]
        if norm_corr is not None:
            s = s - norm_corr[slots]
        ids = sorted_row_ids[slots]
        live = ((col < cnts[q0:q0 + step].long()[:, :, None]) & (ids >= 0)
                & (pos >= 0) & (pos < cap))
        if positions:
            ids = slots.to(torch.int32)
        out_s.append(torch.where(live, s,
                                 torch.full_like(s, topk_ops.NEG_INF)))
        out_i.append(torch.where(live, ids, torch.full_like(ids, -1)))
    return torch.cat(out_s), torch.cat(out_i)


def pq_adc_scores(packed_codes, sorted_row_ids, norm_corr, luts,
                  probe_offsets, probe_counts, coarse, *, window: int,
                  positions: bool = False, route_counts=None):
    """K6: ADC scores of every probed window. Returns ((Q, P, window) fp32
    scores, (Q, P, window) int32 ids: row ids, or layout positions with
    `positions=True`), -inf / -1 on dead slots.

    Replaces cuvs_rag_tpu/ops/pallas_pq.py pq_adc_scores_pallas (`_kernel`).
    By bytes it is a few microseconds (mb code bytes + 8 B of id and
    correction once per live slot of the probed windows, the tables once,
    8 B of output per window slot at 16 queries x 20 probes). Blocks over (query x probe x chunk of
    `adc_plan` slots) take the pair's table into shared memory by one TMA
    bulk copy, and each thread scores four slots from one 32-bit load a
    stream (the kernel's "words" route; where a chunk's codes or cap are
    not 4-byte aligned, one-byte loads: its "bytes" route, chosen by each
    block on the card); the 2 mb table lookups a slot are what remains on
    its load/store pipe. The list count is the loop bound: a chunk past it
    writes -inf / -1 and reads nothing. Any mb up to _MAX_MB, window and
    cap; no host synchronization. `route_counts`, for checks only: a (2,)
    int64 tensor on the codes' card to which each block that reads codes
    adds one at its route (ROUTES order); searches pass none, and their
    blocks count nothing.
    """
    if packed_codes.device.type == "cpu":
        return pq_adc_scores_plain(
            packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
            probe_counts, coarse, window=window, positions=positions)
    build.require_cuda(packed_codes)
    luts, offs, cnts, coarse = _prepare(
        packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
        probe_counts, coarse, window, positions)
    mb, cap = packed_codes.shape
    chunk = adc_plan(mb)[0]
    dev = packed_codes.device
    q_n, p_n = offs.shape
    out_s = torch.empty((q_n, p_n, window), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, p_n, window), dtype=torch.int32, device=dev)
    # held until the call returns; the table is bulk-copied from a 16-byte
    # aligned start
    codes = packed_codes.contiguous()
    rids = sorted_row_ids.contiguous()
    corr = None if norm_corr is None else norm_corr.contiguous()
    if luts.data_ptr() % 16:
        luts = luts.clone()
    if route_counts is not None and (
            route_counts.dtype != torch.int64 or route_counts.numel() != 2
            or route_counts.get_device() != dev.index
            or not route_counts.is_contiguous()):
        raise ValueError("route_counts must be a contiguous (2,) int64 "
                         f"tensor on {dev}")
    build.launcher(_SOURCE, "pq_adc_scores", dev, kernel="K6")(
        codes.data_ptr(), rids.data_ptr(),
        None if corr is None else corr.data_ptr(), luts.data_ptr(),
        offs.data_ptr(), cnts.data_ptr(), coarse.data_ptr(),
        q_n * p_n, mb, cap, window, chunk, int(positions),
        out_s.data_ptr(), out_i.data_ptr(),
        None if route_counts is None else route_counts.data_ptr())
    return out_s, out_i
