"""The IVF-PQ ADC window-scan kernel, and its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_pq.py`. One wrapper,
`pq_adc_scores` (K6), launches the hand-written CUDA kernel of
`csrc/pq_adc.cu` on a CUDA tensor and runs `pq_adc_scores_plain` on a CPU
tensor — never a fallback from one to the other. It counts its kernel
launches in `pq_adc_scores.launches`.

Input contract (pq_adc_scores_pallas's, without its 128-alignment asserts):
packed_codes (mb, cap) uint8, stream-major, two nibbles a byte (low nibble
= stream s, high nibble = stream s + mb: ops/pq.pack_nibbles);
sorted_row_ids (cap,) int32, -1 on pads, tombstones and filtered-out rows;
norm_corr (cap,) fp32 or None; luts (Q, P, 2 mb, 16) fp32; probe_offsets
and probe_counts (Q, P) int32 window starts and list lengths; coarse (Q, P)
fp32. A window is [offset, offset + min(count, window)), cut at the end of
the layout.

score[q, p, j] = coarse[q, p] + sum_s luts[q, p, s, nibble_s] - corr[slot]
for live slots; -inf and id -1 where j >= count or row id < 0. The sum runs
over the streams in another order in the kernel, the plain version and the
TPU kernel, so scores agree to rounding (rtol 1e-5 / atol 1e-4); ids and
the -inf pattern agree exactly.
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.ops import topk as topk_ops

_SOURCE = "pq_adc.cu"
_MAX_MB = 227 * 1024 // 128  # the (2 mb, 16) fp32 table must fit a block
# Elements of the gathered (queries, probes, 2 mb, window) block per chunk
# of queries in the plain version: bounds its int64 index at 1 GiB.
_PLAIN_ELEMS = 1 << 27


def _prepare(packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
             probe_counts, coarse, window):
    """Validate; return (luts, offsets, counts, coarse) as contiguous fp32 /
    int32 tensors."""
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
    for t in (sorted_row_ids, norm_corr, luts, probe_offsets, probe_counts,
              coarse):
        if t is not None and t.device != packed_codes.device:
            raise ValueError(f"tensors on {t.device} and "
                             f"{packed_codes.device}")
    return (luts.to(torch.float32).contiguous(),
            probe_offsets.to(torch.int32).contiguous(),
            probe_counts.to(torch.int32).contiguous(),
            coarse.to(torch.float32).contiguous())


def pq_adc_scores_plain(packed_codes, sorted_row_ids, norm_corr, luts,
                        probe_offsets, probe_counts, coarse, *, window: int):
    """Plain PyTorch version of K6: gather each probed window, unpack the
    nibbles, index the tables with torch.gather, sum the streams."""
    luts, offs, cnts, coarse = _prepare(
        packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
        probe_counts, coarse, window)
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
        out_s.append(torch.where(live, s,
                                 torch.full_like(s, topk_ops.NEG_INF)))
        out_i.append(torch.where(live, ids, torch.full_like(ids, -1)))
    return torch.cat(out_s), torch.cat(out_i)


def pq_adc_scores(packed_codes, sorted_row_ids, norm_corr, luts,
                  probe_offsets, probe_counts, coarse, *, window: int):
    """K6: ADC scores of every probed window. Returns ((Q, P, window) fp32
    scores, (Q, P, window) int32 row ids), -inf / -1 on dead slots.

    Replaces cuvs_rag_tpu/ops/pallas_pq.py pq_adc_scores_pallas (`_kernel`).
    By bytes it is a few microseconds (mb code bytes + 8 B of id and
    correction per live slot, the tables once, 8 B of output per window
    slot at 16 queries x 20 probes); on the device it takes 16-17 us, the
    issue of its mb byte loads and 2 mb table lookups a slot
    (eval/k6_ablation.py), and the launch and this wrapper's host work are
    what a caller sees. Blocks
    over (query x probe x 512-slot chunk) hold the pair's table in shared
    memory, one thread scores one slot with coalesced byte loads along the
    contiguous slot axis, and the list count is the loop bound: a chunk past
    it writes -inf / -1 and reads nothing. Any mb, window and cap.
    """
    if packed_codes.device.type == "cpu":
        return pq_adc_scores_plain(
            packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
            probe_counts, coarse, window=window)
    if packed_codes.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {packed_codes.device}")
    luts, offs, cnts, coarse = _prepare(
        packed_codes, sorted_row_ids, norm_corr, luts, probe_offsets,
        probe_counts, coarse, window)
    mb, cap = packed_codes.shape
    if mb > _MAX_MB:
        raise ValueError(f"{mb} byte streams: the lookup table does not fit "
                         f"a block's shared memory (at most {_MAX_MB})")
    from cuvs_rag_tpu_torch.kernels import build

    dev = packed_codes.device
    q_n, p_n = offs.shape
    out_s = torch.empty((q_n, p_n, window), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, p_n, window), dtype=torch.int32, device=dev)
    # held until the call returns
    codes = packed_codes.contiguous()
    rids = sorted_row_ids.contiguous()
    corr = None if norm_corr is None else norm_corr.contiguous()
    with build.device_guard(dev):
        err = build.load(_SOURCE).pq_adc_scores(
            codes.data_ptr(), rids.data_ptr(),
            None if corr is None else corr.data_ptr(), luts.data_ptr(),
            offs.data_ptr(), cnts.data_ptr(), coarse.data_ptr(),
            q_n * p_n, mb, cap, window, out_s.data_ptr(), out_i.data_ptr(),
            build.raw_stream(dev),
        )
    build.check(err, "pq_adc_scores")
    pq_adc_scores.launches += 1
    return out_s, out_i


pq_adc_scores.launches = 0
