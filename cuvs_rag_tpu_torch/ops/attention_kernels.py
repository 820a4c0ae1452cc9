"""Causal flash attention with a pad mask (K7), and its plain PyTorch version.

The counterpart of the Pallas TPU `flash_attention` that the JAX package's
Qwen3 encoder calls (`models/flax_qwen.py:157`). One wrapper,
`flash_attention`, launches the hand-written CUDA kernel of
`csrc/flash_attn.cu` on a CUDA tensor and runs `flash_attention_plain` on a
CPU tensor — never a fallback from one to the other. It counts its kernel
launches in `flash_attention.launches`.

Contract: q (B, S, nh, hd) and k, v (B, S, nkv, hd), the projections' own
layout (query head h reads kv head h // (nh // nkv): no GQA repeat, no
transposes); mask (B, S) integers, the attention mask used as segment ids.
Query i attends key j iff j <= i and mask[b, i] == mask[b, j] — the TPU
kernel's segment rule, at pad rows too, so kernel, plain version and the
JAX reference agree on the whole tensor. Every row allows j = i, so the
softmax denominator is never 0 and no output is NaN. Output (B, S, nh, hd)
in q's dtype. Scores, softmax and the accumulator are fp32; the plain
version casts the probabilities to v's dtype before P.V (the dense branch
of `flax_qwen.py:168-176`), the kernel keeps them fp32. fp32 outputs agree
to rtol 1e-4 / atol 1e-5 (another summation order, a fast exp). On bf16
inputs that cast alone moves the plain version's output by up to 4e-3, so
the kernel is held to the plain version of the same values in fp32, where
only its output's one rounding separates them: rtol 2^-8 (half a bf16
step) / atol 2e-5, measured on an H100 (700 W) at 1 x 8192 and 16 x 512
tokens with chip_smoke.py.
"""

from __future__ import annotations

import torch

_SOURCE = "flash_attn.cu"
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
# Rows of queries per chunk of the plain version: its fp32 score block is
# (B, nh, chunk, S), 268 MB for one 8192-token sequence of 16 heads.
_PLAIN_CHUNK = 512


def _prepare(q, k, v, mask):
    """Validate; return the mask as a contiguous (B, S) int32 tensor."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, S, nh, hd) and k, v (B, S, nkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, nh, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    nkv = k.shape[2]
    if b < 1 or s < 1 or nkv < 1 or nh % nkv != 0:
        raise ValueError(f"{nh} query heads over {nkv} kv heads, B={b}, S={s}")
    if mask.shape != (b, s) or mask.is_floating_point():
        raise ValueError(f"mask must be ({b}, {s}) integers or bools")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    return mask.to(torch.int32).contiguous()


def _aligned(t):
    """Contiguous, and starting on 16 bytes (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_plain(q, k, v, mask, sm_scale: float):
    """Plain PyTorch version of K7: masked fp32 scores and softmax, the
    probabilities cast to v's dtype, then P.V; in chunks of query rows, each
    against the keys up to its last row, so S = 8192 never materializes the
    (B, nh, S, S) score block."""
    seg = _prepare(q, k, v, mask)
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    kf = k.float()
    pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, s, _PLAIN_CHUNK):
        i1 = min(s, i0 + _PLAIN_CHUNK)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, i0:i1].float(),
                              kf[:, :i1]) * sm_scale
        ok = (pos[:i1][None, :] <= pos[i0:i1, None])[None] \
            & (seg[:, i0:i1, None] == seg[:, None, :i1])  # (B, q, k)
        scores = scores.masked_fill(~ok[:, None, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out[:, i0:i1] = torch.einsum("bgrqk,bkgd->bqgrd", probs,
                                     v[:, :i1]).reshape(b, i1 - i0, nh, hd)
    return out


def flash_attention(q, k, v, mask, sm_scale: float):
    """K7: causal attention under a segment-id pad mask, (B, S, nh, hd) out.

    Replaces the bundled Pallas TPU flash_attention called at
    cuvs_rag_tpu/models/flax_qwen.py:157. It is bound by operations (one
    layer at S = 8192, 16 heads, hd = 128 is 0.275 TFLOP against 0.10 GB).
    Blocks over (64-row query tile x head x batch) loop over 64-key tiles up
    to their own causal limit with Q, K and V tiles in shared memory and m,
    l and O in registers; the products run on the CUDA cores in fp32. Any S;
    bf16 or fp32; hd 64 or 128. Anything else on a CUDA tensor raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {q.device}")
    seg = _prepare(q, k, v, mask)
    b, s, nh, hd = q.shape
    if hd not in _HEAD_DIMS or q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS} and "
                         f"bfloat16 or float32, got {hd} and {q.dtype}")
    from cuvs_rag_tpu_torch.kernels import build

    q, k, v = _aligned(q), _aligned(k), _aligned(v)  # held until the return
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load(_SOURCE).flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), b, s, nh, k.shape[2], hd,
            int(q.dtype == torch.bfloat16), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
