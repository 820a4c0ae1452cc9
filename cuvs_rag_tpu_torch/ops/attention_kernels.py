"""Causal flash attention with a pad mask (K7), and its plain PyTorch version.

The counterpart of the Pallas TPU `flash_attention` that the JAX package's
Qwen3 encoder calls (`models/flax_qwen.py:157`). One wrapper,
`flash_attention`, launches the hand-written CUDA kernels of
`csrc/flash_attn.cu` on a CUDA tensor (bf16: the tensor-core kernel, both
products as `wgmma`; fp32: the CUDA-core kernel, fp32 math throughout) and runs `flash_attention_plain`
on a CPU tensor — never a fallback from one to the other. It launches
through `kernels/build.launcher` (kernel "K7"), which counts the launches
in `build.launches["flash_attention"]`.

Contract: q (B, S, nh, hd) and k, v (B, S, nkv, hd), the projections' own
layout (query head h reads kv head h // (nh // nkv): no GQA repeat, no
transposes); mask (B, S) integers, the attention mask used as segment ids.
Query i attends key j iff j <= i and mask[b, i] == mask[b, j] — the TPU
kernel's segment rule, at pad rows too, so kernel, plain version and the
JAX reference agree on the whole tensor. Every row allows j = i, so the
softmax denominator is never 0 and no output is NaN. Output (B, S, nh, hd)
in q's dtype. Scores, softmax and the accumulator are fp32; the
probabilities are cast to v's dtype before P.V while the denominator sums
them in fp32: in the plain version (the dense branch of
`flax_qwen.py:168-176`), in the bf16 kernel and in the TPU kernel alike.

Tolerances. fp32: rtol 1e-4 / atol 1e-5 against the plain version (another
summation order, a fast exp). bf16: the scores are exact products summed in
fp32, so what separates the kernel from the plain version of the same
values in fp32 is one rounding of each probability (2^-9 of it) and one of
the output; `attention_rounding_bound` gives that reference and the
elementwise error those two roundings allow, with a factor 2 to spare.
"""

from __future__ import annotations

import torch

from cuvs_rag_tpu_torch.kernels import build

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


def attention_rounding_bound(q, k, v, mask, sm_scale: float):
    """(want, bound): the plain attention of the same values in fp32, and
    the elementwise error that bf16 attention may show against it,

        bound = 2^-8 * A + 2^-8 * |want| + 2e-5,   A = softmax(scores) . |v|

    A is the same attention run on `v.abs()`: rounding each probability to
    bf16 (2^-9 of it) moves an output by at most 2^-9 * A, rounding the
    output by 2^-9 of it; the bound allows twice both, and 2e-5 for the
    order of the fp32 sums. Where a row is nearly one-hot, or every
    probability is exactly representable, A = |want| or the first term
    vanishes and the bound is as tight as the output's own rounding.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_attention_plain(qf, kf, vf, mask, sm_scale)
    spread = flash_attention_plain(qf, kf, vf.abs(), mask, sm_scale)
    return want, 2.0 ** -8 * (spread + want.abs()) + 2e-5


def flash_attention(q, k, v, mask, sm_scale: float):
    """K7: causal attention under a segment-id pad mask, (B, S, nh, hd) out.

    Replaces the bundled Pallas TPU flash_attention called at
    cuvs_rag_tpu/models/flax_qwen.py:157. It is bound by operations (one
    layer at S = 8192, 16 heads, hd = 128 is 0.263 TFLOP against 0.10 GB).
    What stands beside the products is the softmax: S^2 / 2 exponentials a
    head on a unit that does 16 a clock and SM. bf16: both products are
    warpgroup multiplies (`wgmma`, fp32 sums) from 128-byte-swizzled bf16
    tiles in shared memory; P stays in registers, rounded to bf16 before
    P.V; a block of two warpgroups serves the query heads of one kv group,
    so each 128-key K/V tile is loaded once for them, by `cp.async` into a
    three-stage ring while the tile before multiplies; the warpgroups run
    half an iteration apart, one's softmax under the other's products;
    blocks loop to their own causal limit, longest first. fp32: the same
    loop on the CUDA cores in fp32, one head and 64 keys a block. Any S; hd
    64 or 128; any nh % nkv == 0.
    sm_scale must be positive (the kernel takes a row's largest score from
    its largest product). Anything else on a CUDA tensor raises.
    """
    if not sm_scale > 0:
        raise ValueError(f"sm_scale must be positive, got {sm_scale}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, sm_scale)
    build.require_cuda(q)
    seg = _prepare(q, k, v, mask)
    b, s, nh, hd = q.shape
    if hd not in _HEAD_DIMS or q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS} and "
                         f"bfloat16 or float32, got {hd} and {q.dtype}")
    # contiguous and 16-byte aligned (the kernel's vector loads), held
    # until the return
    q, k, v = (build.aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    build.launcher(_SOURCE, "flash_attention", q.device, kernel="K7")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), b, s, nh, k.shape[2], hd,
        int(q.dtype == torch.bfloat16), float(sm_scale))
    return out
