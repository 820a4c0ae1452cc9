"""K7's plain PyTorch version against the JAX package's references of its
flash-attention kernel, on the CPU.

`flash_attention_plain` is held, on the whole tensor (pad rows included), to
`mha_reference` of jax.experimental.pallas.ops.tpu.flash_attention — the
CPU reference of the very kernel `flax_qwen.py:157` calls, with the same
segment ids and causal flag — and, at non-pad rows, to the dense branch of
`flax_qwen.py:168-176`. Tolerance: fp32 rtol / atol 1e-5 (the same masked
softmax with sums taken in another order).

`attention_rounding_bound` (the fp32 reference and the error that one
rounding of P and one of the output allow, which the card's bf16 kernel is
held to) is held to the same `mha_reference`; the bf16 plain version and a
numpy emulation of the kernel's order of operations must fall within the
bound, and three wrong kernels must not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as fa

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(kind, b, s):
    """Ragged pad masks; row 0 keeps a single token where it is padded."""
    mask = np.ones((b, s), np.int32)
    lens = np.linspace(1, s, b).astype(int)
    for i, n in enumerate(lens):
        if kind == "right":
            mask[i, n:] = 0
        elif kind == "left":
            mask[i, :s - n] = 0
        elif kind == "mixed":  # pads on both sides of the text
            lo = (s - n) // 2
            mask[i, :lo] = 0
            mask[i, lo + n:] = 0
    return mask


def _inputs(b, s, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            rng.standard_normal((b, s, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, s, nkv, hd)).astype(np.float32))


def _plain(q, k, v, mask, scale, dtype=torch.float32):
    out = ak.flash_attention_plain(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(mask), scale)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _mha_reference(q, k, v, mask, scale):
    """The TPU kernel's own CPU reference, fed as flax_qwen feeds the
    kernel: GQA heads repeated, (B, H, S, hd), the mask as segment ids."""
    rep = q.shape[2] // k.shape[2]
    heads_first = [jnp.moveaxis(jnp.asarray(np.repeat(t, r, axis=2)), 2, 1)
                   for t, r in ((q, 1), (k, rep), (v, rep))]
    seg = jnp.asarray(mask, jnp.int32)
    with jax.default_matmul_precision("highest"):
        out = fa.mha_reference(*heads_first, None, fa.SegmentIds(seg, seg),
                               causal=True, sm_scale=scale)
    return np.moveaxis(np.asarray(out), 1, 2)


@pytest.mark.parametrize("padding", ["none", "right", "left", "mixed"])
@pytest.mark.parametrize("nh,nkv,hd,s", [(4, 2, 16, 37), (4, 4, 8, 50),
                                         (6, 2, 32, 64)])
def test_plain_matches_mha_reference_whole_tensor(padding, nh, nkv, hd, s):
    """GQA and MHA, S no multiple of any tile, every padding layout; pad
    rows included (they attend pad keys, the segment rule)."""
    q, k, v = _inputs(4, s, nh, nkv, hd)
    mask = _mask(padding, 4, s)
    scale = float(1.0 / np.sqrt(hd))
    got = _plain(q, k, v, mask, scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _mha_reference(q, k, v, mask, scale),
                               **TOL)


@pytest.mark.parametrize("padding", ["right", "left", "mixed"])
def test_plain_matches_flax_dense_branch_at_non_pad_rows(padding):
    """The dense branch of flax_qwen._QwenBlock (causal & key-pad mask,
    -1e30 fill, fp32 softmax), written out with the same jnp calls."""
    b, s, nh, nkv, hd = 3, 21, 4, 2, 16
    q, k, v = _inputs(b, s, nh, nkv, hd, seed=1)
    mask = _mask(padding, b, s)
    scale = float(1.0 / np.sqrt(hd))
    jq, jk, jv = (jnp.asarray(t) for t in (q, np.repeat(k, 2, axis=2),
                                           np.repeat(v, 2, axis=2)))
    with jax.default_matmul_precision("highest"):
        scores = jnp.einsum("bqhd,bkhd->bhqk", jq, jk,
                            preferred_element_type=jnp.float32) / np.sqrt(hd)
        causal = jnp.tril(jnp.ones((s, s), bool))
        valid = causal[None, None] & jnp.asarray(mask)[:, None, None, :].astype(bool)
        probs = jax.nn.softmax(jnp.where(valid, scores, -1e30), axis=-1)
        want = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", probs, jv))
    got = _plain(q, k, v, mask, scale)
    sel = mask.astype(bool)
    np.testing.assert_allclose(got[sel], want[sel], **TOL)


def test_chunks_of_query_rows_change_nothing(monkeypatch):
    """The plain version walks the query rows in chunks against the keys up
    to each chunk's end: any chunk length gives the one-block result."""
    q, k, v = _inputs(2, 45, 4, 2, 16, seed=2)
    mask = _mask("left", 2, 45)
    whole = _plain(q, k, v, mask, 0.25)
    monkeypatch.setattr(ak, "_PLAIN_CHUNK", 7)
    np.testing.assert_allclose(_plain(q, k, v, mask, 0.25), whole,
                               rtol=1e-6, atol=1e-6)


def test_left_padding_never_divides_by_zero():
    """Every row allows key j = i, so no row's denominator is 0: a real row
    behind 40 pads, and the pad rows themselves, come out finite; a real
    row's output ignores what the pads hold."""
    q, k, v = _inputs(1, 48, 2, 1, 16, seed=3)
    mask = np.zeros((1, 48), np.int32)
    mask[0, 40:] = 1
    got = _plain(q, k, v, mask, 0.25)
    assert np.isfinite(got).all()
    k2, v2 = k.copy(), v.copy()
    k2[0, :40], v2[0, :40] = 9.0, -7.0
    np.testing.assert_array_equal(_plain(q, k2, v2, mask, 0.25)[0, 40:],
                                  got[0, 40:])
    # the first real token attends itself alone
    np.testing.assert_allclose(got[0, 40], np.repeat(v[0, 40], 2, axis=0),
                               **TOL)


def test_bf16_inputs_keep_their_dtype():
    """bf16 in, bf16 out, fp32 scores inside: within two bf16 steps of the
    fp32 result at unit scale (the tolerance the card's kernel is held to)."""
    q, k, v = _inputs(2, 33, 4, 2, 16, seed=4)
    mask = _mask("right", 2, 33)
    rounded = [torch.from_numpy(t).to(torch.bfloat16).float().numpy()
               for t in (q, k, v)]
    got = _plain(q, k, v, mask, 0.25, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, _plain(*rounded, mask, 0.25),
                               rtol=1.6e-2, atol=1.6e-2)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 9, 2, 2, 8))
    mask = torch.ones((1, 9), dtype=torch.long)
    before = build.launches["flash_attention"]
    got = ak.flash_attention(q, k, v, mask, 0.3)
    assert build.launches["flash_attention"] == before  # no kernel on the CPU
    assert torch.equal(got, ak.flash_attention_plain(q, k, v, mask, 0.3))


@pytest.mark.parametrize("bad", ["heads", "mask_shape", "mask_float", "dtype",
                                 "kv_shape"])
def test_inputs_are_validated(bad):
    q, k, v = (torch.from_numpy(t) for t in _inputs(2, 9, 4, 2, 8))
    mask = torch.ones((2, 9), dtype=torch.int32)
    if bad == "heads":
        q = q[:, :, :3]
    elif bad == "mask_shape":
        mask = mask[:, :8]
    elif bad == "mask_float":
        mask = mask.float()
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "kv_shape":
        v = v[:, :8]
    with pytest.raises(ValueError):
        ak.flash_attention(q, k, v, mask, 0.3)


# ------------------------------------------- the bf16 kernel's tolerance ---

TILE = 128  # keys a tile of the card's kernel


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _round(a):
    return _bf16(a).float().numpy()


def _emulate_kernel(q, k, v, mask, scale, key_shift=0, swap_kv_heads=False,
                    causal_offset=0):
    """The bf16 kernel's order of operations in numpy, on fp32 copies of
    bf16 values: 128-key tiles up to the causal limit, fp32 scores, a running
    max in the log2 domain, p rounded to bf16 before P.V, l summed from the
    fp32 p, the output rounded to bf16 once. The three knobs each plant one
    fault: scores taken against the keys one row further, a query head
    reading the other kv head of its pair, a causal limit one key late."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    rep = nh // nkv
    scale_log2 = np.float32(scale * 1.4426950408889634)
    out = np.zeros_like(q)
    pos = np.arange(s)
    for bi in range(b):
        for h in range(nh):
            g = h // rep
            if swap_kv_heads:
                g ^= 1
            ks = np.roll(k[bi, :, g], -key_shift, axis=0)
            m = np.full(s, -np.inf, np.float32)
            l = np.zeros(s, np.float32)
            o = np.zeros((s, hd), np.float32)
            for j0 in range(0, s, TILE):
                j1 = min(s, j0 + TILE)
                sc = (q[bi, :, h] @ ks[j0:j1].T).astype(np.float32)
                ok = (pos[None, j0:j1] <= pos[:, None] + causal_offset) \
                    & (mask[bi][None, j0:j1] == mask[bi][:, None])
                sc = np.where(ok, sc, -np.inf)
                m_new = np.maximum(m, sc.max(axis=1) * scale_log2)
                m_safe = np.where(np.isinf(m_new), np.float32(0), m_new)
                alpha = np.exp2(m - m_safe)
                p = np.exp2(sc * scale_log2 - m_safe[:, None]).astype(np.float32)
                l = l * alpha + p.sum(axis=1, dtype=np.float32)
                o = o * alpha[:, None] + _round(p) @ v[bi, j0:j1, g]
                m = m_new
            out[bi, :, h] = o / l[:, None]
    return _round(out)


def _bound_case(padding, seed=5, s=300, q_zero=False, scale=0.25):
    """bf16-rounded inputs at S no multiple of the tile, the fp32 reference
    and the allowed error."""
    b, nh, nkv, hd = 3, 4, 2, 16
    q, k, v = (_round(t) for t in _inputs(b, s, nh, nkv, hd, seed=seed))
    if q_zero:
        q = np.zeros_like(q)
    mask = _mask(padding, b, s)
    want, bound = ak.attention_rounding_bound(
        _bf16(q), _bf16(k), _bf16(v), torch.from_numpy(mask), scale)
    return (q, k, v, mask, scale), want.numpy(), bound.numpy()


@pytest.mark.parametrize("padding", ["none", "right", "left", "mixed"])
@pytest.mark.parametrize("nh,nkv,hd,s", [(4, 2, 16, 37), (6, 2, 32, 64)])
def test_bound_reference_matches_mha_reference(padding, nh, nkv, hd, s):
    """`want` of attention_rounding_bound is the TPU kernel's own reference
    on the same (bf16-rounded) values in fp32, pad rows included."""
    q, k, v = (_round(t) for t in _inputs(4, s, nh, nkv, hd, seed=6))
    mask = _mask(padding, 4, s)
    scale = float(1.0 / np.sqrt(hd))
    want, bound = ak.attention_rounding_bound(
        _bf16(q), _bf16(k), _bf16(v), torch.from_numpy(mask), scale)
    assert want.dtype == torch.float32 and bound.shape == want.shape
    np.testing.assert_allclose(want.numpy(),
                               _mha_reference(q, k, v, mask, scale), **TOL)
    # the allowed error: never below 2e-5, and two roundings of an output
    # of this size at most
    assert float(bound.min()) >= 2e-5
    assert float((bound - 2e-5 - 2.0 ** -8 * want.abs()).min()) >= 0


@pytest.mark.parametrize("padding", ["none", "right", "left", "mixed"])
@pytest.mark.parametrize("impl", ["plain_bf16", "kernel_order"])
def test_bf16_attention_falls_within_the_rounding_bound(padding, impl):
    """What rounds P to bf16 and the output once stays within the bound:
    the bf16 plain version, and the kernel's tiled online softmax."""
    (q, k, v, mask, scale), want, bound = _bound_case(padding)
    if impl == "plain_bf16":
        got = _plain(q, k, v, mask, scale, dtype=torch.bfloat16)
    else:
        got = _emulate_kernel(q, k, v, mask, scale)
    assert np.isfinite(got).all()
    ratio = np.abs(got - want) / bound
    assert ratio.max() <= 1.0
    # and the bound is no free pass: the error uses a fair part of it
    assert ratio.max() >= 0.05


@pytest.mark.parametrize("padding", ["right", "left", "mixed"])
def test_q_zero_leaves_only_the_outputs_rounding(padding):
    """q = 0: every p is exactly 1, the output is the mean of the allowed v
    rows, and the kernel's order of operations is within rtol 2^-8 / atol
    2e-5 of the fp32 reference (the case that pins masks, causal limits,
    head mapping and l across tiles on the card)."""
    (q, k, v, mask, scale), want, _ = _bound_case(padding, q_zero=True)
    got = _emulate_kernel(q, k, v, mask, scale)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=2e-5)


@pytest.mark.parametrize("fault,check", [
    ("key_shift", "bound"), ("swap_kv_heads", "bound"),
    ("swap_kv_heads", "q_zero"), ("causal_offset", "bound"),
    ("causal_offset", "q_zero"),
])
def test_a_wrong_kernel_breaks_the_bound(fault, check):
    """Keys shifted by one row, a kv head swapped within a GQA pair, and a
    causal limit off by one each leave the rounding bound (q = 0 cannot see
    the keys, so the shift is held by the bound alone)."""
    (q, k, v, mask, scale), want, bound = _bound_case(
        "right", q_zero=check == "q_zero")
    knob = {"key_shift": dict(key_shift=1),
            "swap_kv_heads": dict(swap_kv_heads=True),
            "causal_offset": dict(causal_offset=1)}[fault]
    err = np.abs(_emulate_kernel(q, k, v, mask, scale, **knob) - want)
    allowed = bound if check == "bound" \
        else 2e-5 + 2.0 ** -8 * np.abs(want)
    assert (err / allowed).max() > 1.0


def test_sharpened_scores_make_the_bound_the_outputs_rounding():
    """Scores sharpened 64-fold: rows are nearly one-hot, so A = |want| and
    the bound is within a hair of twice the output's rounding."""
    (q, k, v, mask, scale), want, bound = _bound_case("right", scale=16.0)
    tight = 2e-5 + 2.0 ** -7 * np.abs(want)
    assert np.median(bound / tight) < 1.01
    got = _emulate_kernel(q, k, v, mask, scale)
    assert (np.abs(got - want) / bound).max() <= 1.0


def test_non_positive_scale_is_refused():
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 9, 2, 2, 8))
    mask = torch.ones((1, 9), dtype=torch.int32)
    for scale in (0.0, -0.3, float("nan")):
        with pytest.raises(ValueError, match="positive"):
            ak.flash_attention(q, k, v, mask, scale)
