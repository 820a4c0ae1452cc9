"""The port's product-quantization ops (ops/pq.py, the batched k-means of
ops/kmeans.py) against the JAX package's on the same numpy inputs.

Tolerance: with fixed codebooks both sides take exact fp32 products of the
same operands, summed in another order: tables, corrections, scores and
reconstructions agree to rtol 1e-5 / atol 1e-4, and codes (an argmin, the
first on ties in both) are bit-equal. Trained codebooks differ by RNG
(torch.Generator vs jax.random), so they are held by quantization error:
within 5% of the JAX package's on the same data.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.ops import pq as jpq
from cuvs_rag_tpu_torch.ops import kmeans as tkm
from cuvs_rag_tpu_torch.ops import pq as tpq
from torch_parity import compare_topk, to_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, D, M = 1500, 32, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((12, D)).astype(np.float32)
    x = (cent[rng.integers(0, 12, N)]
         + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    cb = rng.standard_normal((M, 16, D // M)).astype(np.float32)
    cb256 = rng.standard_normal((M, 256, D // M)).astype(np.float32)
    cb2 = (0.5 * rng.standard_normal((2 * M, 16, D // M))).astype(np.float32)
    return x, cb, cb256, cb2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("which", ["nibble", "byte"])
def test_encode_and_reconstruct_match(data, which):
    x, cb, cb256, _ = data
    cb = cb if which == "nibble" else cb256
    want = np.asarray(jpq.encode(jnp.asarray(x), jnp.asarray(cb)))
    got = tpq.encode(_t(x), _t(cb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        tpq.reconstruct(got, _t(cb)).numpy(),
        np.asarray(jpq.reconstruct(jnp.asarray(want), jnp.asarray(cb))), **TOL)
    subs = tpq.split_subspaces(_t(x), M)
    np.testing.assert_array_equal(
        subs.numpy(), np.asarray(jpq.split_subspaces(jnp.asarray(x), M)))
    with pytest.raises(ValueError, match="multiple"):
        tpq.split_subspaces(_t(x), 5)


def test_two_level_encode_and_norm_correction_match(data):
    x, _, _, cb2 = data
    want = np.asarray(jpq.encode_two_level(jnp.asarray(x), jnp.asarray(cb2)))
    got = tpq.encode_two_level(_t(x), _t(cb2))
    assert got.shape == (N, 2 * M) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # a row chunk that does not divide N gives the same codes
    subs = tpq.split_subspaces(_t(x), M)
    c1, c2 = tpq._joint_encode_subs(subs, _t(cb2[:M]), _t(cb2[M:]), chunk=333)
    np.testing.assert_array_equal(
        torch.cat([c1.T, c2.T], dim=1).numpy(), want)
    corr = tpq.norm_correction(got, _t(cb2), chunk=400)
    np.testing.assert_allclose(
        corr.numpy(),
        np.asarray(jpq.norm_correction(jnp.asarray(want), jnp.asarray(cb2))),
        **TOL)
    # the algebra the correction exists for: Σ LUT − corr = 2 t·r̂ − ||r̂||²
    rec = tpq.reconstruct(got[:, :M], _t(cb2[:M])) \
        + tpq.reconstruct(got[:, M:], _t(cb2[M:]))
    t = _t(x[:5])
    lut = tpq.adc_lut(t, _t(cb2), "sqeuclidean", levels=2)  # (5, 2M, 16)
    for qi in range(5):
        s = torch.stack([tpq.adc_scan_codes(lut[qi], got[r:r + 1])[0]
                         for r in range(20)]) - corr[:20]
        want_s = 2.0 * rec[:20] @ t[qi] - (rec[:20] ** 2).sum(1)
        torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_adc_lut_matches(data, levels, metric):
    x, cb, _, cb2 = data
    book = cb if levels == 1 else cb2
    want = np.asarray(jpq.adc_lut(jnp.asarray(x[:40]), jnp.asarray(book),
                                  metric, levels=levels))
    got = tpq.adc_lut(_t(x[:40]), _t(book), metric, levels=levels)
    assert got.shape == (40, levels * M, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pack_unpack_and_scan_codes_match(data):
    x, cb, cb256, _ = data
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 16, (300, 2 * M), dtype=np.uint8)
    want = np.asarray(jpq.pack_nibbles(jnp.asarray(codes)))
    got = tpq.pack_nibbles(_t(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    # low nibble = stream s, high nibble = stream s + M (split halves)
    assert int(got[7, 3]) == int(codes[7, 3]) | (int(codes[7, 3 + M]) << 4)
    np.testing.assert_array_equal(
        tpq.unpack_nibbles(got, 2 * M).numpy(), codes)
    with pytest.raises(ValueError):
        tpq.pack_nibbles(_t(codes[:, :5]))
    for book, c in ((cb, codes[:, :M]),
                    (cb256, rng.integers(0, 256, (300, M), dtype=np.uint8))):
        lut = rng.standard_normal((M, book.shape[1])).astype(np.float32)
        np.testing.assert_allclose(
            tpq.adc_scan_codes(_t(lut), _t(c)).numpy(),
            np.asarray(jpq.adc_scan_codes(jnp.asarray(lut), jnp.asarray(c))),
            **TOL)


def _layout(rng, code_rows, cap=2048, n_lists=10, window=256):
    """A hand-made sorted layout: 128-aligned lists with empty, short and
    full ones, tombstones sprinkled in."""
    counts = np.array([0, 1, 130, 256, 77, 200, 0, 256, 40, 128], np.int32)
    offsets = (np.arange(n_lists) * 128).astype(np.int32)
    offsets[3:] += 128  # list 2 holds 130 rows: two aligned blocks
    offsets[4:] += 128
    offsets[6:] += 128
    offsets[8:] += 128
    row_ids = np.full(cap, -1, np.int32)
    nxt = 0
    for c, o in zip(counts, offsets):
        row_ids[o:o + c] = np.arange(nxt, nxt + c)
        nxt += c
    row_ids[offsets[3] + 5] = -1  # tombstones
    row_ids[offsets[7] + 255] = -1
    codes = rng.integers(0, 256, (code_rows, cap), dtype=np.uint8)
    return codes, row_ids, offsets, counts, window


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8",
                                  "four_bit_rotated"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_scan_probed_lists_pq_matches(data, form, metric):
    """Fixed codebooks, a hand-made layout: the packed forms take the K6
    wrapper's plain version here, the one-byte form the gather scan. The
    port returns layout positions; their row ids are the JAX package's."""
    x, cb, cb256, cb2 = data
    rng = np.random.default_rng(6)
    book, levels, code_rows = {
        "two_level": (cb2, 2, M), "four_bit": (cb, 1, M // 2),
        "flat8": (cb256, 1, M), "four_bit_rotated": (cb, 1, M // 2)}[form]
    codes, row_ids, offsets, counts, window = _layout(rng, code_rows)
    cap = codes.shape[1]
    corr = rng.standard_normal(cap).astype(np.float32) if levels == 2 else None
    rot = None
    if form == "four_bit_rotated":
        rot = np.linalg.qr(rng.standard_normal((D, D)))[0].astype(np.float32)
    cents = rng.standard_normal((10, D)).astype(np.float32)
    q = x[:9]
    probes = np.stack([rng.permutation(10)[:6] for _ in range(9)]).astype(np.int32)
    coarse = rng.standard_normal((9, 6)).astype(np.float32)
    kw = dict(max_list_size=window, metric=metric, k=50, levels=levels)
    want = jpq.scan_probed_lists_pq(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(cents),
        jnp.asarray(coarse), jnp.asarray(book), jnp.asarray(codes),
        jnp.asarray(row_ids), jnp.asarray(offsets), jnp.asarray(counts),
        rotation=None if rot is None else jnp.asarray(rot),
        sorted_norm_corr=None if corr is None else jnp.asarray(corr), **kw)
    got = tpq.scan_probed_lists_pq(
        _t(q), _t(probes), _t(cents), _t(coarse), _t(book), _t(codes),
        _t(row_ids), _t(offsets), _t(counts),
        rotation=None if rot is None else _t(rot),
        sorted_norm_corr=None if corr is None else _t(corr), **kw)
    assert got[0].shape == (9, 50) and got[1].dtype == torch.int32
    pos = got[1].long()
    ids = torch.where(pos >= 0, _t(row_ids)[pos.clamp(min=0)], -1)
    compare_topk(got[0], ids, *want, **TOL)
    assert (to_numpy(got[1]) >= -1).all()


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8"])
def test_scan_positions_match_the_position_mask(data, form):
    """The port's positions equal the JAX package's scan handed
    where(row_ids >= 0, arange(cap), -1) as its row ids, the position mask
    its search builds: the packed forms through the K6 wrapper's plain
    version, the one-byte form through the gather scan."""
    x, cb, cb256, cb2 = data
    rng = np.random.default_rng(8)
    book, levels, code_rows = {"two_level": (cb2, 2, M),
                               "four_bit": (cb, 1, M // 2),
                               "flat8": (cb256, 1, M)}[form]
    codes, row_ids, offsets, counts, window = _layout(rng, code_rows)
    cap = codes.shape[1]
    corr = rng.standard_normal(cap).astype(np.float32) if levels == 2 else None
    cents = rng.standard_normal((10, D)).astype(np.float32)
    q = x[:9]
    probes = np.stack([rng.permutation(10)[:6] for _ in range(9)]).astype(np.int32)
    coarse = rng.standard_normal((9, 6)).astype(np.float32)
    kw = dict(max_list_size=window, metric="sqeuclidean", k=50, levels=levels)
    masked = np.where(row_ids >= 0, np.arange(cap, dtype=np.int32), -1)
    want = jpq.scan_probed_lists_pq(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(cents),
        jnp.asarray(coarse), jnp.asarray(book), jnp.asarray(codes),
        jnp.asarray(masked), jnp.asarray(offsets), jnp.asarray(counts),
        sorted_norm_corr=None if corr is None else jnp.asarray(corr), **kw)
    got = tpq.scan_probed_lists_pq(
        _t(q), _t(probes), _t(cents), _t(coarse), _t(book), _t(codes),
        _t(row_ids), _t(offsets), _t(counts),
        sorted_norm_corr=None if corr is None else _t(corr), **kw)
    compare_topk(*got, *want, **TOL)
    pos = to_numpy(got[1])
    assert (pos >= 0).any() and (row_ids[pos[pos >= 0]] >= 0).all()


def _mse(x, book, levels):
    x, book = _t(x), _t(np.array(book))
    if levels == 2:
        m = book.shape[0] // 2
        c = tpq.encode_two_level(x, book)
        rec = tpq.reconstruct(c[:, :m], book[:m]) \
            + tpq.reconstruct(c[:, m:], book[m:])
    else:
        rec = tpq.reconstruct(tpq.encode(x, book), book)
    return float(((rec - x) ** 2).mean())


@pytest.mark.parametrize("form", ["four_bit", "byte", "two_level"])
def test_trained_codebooks_quantize_as_well_as_jax(data, form):
    x = data[0]
    w = jnp.ones((N,), jnp.float32)
    errs = {"torch": [], "jax": []}
    for seed in range(2):
        gen = torch.Generator().manual_seed(seed)
        key = jax.random.PRNGKey(seed)
        if form == "two_level":
            tb = tpq.train_two_level_codebooks(_t(x), None, gen, m=M)
            jb = jpq.train_two_level_codebooks(jnp.asarray(x), w, key, m=M)
            assert tb.shape == (2 * M, 16, D // M)
        else:
            n_codes = 16 if form == "four_bit" else 256
            tb = tpq.train_codebooks(_t(x), None, gen, m=M, n_codes=n_codes)
            jb = jpq.train_codebooks(jnp.asarray(x), w, key, m=M,
                                     n_codes=n_codes)
            assert tb.shape == (M, n_codes, D // M)
        levels = 2 if form == "two_level" else 1
        errs["torch"].append(_mse(x, tb, levels))
        errs["jax"].append(_mse(x, jb, levels))
    assert np.mean(errs["torch"]) <= 1.05 * np.mean(errs["jax"]), errs


def test_opq_rotation_is_orthogonal_and_helps_as_jax(data):
    """On correlated dims the learned rotation is orthogonal (RᵀR = I to
    1e-5) and its quantization error stays within 5% of the JAX one's."""
    rng = np.random.default_rng(8)
    mix = rng.standard_normal((D, D)).astype(np.float32)
    x = (rng.standard_normal((N, D)).astype(np.float32)
         * np.linspace(2.0, 0.1, D, dtype=np.float32)) @ mix
    gen = torch.Generator().manual_seed(0)
    r = tpq.train_opq_rotation(_t(x), None, gen, m=M, n_codes=16)
    assert r.shape == (D, D)
    torch.testing.assert_close(r.T @ r, torch.eye(D), rtol=0, atol=1e-5)
    rj = np.asarray(jpq.train_opq_rotation(
        jnp.asarray(x), jnp.ones((N,)), jax.random.PRNGKey(0), m=M,
        n_codes=16))

    def err(rot):
        xr = x @ np.asarray(rot).T
        book = tpq.train_codebooks(_t(xr), None,
                                   torch.Generator().manual_seed(1), m=M,
                                   n_codes=16)
        return _mse(xr, book, 1)

    assert err(r.numpy()) <= 1.05 * err(rj)
    assert err(r.numpy()) < err(np.eye(D, dtype=np.float32))


def test_kmeans_batched_ignores_zero_weight_rows_and_matches_single():
    """The batched k-means is the single one run side by side: with one
    problem it IS `kmeans`, zero-weight rows never pull a centroid, and
    split_small_frac = 0 leaves unequal clusters alone."""
    rng = np.random.default_rng(9)
    blobs = rng.standard_normal((4, 6)).astype(np.float32) * 5
    x = (blobs[rng.integers(0, 4, 400)]
         + 0.1 * rng.standard_normal((400, 6))).astype(np.float32)
    x[300:] = 100.0  # weightless outliers
    w = torch.ones(400)
    w[300:] = 0
    data = torch.stack([_t(x), _t(x[:, ::-1].copy())])
    cents, labels = tkm.kmeans_batched(
        data, w, torch.Generator().manual_seed(0), n_clusters=4, iters=8,
        split_small_frac=0.0)
    assert cents.shape == (2, 4, 6) and labels.shape == (2, 400)
    assert float(cents.abs().max()) < 50  # no centroid ran to the outliers
    for p in range(2):
        d = torch.cdist(cents[p], _t(blobs if p == 0 else blobs[:, ::-1].copy()))
        assert float(d.min(dim=1).values.max()) < 0.5
    one_c, one_l = tkm.kmeans(_t(x), w, torch.Generator().manual_seed(0),
                              n_clusters=4, iters=8, split_small_frac=0.0)
    bat_c, bat_l = tkm.kmeans_batched(
        _t(x)[None], w, torch.Generator().manual_seed(0), n_clusters=4,
        iters=8, split_small_frac=0.0)
    assert torch.equal(one_c, bat_c[0]) and torch.equal(one_l, bat_l[0])
    np.testing.assert_array_equal(
        tkm.assign_clusters_batched(data, cents).numpy(),
        np.stack([tkm.assign_clusters(data[p], cents[p]).numpy()
                  for p in range(2)]))
