"""The port's distance/topk ops and FlatIndex (build, extend, delete, search,
npz persistence) against the JAX package on the same seeded numpy inputs.

Tolerances: index arrays and fp32 distances rtol/atol 1e-5 (fp32 sums in
another order); bf16/int8 storage compares bit-exactly where both sides
round the same fp32 value (storage, scales). Search ids agree up to swaps
among distances tied within the tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.ops import distance as jdist
from cuvs_rag_tpu.ops import topk as jtopk
from cuvs_rag_tpu.utils.config import FlatParams, FlatSearchParams
from cuvs_rag_tpu_torch.index import flat
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.ops import distance as dist
from cuvs_rag_tpu_torch.ops import topk
from torch_parity import compare_topk, to_numpy, to_torch

torch.set_num_threads(1)

N, D = 1500, 48


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((7, D)).astype(np.float32))


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=rtol, atol=atol)


def test_distance_ops_match(data):
    x, q = data
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    _close(dist.sqnorms(xt), jdist.sqnorms(xj))
    _close(dist.l2_normalize(xt), jdist.l2_normalize(xj))
    _close(dist.pairwise_sqeuclidean(qt, xt), jdist.pairwise_sqeuclidean(qj, xj),
           atol=1e-4)
    tomb = np.where(np.arange(N) % 4 == 0, 2e30, (x ** 2).sum(1)).astype(np.float32)
    for metric in ("sqeuclidean", "inner_product"):
        _close(dist.scores_from_tile(qt, xt, torch.from_numpy(tomb), metric),
               jdist.scores_from_tile(qj, xj, jnp.asarray(tomb), metric),
               atol=1e-4)
    s = torch.from_numpy(-np.abs(q[:, :5]))
    sq = dist.sqnorms(qt)
    _close(dist.scores_to_distances(s, sq, "sqeuclidean"),
           jdist.scores_to_distances(jnp.asarray(s.numpy()), jnp.asarray(sq.numpy()),
                                     "sqeuclidean"))


def test_merge_topk_invalid_slots_and_short_rows():
    s = np.array([[3.0, -np.inf, -3e29, 1.0], [0.5, 0.25, -np.inf, 2.0]],
                 np.float32)
    ids = np.array([[10, 11, 12, 13], [20, 21, 22, 23]], np.int32)
    for k in (3, 6):  # k > candidates pads with -inf / -1
        got = topk.merge_topk(torch.from_numpy(s), torch.from_numpy(ids), k)
        ref = jtopk.merge_topk(jnp.asarray(s), jnp.asarray(ids), k)
        np.testing.assert_array_equal(to_numpy(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_streaming_and_dense_scans_match(data, dtype):
    x, q = data
    jix = jflat.build(FlatParams(dtype=dtype, tile_n=512), jnp.asarray(x))
    args = (to_torch(jix.vectors), to_torch(jix.sqnorms), torch.from_numpy(q),
            N, to_torch(jix.scales))
    for metric in ("sqeuclidean", "inner_product"):
        ref = jtopk.flat_topk_search(
            jix.vectors, jix.sqnorms, jnp.asarray(q), jix.n_valid, jix.scales,
            k=9, metric=metric, tile_n=512)
        got = topk.flat_topk_search(*args, k=9, metric=metric, tile_n=512)
        dense = topk.flat_topk_search_dense(*args, k=9, metric=metric)
        compare_topk(*got, *ref, rtol=1e-5, atol=1e-4)
        compare_topk(*dense, *ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,metric", [
    ("float32", "sqeuclidean"), ("bfloat16", "sqeuclidean"),
    ("int8", "sqeuclidean"), ("float32", "cosine"),
    ("bfloat16", "inner_product"),
])
def test_build_and_search_match(data, dtype, metric):
    x, q = data
    params = FlatParams(dtype=dtype, metric=metric, tile_n=1024)
    jix = jflat.build(params, jnp.asarray(x))
    tix = flat.build(params, x, device="cpu")
    assert (tix.size, tix.n_valid, tix.tile_n, tix.metric) == \
        (jix.size, int(jix.n_valid), jix.tile_n, jix.metric)
    assert tix.vectors.dtype == {"float32": torch.float32, "bfloat16":
                                 torch.bfloat16, "int8": torch.int8}[dtype]
    if metric == "cosine":  # row norms summed in another order (ulps)
        _close(tix.vectors, jix.vectors, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(to_numpy(tix.vectors), to_numpy(jix.vectors))
    # amax / 127: XLA on the CPU may divide through a reciprocal (1 ulp)
    _close(tix.scales, jix.scales, rtol=2e-7, atol=0)
    _close(tix.sqnorms, jix.sqnorms)
    for k in (5, 40):
        rd, ri = jflat.search(None, jix, jnp.asarray(q), k)
        d, i = flat.search(None, tix, torch.from_numpy(q), k)
        sign = -1.0 if metric == "sqeuclidean" else 1.0  # larger-better order
        compare_topk(sign * d, i, sign * np.asarray(rd), ri,
                          rtol=1e-5, atol=1e-4)


def test_delete_extend_fixpoint_matches(data):
    """Deleted rows stay deleted through extends (the sqnorm slot converges
    to real + DELETED_PENALTY every time), in both packages alike."""
    x, q = data
    params = FlatParams(dtype="bfloat16", tile_n=256)
    jix = jflat.build(params, jnp.asarray(x[:1000]))
    tix = flat.build(params, x[:1000], device="cpu")
    gone = np.array([0, 1, 2, 500, 999, 5000, -1])  # unknown ids ignored
    jix, tix = jflat.delete(jix, gone), flat.delete(tix, gone)
    for start in (1000, 1150, 1300):
        jix = jflat.extend(jix, jnp.asarray(x[start:start + 150]))
        tix = flat.extend(tix, torch.from_numpy(x[start:start + 150]))
    assert tix.n_valid == int(jix.n_valid) == 1450
    _close(tix.sqnorms, jix.sqnorms)
    np.testing.assert_array_equal(flat.live_row_mask(tix).numpy(),
                                  np.asarray(jflat.live_row_mask(jix)))
    d, i = flat.search(None, tix, torch.from_numpy(x[:3]), 5)
    rd, ri = jflat.search(None, jix, jnp.asarray(x[:3]), 5)
    assert not np.isin(i.numpy(), [0, 1, 2, 500, 999]).any()
    compare_topk(-d, i, -np.asarray(rd), ri, rtol=1e-5, atol=1e-4)
    for _ in range(25):  # far past the ~20 extends a decaying slot survives
        tix = flat.extend(tix, torch.from_numpy(x[:1]))
    assert not flat.live_row_mask(tix)[[0, 1, 2, 500, 999]].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_npz_cross_load_both_directions(data, dtype, tmp_path):
    x, q = data
    params = FlatParams(dtype=dtype, tile_n=512)
    jix = jflat.delete(jflat.build(params, jnp.asarray(x)), [3, 4])
    tix = flat.delete(flat.build(params, x, device="cpu"), [3, 4])
    jio.save_index(str(tmp_path / "jax.npz"), jix)
    tio.save_index(str(tmp_path / "torch.npz"), tix)
    from_jax = tio.load_index(str(tmp_path / "jax.npz"), device="cpu")
    from_torch = jio.load_index(str(tmp_path / "torch.npz"))
    assert from_jax.vectors.dtype == tix.vectors.dtype
    assert from_torch.vectors.dtype == jix.vectors.dtype
    for a, b in ((from_jax, jix), (tix, from_torch)):
        np.testing.assert_array_equal(to_numpy(a.vectors), to_numpy(b.vectors))
        np.testing.assert_array_equal(to_numpy(a.sqnorms), to_numpy(b.sqnorms))
        assert (a.n_valid, a.metric, a.tile_n) == (int(b.n_valid), b.metric, b.tile_n)
    d, i = flat.search(None, from_jax, torch.from_numpy(q), 6)
    rd, ri = jflat.search(None, from_torch, jnp.asarray(q), 6)
    compare_topk(-d, i, -np.asarray(rd), ri, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [5, 40])
def test_search_above_dense_threshold_matches(k):
    """Past _DENSE_THRESHOLD the port routes k <= 32 to K1 and 32 < k to the
    certified K3 (their plain versions on the CPU); the JAX package's CPU
    path streams through XLA. Both are exact."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((flat._DENSE_THRESHOLD + 100, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    params = FlatParams(dtype="float32")
    tix = flat.build(params, x, device="cpu")
    assert tix.size > flat._DENSE_THRESHOLD
    rd, ri = jflat.search(None, jflat.build(params, jnp.asarray(x)),
                          jnp.asarray(q), k)
    d, i = flat.search(None, tix, torch.from_numpy(q), k)
    compare_topk(-d, i, -np.asarray(rd), ri, rtol=1e-5, atol=1e-4)


def test_approx_search_below_threshold_is_exact(data):
    x, q = data
    tix = flat.build(FlatParams(), x, device="cpu")
    d, i = flat.search(FlatSearchParams(approx=True), tix, torch.from_numpy(q), 5)
    de, ie = flat.search(None, tix, torch.from_numpy(q), 5)
    np.testing.assert_array_equal(i.numpy(), ie.numpy())


def test_search_validates_queries(data):
    x, _ = data
    tix = flat.build(FlatParams(), x, device="cpu")
    d, i = flat.search(None, tix, torch.from_numpy(x[7]), 1)  # 1-D promoted
    assert i.tolist() == [[7]]
    with pytest.raises(ValueError):
        flat.search(None, tix, torch.zeros((2, D + 1)), 1)
    with pytest.raises(ValueError):
        flat.build(FlatParams(), np.zeros((0, D), np.float32))
