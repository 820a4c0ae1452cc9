"""The plain versions of the port's IVF scan kernels (K4 probed top-k, K5
certified large-k) against the JAX package's Pallas kernels run in
interpret mode, on JAX-built IVF-Flat indexes loaded through the port's
index/io.py, and on a hand-made layout with empty and short lists. On a
CPU tensor each wrapper runs its plain version, so these calls are the
wrappers' CPU path.

Tolerance: both sides keep exact fp32 scores (the Pallas K4/K5 select with
full-precision keys) and sum exact products of the same operands in
another order, so scores agree to rtol 1e-5 / atol 1e-4 (scores reach
~1e2 here); positions agree up to swaps among scores tied with the k-th.
Certificate flags must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf_flat
from cuvs_rag_tpu.ops import ivf as jivf
from cuvs_rag_tpu.ops import pallas_ivf
from cuvs_rag_tpu.utils.config import IVFFlatParams
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
from torch_parity import compare_topk, to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
NPROBE = 6


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """JAX-built indexes (16 lists over 3,000 x 128 blobs, every 37th row
    deleted) per storage dtype, each with the port's load of its npz."""
    rng = np.random.default_rng(21)
    cent = rng.standard_normal((24, 128)).astype(np.float32)
    corpus = (cent[rng.integers(0, 24, 3000)]
              + 0.5 * rng.standard_normal((3000, 128))).astype(np.float32)
    queries = corpus[:9] + 0.1 * rng.standard_normal((9, 128)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        ix = jivf_flat.build(IVFFlatParams(n_lists=16, dtype=dtype),
                             jnp.asarray(corpus))
        ix = jivf_flat.delete(ix, np.arange(0, 3000, 37))
        path = str(tmp_path_factory.mktemp("ivf") / f"{dtype}.npz")
        jio.save_index(path, ix)
        out[dtype] = (ix, tio.load_index(path, device="cpu"))
    return out, queries


def _probe_args(jix, queries, metric, nprobe=NPROBE):
    """Probes, offsets, counts and coarse_ip (int8) as JAX arrays."""
    cs, probes = jivf.probe_lists(jnp.asarray(queries), jix.centroids,
                                  jix.centroid_sqnorms, nprobe, metric)
    coarse = None
    if jix.vectors.dtype == jnp.int8:
        coarse = cs + jix.centroid_sqnorms[probes] \
            if metric == "sqeuclidean" else cs
    return (jix.list_offsets[probes], jix.list_counts[probes], coarse)


def _layout_args(tix):
    return tix.vectors, tix.sqnorms, tix.scales


def _both_k4(jlay, tlay, queries, offs, cnts, coarse, window, k, metric,
             n_sub=1):
    ref = pallas_ivf.ivf_scan_pallas(
        *jlay, jnp.asarray(queries), offs, cnts, k=k, nprobe=offs.shape[1],
        window=window, metric=metric, coarse_ip=coarse, n_sub=n_sub,
        interpret=True)
    got = ik.ivf_scan(*tlay, torch.from_numpy(queries), to_torch(offs),
                      to_torch(cnts), k=k, window=window, metric=metric,
                      coarse_ip=None if coarse is None else to_torch(coarse))
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_k4_plain_matches_pallas(indexes, dtype, metric):
    ixs, queries = indexes
    jix, tix = ixs[dtype]
    offs, cnts, coarse = _probe_args(jix, queries, metric)
    (s, pos), (rs, rpos) = _both_k4(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, 10, metric)
    assert s.dtype == torch.float32 and pos.dtype == torch.int32
    compare_topk(s, pos, rs, rpos, **TOL)
    # no deleted row comes back
    rid = tix.row_ids[pos.clamp(min=0).long()]
    assert (rid[pos >= 0] >= 0).all()


def test_k4_equals_pallas_sub_windows(indexes):
    """The TPU's n_sub split reads the same rows: K4 (which has no split)
    matches the Pallas kernel with 128-row sub-windows as well."""
    ixs, queries = indexes
    jix, tix = ixs["bfloat16"]
    n_sub = jix.max_list_size // 128
    assert n_sub > 1
    offs, cnts, coarse = _probe_args(jix, queries, "sqeuclidean")
    got, ref = _both_k4((jix.vectors, jix.sqnorms, jix.scales),
                        _layout_args(tix), queries, offs, cnts, coarse,
                        jix.max_list_size, 32, "sqeuclidean", n_sub=n_sub)
    compare_topk(*got, *ref, **TOL)


def _both_k5(jlay, tlay, queries, offs, cnts, coarse, window, metric, **kw):
    ref = pallas_ivf.ivf_scan_pallas_large(
        *jlay, jnp.asarray(queries), offs, cnts, nprobe=offs.shape[1],
        window=window, metric=metric, coarse_ip=coarse, interpret=True, **kw)
    got = ik.ivf_scan_large(
        *tlay, torch.from_numpy(queries), to_torch(offs), to_torch(cnts),
        window=window, metric=metric,
        coarse_ip=None if coarse is None else to_torch(coarse), **kw)
    return got, ref


@pytest.mark.parametrize("dtype,metric,n_sub", [
    ("float32", "sqeuclidean", 1), ("bfloat16", "inner_product", 1),
    ("int8", "sqeuclidean", 1), ("int8", "inner_product", 3),
])
def test_k5_plain_matches_pallas(indexes, dtype, metric, n_sub):
    ixs, queries = indexes
    jix, tix = ixs[dtype]
    offs, cnts, coarse = _probe_args(jix, queries, metric)
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, metric, k=64, n_sub=n_sub)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    assert bool(cert.all())
    compare_topk(s, pos, rs, rpos, **TOL)
    # and certified rows are the exact top-k of the probed lists
    es, epos = ik.ivf_scan_plain(
        *_layout_args(tix), torch.from_numpy(queries), to_torch(offs),
        to_torch(cnts), k=64, window=jix.max_list_size, metric=metric,
        coarse_ip=None if coarse is None else to_torch(coarse))
    compare_topk(s, pos, es, epos, **TOL)


def test_k5_under_provisioned_certificate_matches(indexes):
    """Two planes of 128-row classes cannot hold k = 200 well: rows fail
    the certificate, and the flags and candidates equal the Pallas kernel's."""
    ixs, queries = indexes
    jix, tix = ixs["float32"]
    offs, cnts, coarse = _probe_args(jix, queries, "sqeuclidean")
    kw = dict(k=200, n_sub=jix.max_list_size // 128, r_planes=2)
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, "sqeuclidean", **kw)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    assert not bool(cert.all())
    compare_topk(s, pos, rs, rpos, **TOL)


@pytest.fixture(scope="module")
def ragged_layout():
    """A layout with empty, one-row and short lists (hand-made labels)."""
    rng = np.random.default_rng(22)
    sizes = [0, 3, 130, 0, 257, 40, 1, 300]
    labels = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    n = labels.shape[0]
    x = rng.standard_normal((n, 128)).astype(np.float32)
    cap = jivf.capacity_for(n, len(sizes), 384)
    lay = jivf.build_layout(jnp.asarray(x), jnp.asarray(labels),
                            jnp.ones(n, bool), n_lists=len(sizes),
                            capacity=cap, max_list_size=384)
    probes = np.stack([rng.permutation(len(sizes))[:4] for _ in range(9)])
    probes[0] = [0, 1, 3, 6]  # two empty lists and four rows in all
    queries = x[rng.integers(0, n, 9)] + 0.1 * rng.standard_normal((9, 128))
    jlay = (lay.sorted_vectors, lay.sorted_sqnorms, lay.sorted_scales)
    return (jlay, tuple(to_torch(a) for a in jlay), queries.astype(np.float32),
            lay.list_offsets[probes], lay.list_counts[probes])


def test_k4_empty_and_short_lists(ragged_layout):
    jlay, tlay, queries, offs, cnts = ragged_layout
    got, ref = _both_k4(jlay, tlay, queries, offs, cnts, None, 384, 32,
                        "sqeuclidean")
    compare_topk(*got, *ref, **TOL)
    assert (got[1] == -1).any()  # some queries probe fewer than 32 rows


def test_k5_empty_and_short_lists(ragged_layout):
    jlay, tlay, queries, offs, cnts = ragged_layout
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        jlay, tlay, queries, offs, cnts, None, 384, "inner_product", k=40,
        n_sub=3)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    compare_topk(s, pos, rs, rpos, **TOL)


def test_large_k_config_on_the_card():
    """The card's config: the class width is the whole window; at the main
    path's window 2,048 and k = 2,000 that is R = 10 planes."""
    assert ik.large_k_config(2048, 384, 2000) == (1, 10)
    assert ik.large_k_config(2048, 384, 32) is None  # K4's range
    assert ik.large_k_config(128, 384, 8192) is None  # R > 64
    r = ik.large_k_config(512, 768, 300)[1]
    assert r == pallas_ivf.default_r_planes(300, 512)


def test_wrappers_reject_bad_inputs(ragged_layout):
    _, tlay, queries, offs, cnts = ragged_layout
    q = torch.from_numpy(queries)
    o, c = to_torch(offs), to_torch(cnts)
    with pytest.raises(ValueError):
        ik.ivf_scan(*tlay, q, o, c, k=33, window=384, metric="sqeuclidean")
    with pytest.raises(ValueError):
        ik.ivf_scan(*tlay, q[:, :8], o, c, k=3, window=384,
                    metric="sqeuclidean")
    with pytest.raises(ValueError):
        ik.ivf_scan_large(*tlay, q, o, c, k=100, window=384,
                          metric="sqeuclidean", n_sub=5)
    with pytest.raises(ValueError):
        ik.ivf_scan_large(*tlay, q, o, c, k=2000, window=384,
                          metric="sqeuclidean", n_sub=3, r_planes=2)
    assert ik.ivf_scan.launches == 0 and ik.ivf_scan_large.launches == 0
