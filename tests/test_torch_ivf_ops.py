"""The port's k-means and IVF layout ops against the JAX package's, on the
same seeded numpy inputs.

Tolerances: integer outputs (labels, layout positions, ids) must be
identical. Float outputs agree to rtol/atol 1e-5: both sides sum exact
products of the same fp32 or bf16 operands in fp32, in another order.
`scan_probed_lists` ids agree up to swaps among scores tied with the k-th.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.ops import ivf as jivf
from cuvs_rag_tpu.ops import kmeans as jkm
from cuvs_rag_tpu_torch.ops import ivf as tivf
from cuvs_rag_tpu_torch.ops import kmeans as tkm
from torch_parity import compare_topk, to_numpy, to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _blobs(seed, n=600, d=32, c=12, spread=0.4):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    x = cent[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), cent


def _as(dtype, a):
    """numpy fp32 -> (JAX array, tensor) in `dtype`."""
    j = jnp.asarray(a).astype(dtype)
    return j, to_torch(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_clusters_identical(dtype):
    x, cent = _blobs(1)
    xj, xt = _as(dtype, x)
    want = jkm.assign_clusters(xj, jnp.asarray(cent))
    got = tkm.assign_clusters(xt, torch.from_numpy(cent))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_topk_clusters_identical(dtype):
    """Below 64 clusters the JAX package takes the exact top_k too."""
    x, cent = _blobs(2)
    xj, xt = _as(dtype, x)
    wl, wm = jkm.assign_topk_clusters(xj, jnp.asarray(cent), t=4)
    gl, gm = tkm.assign_topk_clusters(xt, torch.from_numpy(cent), t=4)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-4)


def _balance_inputs(case):
    rng = np.random.default_rng(3)
    n, n_lists = 500, 10
    if case == "spill":  # real preferences from a skewed corpus
        x, cent = _blobs(3, n=n, c=n_lists, spread=0.2)
        x[: n // 2] = cent[0] + 0.3 * rng.standard_normal((n // 2, 32))
        top, margins = jkm.assign_topk_clusters(
            jnp.asarray(x), jnp.asarray(cent), t=4)
        top, margins = np.array(top), np.array(margins)
        cap = 2 * n // n_lists
    else:  # every row prefers 4 of the lists: the dump pass must place them
        top = np.stack([rng.integers(0, 2, n), rng.integers(2, 4, n)], 1)
        top = top.astype(np.int32)
        margins = rng.random(n).astype(np.float32)
        margins[::7] = 0.0  # ties in the secondary sort key
        cap = n // n_lists
    valid = np.ones(n, bool)
    valid[-6:] = False  # pad rows never spill and take no room
    return top, margins, valid, n_lists, cap


@pytest.mark.parametrize("case", ["spill", "dump"])
def test_balance_assignments_identical(case):
    top, margins, valid, n_lists, cap = _balance_inputs(case)
    want = jkm.balance_assignments_device(
        jnp.asarray(top), jnp.asarray(margins), jnp.asarray(valid),
        n_lists=n_lists, cap=cap)
    got = tkm.balance_assignments_device(
        torch.from_numpy(top), torch.from_numpy(margins),
        torch.from_numpy(valid), n_lists=n_lists, cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = np.bincount(got.numpy()[valid], minlength=n_lists)
    assert counts.max() <= cap


def test_exclusive_starts_and_counts():
    counts = np.array([3, 0, 5, 1], np.int32)
    np.testing.assert_array_equal(
        tkm.exclusive_starts(torch.from_numpy(counts)).numpy(),
        np.asarray(jkm.exclusive_starts(jnp.asarray(counts))))
    labels = np.array([0, 2, 2, 3, 0, 2], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    np.testing.assert_array_equal(
        tivf.list_counts_device(torch.from_numpy(labels),
                                torch.from_numpy(valid), 5).numpy(),
        np.asarray(jivf.list_counts_device(jnp.asarray(labels),
                                           jnp.asarray(valid), jnp.zeros(5))))


def _layout_inputs(seed=4, n=700, n_lists=9):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_lists, n).astype(np.int32)
    labels[labels == 4] = 5  # an empty list
    valid = rng.random(n) > 0.05
    return labels, valid, n_lists


@pytest.mark.parametrize("headroom", [0, 128])
def test_sort_by_list_identical(headroom):
    labels, valid, n_lists = _layout_inputs()
    cap = jivf.capacity_for(704, n_lists, 256, headroom=headroom)
    assert cap == tivf.capacity_for(704, n_lists, 256, headroom=headroom)
    want = jivf.sort_by_list(jnp.asarray(labels), jnp.asarray(valid), n_lists,
                             cap, headroom)
    got = tivf.sort_by_list(torch.from_numpy(labels), torch.from_numpy(valid),
                            n_lists, cap, headroom)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_layout_identical(dtype):
    labels, valid, n_lists = _layout_inputs(5)
    n = labels.shape[0]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    counts = np.bincount(labels[valid], minlength=n_lists)
    max_list = int(np.ceil(max(counts.max(), 8) / 128) * 128)
    cap = jivf.capacity_for(n, n_lists, max_list)
    kw = dict(n_lists=n_lists, capacity=cap, max_list_size=max_list)
    if dtype == "int8":  # codes + scales + reconstruction sqnorms
        codes = rng.integers(-127, 128, (n, 16)).astype(np.int8)
        scales = rng.random(n).astype(np.float32)
        sq = rng.random(n).astype(np.float32)
        want = jivf.build_layout(jnp.asarray(codes), jnp.asarray(labels),
                                 jnp.asarray(valid), scales=jnp.asarray(scales),
                                 sqnorms=jnp.asarray(sq), **kw)
        got = tivf.build_layout(torch.from_numpy(codes), torch.from_numpy(labels),
                                torch.from_numpy(valid),
                                scales=torch.from_numpy(scales),
                                sqnorms=torch.from_numpy(sq), **kw)
    else:
        xj, xt = _as(dtype, x)
        want = jivf.build_layout(xj, jnp.asarray(labels), jnp.asarray(valid), **kw)
        got = tivf.build_layout(xt, torch.from_numpy(labels),
                                torch.from_numpy(valid), **kw)
    for name in ("sorted_vectors", "sorted_scales", "sorted_row_ids",
                 "list_offsets", "list_counts"):
        np.testing.assert_array_equal(to_numpy(getattr(got, name)),
                                      to_numpy(getattr(want, name)), name)
    np.testing.assert_allclose(got.sorted_sqnorms.numpy(),
                               np.asarray(want.sorted_sqnorms), **TOL)
    assert got.truncated == int(want.truncated) == 0


def test_append_tombstone_and_invert_identical():
    labels, valid, n_lists = _layout_inputs(7)
    n = labels.shape[0]
    cap = jivf.capacity_for(n, n_lists, 256)
    _, _, rid_j, counts_j, offs_j = jivf.sort_by_list(
        jnp.asarray(labels), jnp.asarray(valid), n_lists, cap)
    rid_t, counts_t, offs_t = (to_torch(a) for a in (rid_j, counts_j, offs_j))

    new = np.random.default_rng(8).integers(0, n_lists, 40).astype(np.int32)
    want = jivf.append_targets(jnp.asarray(new), counts_j, offs_j)
    got = tivf.append_targets(torch.from_numpy(new), counts_t, offs_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    ids = np.array([3, 17, 17, -1, 5000, 250, 699], np.int32)
    want = jivf.tombstone_layout(rid_j, jnp.asarray(ids), jnp.int32(n))
    got = tivf.tombstone_layout(rid_t, torch.from_numpy(ids), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    want = jivf.invert_layout(want[1], offs_j, n)
    got = tivf.invert_layout(got[1], offs_t, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_probe_lists_identical(metric):
    x, cent = _blobs(9, n=40)
    csq = (cent ** 2).sum(1)
    ws, wi = jivf.probe_lists(jnp.asarray(x), jnp.asarray(cent),
                              jnp.asarray(csq), 5, metric)
    gs, gi = tivf.probe_lists(torch.from_numpy(x), torch.from_numpy(cent),
                              torch.from_numpy(csq), 5, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_labels_with_counts_identical():
    x, cent = _blobs(10, n=800, c=8, spread=0.2)
    x[:400] = cent[1] + 0.05  # overfill one list: the balance pass runs
    valid = np.ones(800, bool)
    wl, wc = jivf.labels_with_counts(jnp.asarray(x), jnp.asarray(cent), 800,
                                     2.0, jnp.asarray(valid))
    gl, gc = tivf.labels_with_counts(torch.from_numpy(x), torch.from_numpy(cent),
                                     800, 2.0, torch.from_numpy(valid))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gc, wc)
    assert gc.max() <= 200


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_scan_probed_lists_matches(dtype, metric):
    """Same layout, probes and coarse terms: same scores, ids up to ties."""
    rng = np.random.default_rng(11)
    labels, valid, n_lists = _layout_inputs(12)
    n = labels.shape[0]
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    cap = jivf.capacity_for(n, n_lists, 128)
    if dtype == "int8":
        x = rng.integers(-127, 128, (n, 16)).astype(np.int8)
        scales = rng.random(n).astype(np.float32)
        layout = jivf.build_layout(
            jnp.asarray(x), jnp.asarray(labels), jnp.asarray(valid),
            n_lists=n_lists, capacity=cap, max_list_size=128,
            scales=jnp.asarray(scales), sqnorms=jnp.asarray(rng.random(n) * 9,
                                                            jnp.float32))
        coarse = rng.standard_normal((5, 4)).astype(np.float32)
    else:
        layout = jivf.build_layout(
            jnp.asarray(x).astype(dtype), jnp.asarray(labels),
            jnp.asarray(valid), n_lists=n_lists, capacity=cap,
            max_list_size=128)
        coarse = None
    probes = np.stack([rng.permutation(n_lists)[:4] for _ in range(5)])
    probes = probes.astype(np.int32)
    kw = dict(max_list_size=128, metric=metric, k=20)
    ws, wi = jivf.scan_probed_lists(
        jnp.asarray(q), jnp.asarray(probes), layout.sorted_vectors,
        layout.sorted_sqnorms, layout.sorted_row_ids, layout.list_offsets,
        layout.list_counts, layout_scales=layout.sorted_scales,
        coarse_ip=None if coarse is None else jnp.asarray(coarse), **kw)
    gs, gi = tivf.scan_probed_lists(
        torch.from_numpy(q), torch.from_numpy(probes),
        *(to_torch(a) for a in (layout.sorted_vectors, layout.sorted_sqnorms,
                                layout.sorted_row_ids, layout.list_offsets,
                                layout.list_counts)),
        layout_scales=to_torch(layout.sorted_scales),
        coarse_ip=None if coarse is None else torch.from_numpy(coarse), **kw)
    compare_topk(gs, gi, ws, wi, rtol=1e-5, atol=1e-4)


def test_kmeans_quality_matches_jax():
    """Builds differ by RNG, so the port's k-means is held to the JAX
    package's quantization error on the same blobs (within 5%) and must
    find every blob."""
    import jax

    x, cent = _blobs(13, n=2000, d=16, c=10, spread=0.1)
    cj, _ = jkm.kmeans(jnp.asarray(x), jnp.ones(2000), jax.random.PRNGKey(0),
                       n_clusters=10, iters=10)
    ct, lt = tkm.kmeans(torch.from_numpy(x), None,
                        torch.Generator().manual_seed(0), n_clusters=10,
                        iters=10)

    def qerr(c):
        d2 = ((x[:, None, :] - np.asarray(c)[None]) ** 2).sum(-1)
        return d2.min(1).mean()

    assert qerr(ct.numpy()) <= 1.05 * qerr(cj)
    assert len(np.unique(lt.numpy())) == 10
    true = ((x[:, None] - cent[None]) ** 2).sum(-1).argmin(1)
    # every blob maps to one centroid
    for b in range(10):
        assert len(np.unique(lt.numpy()[true == b])) == 1
