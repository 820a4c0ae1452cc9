"""The port's graph ops (ops/graph.py) against the JAX package's, on the
same seeded numpy inputs.

Tolerances, by what each op computes:
- augment_rows / augmented_query, augment_reverse_edges, list_medoids, the
  evenly spaced entry rows: equal, bit for bit (the npz layout is shared and
  the ops are deterministic; the medoids' scores agree to fp32 rounding and
  no row of these inputs is within it of its list's best).
- build_knn_graph: neighbour sets equal up to ties at the k-th distance
  (utils/compare.py, rtol 1e-5 / atol 1e-4 on fp32 scores).
- build_knn_graph_ivf, on the same JAX-built IVF index: the JAX package
  ranks bf16 scores with approx_max_k(recall_target=0.98), the port fp32
  scores exactly. bf16 scores of these rows tie at the 24th neighbour, so
  the JAX graph shares under 0.95 of each row's neighbours with the exact
  kNN graph (asserted, as the reason for the rule), and an overlap of 0.95
  with it is out of reach for an exact ranking. Held instead: the port's
  graph is at least as close to the exact kNN graph as the JAX graph is,
  and the two overlap within 0.02 of the JAX graph's own overlap with it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.ops import distance as jdist
from cuvs_rag_tpu.ops import graph as jgraph
from cuvs_rag_tpu.utils.config import IVFFlatParams as JIVFParams
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.ops import graph as tgraph
from torch_parity import compare_topk, to_numpy, to_torch

torch.set_num_threads(1)

N, DIM = 2000, 32
METRICS = ("sqeuclidean", "inner_product", "cosine")


def _corpus(seed=11, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((16, d)).astype(np.float32) * 3
    return (cent[rng.integers(0, 16, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def _both(x, dtype):
    """The same rows as a JAX array and a CPU tensor of storage `dtype`."""
    j = jnp.asarray(x).astype(dtype)
    return j, to_torch(j)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_rows_bit_equal(dtype, metric):
    """[v, hi, lo, 0...] with pad rows past n_valid, bit for bit; the sqnorms
    are chosen so the bf16 lo column is live (sq ~ 1,200, bf16 spacing 8)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((301, 40)) + 3.0).astype(np.float32)
    jv, tv = _both(x, dtype)
    jsq = jdist.sqnorms(jv)
    n_valid = 290
    want = jgraph.augment_rows(jv, jsq, jnp.int32(n_valid), metric)
    got = tgraph.augment_rows(tv, to_torch(jsq), n_valid, metric)
    assert got.dtype == tv.dtype and tuple(got.shape) == (301, 128)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))
    if metric == "sqeuclidean" and dtype == "bfloat16":
        assert (to_numpy(got)[:n_valid, 41] != 0).any()  # lo is live


@pytest.mark.parametrize("metric", METRICS)
def test_augmented_query_bit_equal(metric):
    q = np.random.default_rng(4).standard_normal((5, 40)).astype(np.float32)
    want = jgraph.augmented_query(jnp.asarray(q), metric, 128)
    got = tgraph.augmented_query(torch.from_numpy(q), metric, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_graph(seed, n, g, invalid=0.0):
    rng = np.random.default_rng(seed)
    graph = rng.integers(0, n, (n, g)).astype(np.int32)
    graph[rng.random((n, g)) < invalid] = -1
    return graph


@pytest.mark.parametrize("forward", [None, 1, 5, 12, 16])
@pytest.mark.parametrize("invalid", [0.0, 0.2])
def test_augment_reverse_edges_equal(forward, invalid):
    """Random intermediate graphs (with -1 destinations) and every split of
    the `forward` argument, including pure-forward."""
    graph = _random_graph(5, 500, 24, invalid)
    want = jgraph.augment_reverse_edges(jnp.asarray(graph), 16, forward)
    got = tgraph.augment_reverse_edges(torch.from_numpy(graph), 16, forward)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_reverse_edges_collisions_equal():
    """Seven sources pointing at node 0 in one rank pass, and the -1 case of
    the JAX package's own tests: every candidate lands as there."""
    fwd = np.tile(np.array([0, 1, 2, 3], np.int32), (8, 1))
    fwd[0] = [1, 2, 3, 4]
    bad = np.array([[1, -1, 2, 3], [-1, 0, 2, 3], [0, 1, -1, 3],
                    [0, 1, 2, -1]], np.int32)
    for graph in (fwd, bad):
        want = jgraph.augment_reverse_edges(jnp.asarray(graph), 4)
        got = tgraph.augment_reverse_edges(torch.from_numpy(graph), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if graph is fwd:  # node 0's two reverse slots: distinct sources
            rev0 = got.numpy()[0, 2:].tolist()
            assert len(set(rev0)) == 2 and set(rev0) <= set(range(1, 8))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_knn_graph_equal_up_to_ties(dtype, metric):
    x = _corpus()[:1000]
    n_valid = 995  # the last five rows are pads
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    jv, tv = _both(x, dtype)
    jsq = jdist.sqnorms(jv)
    want = np.asarray(jgraph.build_knn_graph(
        jv, jsq, jnp.int32(n_valid), degree=12, metric=metric, tile_n=1000))
    got = tgraph.build_knn_graph(tv, to_torch(jsq), n_valid, degree=12,
                                 metric=metric, query_chunk=256).numpy()
    # pad rows are queries too (with real rows here), never neighbours
    assert got.max() < n_valid
    assert not (got == np.arange(1000)[:, None]).any()

    def scores(ids):
        v = to_numpy(jv).astype(np.float64)
        s = (v[:, None, :] * v[ids]).sum(-1)
        if metric == "sqeuclidean":
            s = 2 * s - (v[ids] ** 2).sum(-1)
        order = np.argsort(-s, axis=1, kind="stable")
        return np.take_along_axis(s, order, 1), np.take_along_axis(ids, order, 1)

    ks, ki = scores(got)
    ps, pi = scores(want)
    compare_topk(ks, ki, ps, pi, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    """A JAX-built IVF-Flat index per storage dtype, and the port's load of
    the same npz file."""
    x = _corpus()
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        jix = jivf.build(JIVFParams(n_lists=8, dtype=dtype), jnp.asarray(x))
        path = str(tmp_path_factory.mktemp("givf") / f"{dtype}.npz")
        jio.save_index(path, jix)
        out[dtype] = (jix, tio.load_index(path, device="cpu"))
    return x, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_list_medoids_equal(ivf_pair, dtype):
    _, ix = ivf_pair
    jix, tix = ix[dtype]
    np.testing.assert_array_equal(tgraph.list_medoids(tix).numpy(),
                                  np.asarray(jgraph.list_medoids(jix)))


def _overlap(a, b):
    """Mean share of each row's neighbours two graphs have in common."""
    return np.mean([len(np.intersect1d(r, s)) / a.shape[1]
                    for r, s in zip(a, b)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_knn_graph_ivf_overlaps_jax(ivf_pair, dtype):
    x, ix = ivf_pair
    jix, tix = ix[dtype]
    n_pad = x.shape[0]
    want = np.asarray(jgraph.build_knn_graph_ivf(
        jnp.asarray(x), jnp.int32(N), jix, degree=24, n_probes=3))
    got = tgraph.build_knn_graph_ivf(torch.from_numpy(x), N, tix, degree=24,
                                     n_probes=3).numpy()
    assert got.shape == want.shape == (n_pad, 24)
    rows = np.arange(n_pad)[:, None]
    assert not (got == rows).any()  # every row got 24 candidates
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    exact = np.argsort(d2, axis=1)[:, :24]
    jax_exact = _overlap(want, exact)
    assert jax_exact < 0.95
    assert _overlap(got, exact) >= jax_exact
    assert _overlap(got, want) >= jax_exact - 0.02


def test_linspace_rows_equal_jnp():
    """The evenly spaced entry rows are jnp.linspace's int32 rows exactly,
    including the sizes where fp32 rounding lands next to an integer."""
    for n_pad in list(range(1, 400, 7)) + [6_290_000, 1_048_576, 131_080]:
        for count in (1, 2, 3, 16, 32, 64, 100, 127, 128):
            want = np.asarray(jnp.linspace(0, n_pad - 1, count)
                              .astype(jnp.int32))
            got = tgraph.linspace_rows(n_pad, count, "cpu").numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{n_pad} {count}")


def test_earlier_copy_and_topk_first():
    """earlier_copy marks exactly what the O(m²) compare marks; topk_first
    takes ties lowest position first, as lax.top_k."""
    rng = np.random.default_rng(8)
    v = rng.integers(-1, 20, (6, 50)).astype(np.int32)
    eq = v[:, :, None] == v[:, None, :]
    earlier = np.tril(np.ones((50, 50), bool), -1)
    want = (eq & earlier).any(axis=2)
    np.testing.assert_array_equal(
        tgraph.earlier_copy(torch.from_numpy(v)).numpy(), want)
    s = rng.integers(0, 4, (6, 50)).astype(np.float32)
    s[s == 0] = -np.inf
    import jax

    js, ji = jax.lax.top_k(jnp.asarray(s), 20)
    ts, ti = tgraph.topk_first(torch.from_numpy(s), 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16, 1 << 30])
def test_bootstrap_steps_cover_each_list_once(budget):
    """The IVF bootstrap's steps: every non-empty list once, by falling
    size; windows that hold the step's largest list and candidate total,
    in whole 8-row units; the score tile within the budget unless a step
    holds one list alone."""
    g = np.random.default_rng(5)
    counts = g.integers(0, 300, 57)
    counts[[3, 9, 40]] = 0
    nbrs = np.concatenate([np.arange(57)[:, None],
                           g.integers(0, 57, (57, 3))], axis=1)
    steps = tgraph._bootstrap_steps(counts, nbrs, budget)
    lists = [i for s, _, _ in steps for i in s]
    assert lists == [int(i) for i in np.argsort(-counts, kind="stable")
                     if counts[i] > 0]
    totals = counts[nbrs].sum(axis=1)
    for s, own, cand in steps:
        assert own % 8 == 0 and cand % 8 == 0
        assert own >= counts[s].max() and cand >= totals[s].max()
        assert len(s) == 1 or len(s) * own * cand * 4 <= budget
    # a budget past the whole tile takes every list in one step
    assert (len(steps) == 1) == (budget == 1 << 30)
