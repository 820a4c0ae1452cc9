"""The port's out-of-core exact re-rank (index/refine.py) against the JAX
package's, on the same candidates and the same fetched rows.

Tolerance: both re-rank with exact fp32 products summed in another order
(the host version in numpy on both sides): distances agree to rtol 1e-5 /
atol 1e-4, ids up to swaps among scores tied with the k-th.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import refine as jrefine
from cuvs_rag_tpu_torch.index import refine as trefine
from torch_parity import compare_topk, to_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, Q, C = 500, 20, 7, 30


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(61)
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    q = (rows[:Q] + 0.2 * rng.standard_normal((Q, DIM))).astype(np.float32)
    ids = np.stack([rng.permutation(N)[:C] for _ in range(Q)]).astype(np.int32)
    ids[:, 0] = np.arange(Q)  # the query's own row is a candidate
    ids[1, 5:9] = -1          # empty slots
    ids[2, 10] = ids[2, 11]   # a duplicate
    ids[3] = -1               # a query with no candidate at all
    return rows, q, ids


def _sign(metric):
    return -1.0 if metric == "sqeuclidean" else 1.0


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
@pytest.mark.parametrize("pad_dim_to", [0, 8])
def test_rerank_external_matches(data, metric, pad_dim_to):
    rows, q, ids = data
    seen = []

    def fetch(u):
        seen.append(u)
        return rows[u] * 3.0 if metric == "cosine" else rows[u]

    d, i = trefine.rerank_external(torch.from_numpy(q), torch.from_numpy(ids),
                                   5, fetch, metric=metric,
                                   pad_dim_to=pad_dim_to)
    rd, ri = jrefine.rerank_external(jnp.asarray(q), jnp.asarray(ids), 5,
                                     fetch, metric=metric,
                                     pad_dim_to=pad_dim_to)
    assert d.shape == (Q, 5) and i.dtype == torch.int32
    np.testing.assert_array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[0], np.unique(ids[ids >= 0]))
    s = _sign(metric)
    compare_topk(s * to_numpy(d), i, s * np.asarray(rd), ri, **TOL)
    assert i[0, 0] == 0 and (i[3] == -1).all()
    if metric == "sqeuclidean":
        assert torch.isinf(d[3]).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
@pytest.mark.parametrize("k", [5, 40])
def test_rerank_host_matches(data, metric, k):
    """k = 40 > the 30 candidates: both pad with -1 and an infinite
    distance."""
    rows, q, ids = data
    d, i = trefine.rerank_host(torch.from_numpy(q), torch.from_numpy(ids), k,
                               lambda u: rows[u], metric=metric)
    rd, ri = jrefine.rerank_host(q, ids, k, lambda u: rows[u], metric=metric)
    assert isinstance(d, np.ndarray) and i.dtype == np.int32
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)
    # and the device version agrees with the host version
    dd, di = trefine.rerank_external(torch.from_numpy(q), ids, k,
                                     lambda u: rows[u], metric=metric)
    s = _sign(metric)
    compare_topk(s * to_numpy(dd), di, s * d, i, **TOL)


def test_no_valid_candidate_never_calls_back(data):
    _, q, ids = data

    def never(u):
        raise AssertionError("fetch_rows called with nothing to fetch")

    none = np.full_like(ids, -1)
    d, i = trefine.rerank_external(torch.from_numpy(q), none, 4, never)
    assert torch.isinf(d).all() and (i == -1).all() and d.shape == (Q, 4)
    d, i = trefine.rerank_host(q, none, 4, never)
    assert np.isinf(d).all() and (i == -1).all()


def test_bad_shapes_raise(data):
    rows, q, ids = data
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError, match="fetch_rows returned"):
        trefine.rerank_external(tq, ids, 3, lambda u: rows[u][:, :-1])
    with pytest.raises(ValueError, match="fetch_rows returned"):
        trefine.rerank_host(q, ids, 3, lambda u: rows[u][:-1])
    with pytest.raises(ValueError, match="ids must be"):
        trefine.rerank_external(tq, ids[:-1], 3, lambda u: rows[u])
    with pytest.raises(ValueError, match="queries must be"):
        trefine.rerank_external(tq[0], ids, 3, lambda u: rows[u])
