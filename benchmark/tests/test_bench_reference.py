"""The plain reference against brute force in NumPy at small sizes."""

import numpy as np
import pytest
import torch

from benchmark.reference import exact_topk as ref


def brute(x, q, k):
    d = ((q[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    ids = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), d.shape), d),
                     axis=1)[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("n,chunks,d,k", [(1000, 4, 16, 10), (999, 3, 7, 5),
                                          (64, 8, 32, 10)])
def test_exact_topk_is_brute_force(n, chunks, d, k):
    g = np.random.default_rng(n)
    x = g.standard_normal((n, d)).astype(np.float32)
    q = g.standard_normal((37, d)).astype(np.float32)
    rows = n // chunks
    xt = torch.from_numpy(x[:rows * chunks])
    got_d, got_i, _ = ref.exact_topk(
        lambda i: xt[i * rows:(i + 1) * rows], chunks, rows,
        torch.from_numpy(q), k, block_elems=500)
    want_d, want_i = brute(x[:rows * chunks], q, k)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_ties_break_by_lower_id():
    x = torch.zeros((12, 4))
    x[5] = 1.0
    q = torch.zeros((2, 4))
    _, ids, _ = ref.exact_topk(lambda i: x[i * 4:(i + 1) * 4], 3, 4, q, 5)
    assert ids.tolist() == [[0, 1, 2, 3, 4]] * 2


def test_pair_distances():
    g = np.random.default_rng(3)
    x = g.standard_normal((100, 8)).astype(np.float32)
    q = g.standard_normal((5, 8)).astype(np.float32)
    pairs = np.array([[0, 99, -1, 250]] * 5)
    xt = torch.from_numpy(x)
    _, _, pd = ref.exact_topk(lambda i: xt[i * 25:(i + 1) * 25], 4, 25,
                              torch.from_numpy(q), 3,
                              pairs=torch.from_numpy(pairs))
    want = ((q[:, None, :].astype(np.float64) - x[[0, 99]][None]) ** 2
            ).sum(-1)
    np.testing.assert_allclose(pd.numpy()[:, :2], want, rtol=1e-12)
    assert np.isinf(pd.numpy()[:, 2:]).all()


@pytest.mark.parametrize("precision,rel", [("int8", 1 / 127), ("int4", 1 / 7)])
def test_lower_precision_rounds_rows(precision, rel):
    x = torch.randn((50, 64), generator=torch.Generator().manual_seed(0))
    low = ref.lower(x, precision)
    err = (low - x.double()).abs().max(dim=1).values
    top = x.abs().amax(dim=1).double()
    assert (err <= rel * top + 1e-12).all()
    assert (err > 0).any()
    assert torch.equal(ref.lower(x, "float64"), x.double())
