"""The plain PyTorch versions of the measurement kernels M1-M4 against numpy
on the CPU: `read_all_plain` against the (8, 128) fold of
scripts/bench_roofline.py:57-63 written out in numpy, `gather_rows_plain`
and `gather_reduce_plain` against numpy indexing (what `vectors[ids]`,
`dynamic_slice` and `.sum(0)` compute in scripts/bench_gather_modes.py).

Maxima and copies are exact; the fp32 sum is held to rtol 1e-5 / atol 1e-4
(numpy adds in another order; unit-variance values, sums of a few hundred).
"""

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch.ops import stream_kernels as sk

torch.set_num_threads(1)


def _bf16(a):
    """A float array rounded to bf16: (tensor, the same values as fp32)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, t.float().numpy()


def _fold_reduce(x):
    """bench_roofline.py:57-60 on one tile that holds every row."""
    return np.max(x.reshape(x.shape[0] // 8, 8, x.shape[1] // 128, 128),
                  axis=(0, 2))


def _fold_touch(x, tile_c):
    """bench_roofline.py:63 folded over the tiles: each tile's corner."""
    acc = np.full((8, 128), -np.inf, np.float32)
    for j in range(x.shape[0] // tile_c):
        acc = np.maximum(acc, x[j * tile_c:(j + 1) * tile_c][:8, :128])
    return acc


@pytest.mark.parametrize("n,d", [(2048, 128), (3072, 384), (1024, 768)])
@pytest.mark.parametrize("full_reduce", [True, False])
def test_read_all_matches_the_roofline_fold(n, d, full_reduce):
    t, x = _bf16(np.random.default_rng(n + d).standard_normal((n, d)))
    got = sk.read_all(t, full_reduce)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    want = _fold_reduce(x) if full_reduce else _fold_touch(x, sk.TILE_ROWS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 8, 1031, 2051])
@pytest.mark.parametrize("full_reduce", [True, False])
def test_read_all_on_ragged_row_counts(n, full_reduce):
    """Any n: rows are of class row mod 8 (reduce) or folded when row mod
    TILE_ROWS < 8 (touch); a class no row falls in stays -inf."""
    t, x = _bf16(np.random.default_rng(n).standard_normal((n, 256)))
    want = np.full((8, 128), -np.inf, np.float32)
    for r in range(n):
        if full_reduce:
            want[r % 8] = np.maximum(want[r % 8],
                                     x[r].reshape(2, 128).max(axis=0))
        elif r % sk.TILE_ROWS < 8:
            want[r % 8] = np.maximum(want[r % 8], x[r, :128])
    np.testing.assert_array_equal(sk.read_all_plain(t, full_reduce).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("span", [1, 32])
def test_gather_rows_matches_numpy(dtype, span):
    rng = np.random.default_rng(span)
    x = (rng.standard_normal((500, 48)) * 40).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    ids = rng.integers(0, 500 - span + 1, 64)
    ids[:20] = ids[20]  # duplicate ids
    got = sk.gather_rows(t, torch.from_numpy(ids), span)
    assert got.dtype == t.dtype and got.shape == (64 * span, 48)
    rows = (ids[:, None] + np.arange(span)).reshape(-1)
    assert torch.equal(got, t[torch.from_numpy(rows)])
    before = sk.gather_rows.launches
    sk.gather_rows(t, torch.from_numpy(ids).to(torch.int32), span)
    assert sk.gather_rows.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_gather_reduce_matches_numpy(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    x = x * 40 if dtype == "int8" else x  # unit variance, or integers
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    ids = rng.integers(0, 300, 1000)
    ids[:500] = 0  # half the ids name row 0
    got = sk.gather_reduce(t, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (64,)
    want = t.float().numpy()[ids].astype(np.float64).sum(0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fn,ids,span", [
    ("gather_rows", [0, 100], 1), ("gather_rows", [-1], 1),
    ("gather_rows", [69], 32), ("gather_reduce", [100], None),
])
def test_ids_out_of_range_raise(fn, ids, span):
    t = torch.zeros((100, 16), dtype=torch.bfloat16)
    args = (t, torch.tensor(ids)) + ((span,) if span else ())
    with pytest.raises(IndexError, match="leave the 100 rows"):
        getattr(sk, fn)(*args)


@pytest.mark.parametrize("bad", ["dtype", "width", "ndim", "float_ids",
                                 "empty_ids", "span"])
def test_shapes_are_validated(bad):
    t = torch.zeros((64, 128), dtype=torch.bfloat16)
    ids = torch.tensor([1, 2])
    with pytest.raises(ValueError):
        if bad == "dtype":
            sk.read_all(t.float(), True)
        elif bad == "width":
            sk.read_all(t[:, :100], True)
        elif bad == "ndim":
            sk.gather_rows(t[0], ids)
        elif bad == "float_ids":
            sk.gather_rows(t, ids.float())
        elif bad == "empty_ids":
            sk.gather_reduce(t, ids[:0])
        elif bad == "span":
            sk.gather_rows(t, ids, 0)
