"""The port's IVF-Flat index and recall oracle against the JAX package's, on
the same seeded numpy corpora.

Indexes cross between the packages through their npz files, so both sides
search the same layout. Tolerance: both sides score with exact products of
the same fp32/bf16/int8 operands summed in fp32 in another order, so
distances agree to rtol 1e-5 / atol 1e-4 (they reach ~1e2 here), and ids up
to swaps among distances tied with the k-th. Builds differ by RNG (a
`torch.Generator` cannot draw `jax.random`'s numbers), so the port's own
build is held to the JAX build's recall, not to its ids.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.eval import recall as jrecall
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.utils.config import IVFFlatParams as JParams
from cuvs_rag_tpu.utils.config import IVFFlatSearchParams as JSearch
from cuvs_rag_tpu_torch.eval import recall as trecall
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.index import ivf_flat as tivf
from cuvs_rag_tpu_torch.utils.config import IVFFlatParams, IVFFlatSearchParams
from torch_parity import compare_topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, LISTS, PROBES = 3000, 32, 16, 6


def _corpus(seed=31, n=N, c=24):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, DIM)).astype(np.float32)
    x = cent[rng.integers(0, c, n)] + 0.5 * rng.standard_normal((n, DIM))
    q = x[:12] + 0.1 * rng.standard_normal((12, DIM))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _corpus()


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """npz files of JAX-built indexes, one per (dtype, metric)."""
    x, _ = data
    out = {}
    for dtype, metric in (("float32", "sqeuclidean"), ("bfloat16", "sqeuclidean"),
                          ("int8", "sqeuclidean"), ("float32", "cosine")):
        ix = jivf.build(JParams(n_lists=LISTS, dtype=dtype, metric=metric),
                        jnp.asarray(x))
        path = str(tmp_path_factory.mktemp("jivf") / f"{dtype}_{metric}.npz")
        jio.save_index(path, ix)
        out[dtype, metric] = path
    return out


def _same(tix, jix, q, k):
    d, i = tivf.search(IVFFlatSearchParams(n_probes=PROBES), tix,
                       torch.from_numpy(q), k)
    rd, ri = jivf.search(JSearch(n_probes=PROBES), jix, jnp.asarray(q), k)
    assert d.shape == i.shape == (q.shape[0], k) and i.dtype == torch.int32
    compare_topk(-d, i, -np.asarray(rd), np.asarray(ri), **TOL)
    return i.numpy()


@pytest.mark.parametrize("dtype,metric", [
    ("float32", "sqeuclidean"), ("bfloat16", "sqeuclidean"),
    ("int8", "sqeuclidean"), ("float32", "cosine"),
])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_load_search_matches_jax(data, jax_files, tmp_path, dtype,
                                       metric, direction):
    """A file saved by either package loads in the other and searches the
    same, at k = 10 (K4), 64 (K5) and 300 (K5, more planes), with deletions."""
    x, q = data
    if direction == "jax_to_torch":
        jix = jivf.delete(jio.load_index(jax_files[dtype, metric]),
                          np.arange(0, N, 41))
        path = str(tmp_path / "j.npz")
        jio.save_index(path, jix)
        tix = tio.load_index(path, device="cpu")
    else:
        tix = tivf.build(IVFFlatParams(n_lists=LISTS, dtype=dtype,
                                       metric=metric), x, device="cpu")
        tix = tivf.delete(tix, np.arange(0, N, 41))
        path = str(tmp_path / "t.npz")
        tio.save_index(path, tix)
        jix = jio.load_index(path)
    assert tix.n_valid == int(jix.n_valid) == N
    for k in (10, 64, 300):
        ids = _same(tix, jix, q, k)
        assert not np.isin(ids, np.arange(0, N, 41)).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_own_build_recall_close_to_jax(data, dtype):
    """Mean recall@10 (2 probes) of the port's own builds over three seeds
    is within 0.02 of the JAX builds' at the same params, and no list
    exceeds the balance cap. One seed alone varies by up to ~0.015 on
    either side at this size, hence the mean."""
    x, _ = data
    rng = np.random.default_rng(32)
    q = (x[rng.integers(0, N, 64)]
         + 0.3 * rng.standard_normal((64, DIM))).astype(np.float32)
    gt = trecall.exact_ground_truth(x, q, 10, "sqeuclidean",
                                    device="cpu")
    np.testing.assert_array_equal(
        gt, jrecall.exact_ground_truth(x, q, 10, "sqeuclidean"))
    params = dict(n_lists=LISTS, dtype=dtype)
    tr, jr = [], []
    for seed in range(3):
        tix = tivf.build(IVFFlatParams(**params), x, seed=seed, device="cpu")
        jix = jivf.build(JParams(**params), jnp.asarray(x), seed=seed)
        _, ti = tivf.search(IVFFlatSearchParams(n_probes=2), tix, q, 10)
        _, ji = jivf.search(JSearch(n_probes=2), jix, jnp.asarray(q), 10)
        tr.append(trecall.recall_at_k(ti.numpy(), gt, 10))
        jr.append(jrecall.recall_at_k(np.asarray(ji), gt, 10))
        assert tr[-1] == jrecall.recall_at_k(ti.numpy(), gt, 10)
        assert int(tix.list_counts.max()) <= int(np.ceil(2.0 * N / LISTS))
    assert abs(np.mean(tr) - np.mean(jr)) <= 0.02, (tr, jr)


def test_recall_helpers_match_jax(data):
    """recall_multiple_k and the streamed and chunked oracles give the JAX
    package's numbers and ids."""
    x, q = data
    gt = jrecall.exact_ground_truth(x, q, 20, "inner_product")
    streamed = trecall.exact_ground_truth_streamed(
        torch.from_numpy(x), q, 20, "inner_product", chunk_rows=700)
    chunked = trecall.exact_ground_truth_chunks(
        lambda i: x[i * 1000:(i + 1) * 1000], 3, 1000, q, 20, "inner_product",
        device="cpu")
    np.testing.assert_array_equal(streamed, gt)
    np.testing.assert_array_equal(chunked, gt)
    got = np.roll(gt, 1, axis=0)
    assert trecall.recall_multiple_k(got, gt, [1, 5, 20, 50]) \
        == jrecall.recall_multiple_k(got, gt, [1, 5, 20, 50])


def _extend_rows(x, path, rng):
    """Rows for the extend cases: a few near corpus rows (they fit the
    lists' slack: the in-place path), or 600 next to one row (one list
    overflows: the re-layout)."""
    if path == "fast":
        return x[:3] + 0.01 * rng.standard_normal((3, DIM)).astype(np.float32)
    return x[5] + 0.01 * rng.standard_normal((600, DIM)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("path", ["fast", "overflow"])
def test_extend_keeps_deleted_rows_deleted(data, jax_files, dtype, path):
    """Delete, extend, delete again, extend: the port follows the JAX
    package step by step, deleted rows never come back (the overflow
    re-layout re-applies the tombstones), and new rows get the next ids."""
    x, q = data
    rng = np.random.default_rng(33)
    jix = jio.load_index(jax_files[dtype, "sqeuclidean"])
    tix = tio.load_index(jax_files[dtype, "sqeuclidean"], device="cpu")
    size0 = tix.size
    gone = np.array([1, 2, 7, 500, 2999])
    jix, tix = jivf.delete(jix, gone), tivf.delete(tix, gone)
    new = _extend_rows(x, path, rng)
    jix = jivf.extend(jix, jnp.asarray(new))
    tix = tivf.extend(tix, torch.from_numpy(new))
    assert (tix.size == size0) == (path == "fast")
    assert tix.size == jix.size and tix.max_list_size == jix.max_list_size
    jix, tix = jivf.delete(jix, [N]), tivf.delete(tix, [N])
    gone = np.append(gone, N)
    np.testing.assert_array_equal(tivf.deleted_ids(tix), gone)
    np.testing.assert_array_equal(tivf.deleted_ids(tix), jivf.deleted_ids(jix))
    more = x[9:11] + 0.01
    jix = jivf.extend(jix, jnp.asarray(more))
    tix = tivf.extend(tix, torch.from_numpy(more))
    total = N + new.shape[0] + 2
    assert tix.n_valid == int(jix.n_valid) == total
    np.testing.assert_array_equal(tivf.deleted_ids(tix), gone)
    queries = np.concatenate([q, new[:2], more])
    ids = _same(tix, jix, queries, 10)
    assert not np.isin(ids, gone).any()
    assert ids[-2:, 0].tolist() == [total - 2, total - 1]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_from_chunks_equals_build(data, dtype):
    """Chunk by chunk, the port builds the very index build() makes from the
    concatenation."""
    x, _ = data
    params = IVFFlatParams(n_lists=LISTS, dtype=dtype, balance_factor=1.2,
                           kmeans_sample=1500)
    whole = tivf.build(params, x, seed=3, device="cpu")
    chunked = tivf.build_from_chunks(params, lambda i: x[i * 500:(i + 1) * 500],
                                     N, DIM, n_chunks=6, seed=3, device="cpu")
    for name in tivf.IVFFlatIndex._tensor_fields:
        assert torch.equal(getattr(chunked, name), getattr(whole, name)), name
    assert (chunked.n_valid, chunked.max_list_size) \
        == (whole.n_valid, whole.max_list_size)
    with pytest.raises(ValueError, match="divide"):
        tivf.build_from_chunks(params, lambda i: x, N, DIM, n_chunks=7,
                               device="cpu")


def test_train_then_extend_matches_jax(data, tmp_path):
    """FAISS train/add: a JAX-trained empty index, extended in two batches
    by each package, searches the same; and the port's own trained index
    finds each added row first."""
    x, q = data
    jix = jivf.train(JParams(n_lists=LISTS), jnp.asarray(x[:800]))
    path = str(tmp_path / "trained.npz")
    jio.save_index(path, jix)
    tix = tio.load_index(path, device="cpu")
    assert tix.n_valid == 0 and int(tix.list_counts.sum()) == 0
    for part in (x[:1200], x[1200:]):
        jix = jivf.extend(jix, jnp.asarray(part))
        tix = tivf.extend(tix, torch.from_numpy(part))
    assert tix.n_valid == N
    _same(tix, jix, q, 10)

    own = tivf.train(IVFFlatParams(n_lists=LISTS, dtype="bfloat16"), x[:800],
                     device="cpu")
    assert own.vectors.dtype == torch.bfloat16 and own.n_lists == LISTS
    own = tivf.extend(own, torch.from_numpy(x))
    _, ids = tivf.search(IVFFlatSearchParams(n_probes=PROBES), own,
                         torch.from_numpy(x[:20]), 5)
    assert ids[:, 0].tolist() == list(range(20))


def test_delete_is_idempotent_and_ignores_unknown_ids(jax_files):
    tix = tio.load_index(jax_files["float32", "sqeuclidean"], device="cpu")
    once = tivf.delete(tix, [3, 3, -5, N, 10 ** 9, 8])
    twice = tivf.delete(once, [3, 8])
    np.testing.assert_array_equal(tivf.deleted_ids(twice), [3, 8])
    assert torch.equal(once.sqnorms, twice.sqnorms)
    assert tivf.delete(tix, []) is tix


def test_failed_certificate_reruns_the_exact_scan_and_counts_it(jax_files):
    """One probed list holds fewer than k = 1000 rows, so no row can be
    certified: search re-runs scan_probed_lists, counts the re-run, and
    returns the JAX package's exact answer (-1 past the reachable rows)."""
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    _, q = _corpus()
    tix = tio.load_index(jax_files["bfloat16", "sqeuclidean"], device="cpu")
    jix = jio.load_index(jax_files["bfloat16", "sqeuclidean"])
    before = default_registry.snapshot()["counters"].get(
        "ivf_flat.certificate_reruns", 0)
    d, i = tivf.search(IVFFlatSearchParams(n_probes=1), tix,
                       torch.from_numpy(q), 1000)
    after = default_registry.snapshot()["counters"]["ivf_flat.certificate_reruns"]
    assert after == before + 1
    rd, ri = jivf.search(JSearch(n_probes=1), jix, jnp.asarray(q), 1000)
    compare_topk(-d, i, -np.asarray(rd), np.asarray(ri), **TOL)
    assert (i[:, -1] == -1).all()
