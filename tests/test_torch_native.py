"""cuvs_rag_tpu_torch.native (the ctypes bindings of hostops.cpp) against
its numpy plain versions, and the C++ against the JAX package's copy.

Tolerances: top-k merges, int8 quantization and id orders are exact; fp32
sums in another order (brute force, BM25 scores) within rtol 1e-5 / atol
1e-5, and ids equal where scores are not tied.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuvs_rag_tpu_torch import native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpp_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(native.SOURCE,
                       os.path.join(REPO, "cuvs_rag_tpu", "native",
                                    "hostops.cpp"), shallow=False)


def test_builds_into_the_ports_build_dir_only():
    """The library lands under build/native/, keyed by a content hash; the
    JAX package's directory gets no file from the port."""
    before = set(os.listdir(os.path.join(REPO, "cuvs_rag_tpu", "native")))
    lib = native.load()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libhostops_")
    assert set(os.listdir(os.path.join(REPO, "cuvs_rag_tpu", "native"))) \
        == before


def test_a_failed_build_raises(tmp_path):
    """No numpy fallback: a compiler that fails is an error."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from cuvs_rag_tpu_torch import native\n"
        "native.SOURCE = Path(sys.argv[2])\n"
        "native.BUILD_DIR = Path(sys.argv[3])\n"
        "try:\n"
        "    native.load()\n"
        "except RuntimeError as e:\n"
        "    assert 'g++ failed' in str(e), e\n"
        "    print('raised')\n"
    )
    bad = tmp_path / "hostops.cpp"
    bad.write_text("this is not C++\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, REPO, str(bad), str(tmp_path / "b")],
        capture_output=True, text=True, timeout=300)
    assert proc.stdout.strip() == "raised", proc.stderr


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("s,q,k_in,k", [(4, 6, 8, 10), (1, 3, 5, 5),
                                        (3, 2, 4, 20)])
def test_topk_merge_matches_plain(s, q, k_in, k, descending):
    rng = np.random.default_rng(s * 100 + k)
    scores = rng.standard_normal((s, q, k_in)).astype(np.float32)
    scores = np.sort(scores, axis=2)
    if descending:
        scores = scores[:, :, ::-1]
    # distinct ids, some invalid slots at the ends
    ids = rng.permutation(10_000)[:s * q * k_in].reshape(s, q, k_in)
    ids = ids.astype(np.int32)
    ids[:, :, -1] = -1
    got = native.topk_merge(scores, ids, k, descending=descending)
    want = native.topk_merge_plain(scores, ids, k, descending=descending)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][got[1] >= 0], want[0][want[1] >= 0])


@pytest.mark.parametrize("n,k", [(500, 5), (3, 5), (64, 64)])
def test_brute_topk_l2_matches_plain(n, k):
    rng = np.random.default_rng(n)
    corpus = rng.standard_normal((n, 24)).astype(np.float32)
    queries = rng.standard_normal((7, 24)).astype(np.float32)
    got_d, got_i = native.brute_topk_l2(corpus, queries, k)
    want_d, want_i = native.brute_topk_l2_plain(corpus, queries, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 3.0, 0.0])
def test_int8_matches_plain(scale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 16)).astype(np.float32) * scale
    x[3] = 0.0
    x[4, :4] = [0.5, -0.5, 1.5, -127.0]  # exact halves round away from 0
    v, s = native.quantize_int8(x)
    pv, ps = native.quantize_int8_plain(x)
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(s, ps)
    np.testing.assert_array_equal(native.dequantize_int8(v, s),
                                  native.dequantize_int8_plain(v, s))


def _csr(n_docs, n_terms, rng):
    """A random CSR of postings (docs ascending in each term) with tfs."""
    indptr, docs, tfs = [0], [], []
    for _ in range(n_terms):
        df = int(rng.integers(0, n_docs // 2))
        d = np.sort(rng.choice(n_docs, df, replace=False))
        docs.append(d)
        tfs.append(rng.integers(1, 5, df).astype(np.float32))
        indptr.append(indptr[-1] + df)
    return (np.asarray(indptr, np.int64), np.concatenate(docs).astype(np.int64),
            np.concatenate(tfs))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_bm25_scorers_match_plain(seed, k):
    """Both native scorers (dense accumulate, DAAT MaxScore) against the
    numpy plain version on a random CSR, with a mask, an unknown term id
    and an empty query: ids equal, ties by ascending doc id."""
    rng = np.random.default_rng(seed)
    n_docs, n_terms = 200, 40
    indptr, docs, tfs = _csr(n_docs, n_terms, rng)
    norm = (0.25 + 0.75 * rng.random(n_docs) * 2).astype(np.float32)
    mask = rng.random(n_docs) > 0.2
    queries = [rng.choice(n_terms, int(rng.integers(1, 8)), replace=False)
               for _ in range(6)] + [np.array([], np.int64),
                                     np.array([n_terms + 5, 3])]
    q_tids = np.concatenate(queries).astype(np.int64)
    q_idf = rng.random(len(q_tids)).astype(np.float32) + 0.1
    q_off = np.cumsum([0] + [len(q) for q in queries]).astype(np.int64)
    args = (indptr, docs, tfs, norm, 1.2, q_tids, q_idf, q_off, mask, k)
    want = native.bm25_score_topk_plain(*args)
    got = native.bm25_score_topk(*args, nthreads=3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    tfmax = np.zeros(n_terms, np.float32)
    for t in range(n_terms):
        if indptr[t + 1] > indptr[t]:
            tfmax[t] = tfs[indptr[t]:indptr[t + 1]].max()
    tfm = np.where(q_tids < n_terms, tfmax[np.minimum(q_tids, n_terms - 1)],
                   0.0)
    bounds = np.where(tfm > 0, q_idf * tfm * 2.2 / (tfm + 1.2 * norm.min()),
                      0.0).astype(np.float32)
    got = native.bm25_maxscore_topk(indptr, docs, tfs, norm, 1.2, q_tids,
                                    q_idf, bounds, q_off, mask, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_bm25_matches_the_jax_packages_native():
    """The same library in both packages: equal outputs on one input."""
    from cuvs_rag_tpu import native as jnative

    rng = np.random.default_rng(5)
    indptr, docs, tfs = _csr(300, 30, rng)
    norm = np.ones(300, np.float32)
    q_tids = np.arange(10, dtype=np.int64)
    q_idf = np.linspace(0.5, 2, 10).astype(np.float32)
    q_off = np.array([0, 4, 10], np.int64)
    mask = np.ones(300, bool)
    got = native.bm25_score_topk(indptr, docs, tfs, norm, 1.2, q_tids, q_idf,
                                 q_off, mask, 7)
    want = jnative.bm25_score_topk(indptr, docs, tfs, norm, 1.2, q_tids,
                                   q_idf, q_off, mask, 7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
