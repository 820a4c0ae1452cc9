"""cuvs_rag_tpu_torch.rag.lexical against the JAX package's rag/lexical.py
on the same texts: the postings, the scores and ids of both the native and
the numpy scorer, through extend (delta and compaction), delete, allow
masks, max_df_frac, and the .npz file and retriever directory both ways.

Tolerances: postings, ids and the saved arrays are exact; BM25 scores are
fp32 sums taken in the same order by the same code (native) or in another
order (numpy against native), within rtol 1e-5 / atol 1e-6.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.rag import lexical as jlex
from cuvs_rag_tpu.rag.corpus import Corpus as JCorpus
from cuvs_rag_tpu_torch.rag import lexical as tlex
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.datasets import synthetic_medical_qa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ARRAYS = ("df", "indptr", "post_docs", "post_tfs", "doc_len", "alive")


def _texts(n=400, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    zipf = np.minimum(rng.zipf(1.3, 20_000), 300) - 1
    out, pos = [], 0
    for _ in range(n):
        m = int(rng.integers(0, 30))
        out.append(" ".join(words[j] for j in zipf[pos:pos + m]))
        pos += m
    qa = synthetic_medical_qa(100, seed=seed)
    return out + [f"{r.input} {r.output}" for r in qa] + ["", "   ", "Don't!"]


def _queries(seed=1):
    rng = np.random.default_rng(seed)
    qs = [" ".join(f"w{j}" for j in rng.integers(0, 300, int(m)))
          for m in rng.integers(1, 6, 12)]
    return qs + ["asthma symptoms", "treatment options for migraine",
                 "nothing-here", "", "w0 w0 w1"]


def _same_index(a, b):
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.vocab == b.vocab
    assert a._delta == b._delta and a._delta_nnz == b._delta_nnz


def _same_search(a, b, queries, k, **kw):
    sa, ia = a.search(queries, k, **kw)
    sb, ib = b.search(queries, k, **kw)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, **TOL)
    return sa, ia


@pytest.mark.parametrize("params", [dict(), dict(k1=0.9, b=0.4),
                                    dict(max_df_frac=0.05)])
def test_build_and_search_equal_the_jax_package(params):
    texts = _texts()
    a = tlex.BM25Index.build(texts, tlex.BM25Params(**params))
    b = jlex.BM25Index.build(texts, jlex.BM25Params(**params))
    _same_index(a, b)
    for k in (1, 5, 50):
        _same_search(a, b, _queries(), k)


@pytest.mark.parametrize("native", ["1", "0"])
def test_native_and_numpy_scorers_equal_the_jax_package(monkeypatch, native):
    """CUVS_RAG_TPU_BM25_NATIVE=0 takes the numpy scorer in both packages;
    the port's native scorer and numpy scorer agree with each other too."""
    texts = _texts(seed=3)
    a, b = tlex.BM25Index.build(texts), jlex.BM25Index.build(texts)
    monkeypatch.setenv("CUVS_RAG_TPU_BM25_NATIVE", native)
    got = _same_search(a, b, _queries(4), 10)
    monkeypatch.setenv("CUVS_RAG_TPU_BM25_NATIVE", "1" if native == "0" else "0")
    other = a.search(_queries(4), 10)
    np.testing.assert_array_equal(other[1], got[1])
    np.testing.assert_allclose(other[0], got[0], **TOL)


def test_the_maxscore_route_equals_the_jax_package(monkeypatch):
    """A batch whose walk passes 200,000 postings takes DAAT MaxScore."""
    texts = ["a b c " + " ".join(f"t{i % 50}" for i in range(j % 7))
             for j in range(60_000)]
    a, b = tlex.BM25Index.build(texts), jlex.BM25Index.build(texts)
    qs = ["a b t3", "c t1 t2", "b"] * 3
    s, i = _same_search(a, b, qs, 10)
    monkeypatch.setenv("CUVS_RAG_TPU_BM25_NATIVE", "0")
    s2, i2 = a.search(qs, 10)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_allclose(s2, s, **TOL)


def test_extend_delete_and_compaction_equal_the_jax_package():
    """A small extend stays in the delta (the numpy scorer reads it), a
    large one compacts; deletes and allow masks (short ones included)."""
    texts = _texts(200, seed=5)
    a, b = tlex.BM25Index.build(texts), jlex.BM25Index.build(texts)
    more = _texts(30, seed=6)
    assert a.extend(more[:3]) == b.extend(more[:3])
    assert a._delta_nnz > 0
    _same_index(a, b)
    _same_search(a, b, _queries(7), 10)
    a.delete([0, 5, 201]), b.delete([0, 5, 201])
    _same_search(a, b, _queries(7), 10)
    assert a.extend(more) == b.extend(more)  # past 25% of the CSR: compacts
    _same_index(a, b)
    allow = np.arange(a.n_docs) % 3 != 0
    s, i = _same_search(a, b, _queries(8), 10, allow=allow)
    assert allow[i[i >= 0]].all()
    short = np.ones(100, bool)  # rows past a short mask are excluded
    s, i = _same_search(a, b, _queries(8), 10, allow=short)
    assert (i < 100).all()
    with pytest.raises(ValueError):
        a.delete([a.n_docs])


def test_npz_files_load_both_ways(tmp_path):
    texts = _texts(seed=9)
    a, b = tlex.BM25Index.build(texts), jlex.BM25Index.build(texts)
    a.extend(["late text w1 w2"]), b.extend(["late text w1 w2"])
    a.delete([3]), b.delete([3])
    a.save(str(tmp_path / "port.npz"))
    b.save(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zp.files:
            np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)
    jb = jlex.BM25Index.load(str(tmp_path / "port.npz"))
    ta = tlex.BM25Index.load(str(tmp_path / "jax.npz"))
    _same_index(ta, jb)
    _same_search(ta, jb, _queries(10), 10)


def test_lexical_retrievers_load_both_ways(tmp_path):
    texts = _texts(120, seed=11)
    titles = [f"t{i}" for i in range(len(texts))]
    tr = tlex.LexicalRetriever(Corpus(passages=list(texts), titles=titles))
    jr = jlex.LexicalRetriever(JCorpus(passages=list(texts), titles=titles))
    for r in (tr, jr):
        r.extend(["an added passage about asthma"], titles=["new"])
        r.delete([2])
    tr.save(str(tmp_path / "port"))
    jr.save(str(tmp_path / "jax"))
    t2 = tlex.LexicalRetriever.load(str(tmp_path / "jax"))
    j2 = jlex.LexicalRetriever.load(str(tmp_path / "port"))
    for x, y in ((tr, j2), (t2, jr), (t2, j2)):
        rx = x.retrieve_batch(_queries(12), 7)
        ry = y.retrieve_batch(_queries(12), 7)
        assert [[(p.index, p.text, p.title) for p in r.passages] for r in rx] \
            == [[(p.index, p.text, p.title) for p in r.passages] for r in ry]
        for r1, r2 in zip(rx, ry):
            np.testing.assert_allclose([p.distance for p in r1.passages],
                                       [p.distance for p in r2.passages],
                                       **TOL)
    d, i = tr.retrieve_ids(["asthma added"], 3)
    assert i[0, 0] == len(texts)


def test_retriever_surface_rejects_what_it_cannot_do():
    r = tlex.LexicalRetriever(Corpus(passages=_texts(20)))
    with pytest.raises(ValueError):
        r.retrieve_batch(["x"], 2, index=object())
    with pytest.raises(ValueError):
        r.extend(None)
    with pytest.raises(ValueError):
        r.extend(["a"], vectors=np.zeros((1, 4)))
    with pytest.raises(ValueError):
        r.extend(["a", "b"], titles=["only one"])
    assert r.metric == "bm25" and r.family == "bm25"


def test_empty_texts_skip_the_tokenizer_and_keep_the_postings():
    """A corpus of mostly empty passages (a vector corpus without text)
    builds the same CSR as the JAX package's."""
    texts = [""] * 5000
    for j in range(0, 5000, 97):
        texts[j] = f"passage {j} w{j % 13} w{j % 7}"
    a, b = tlex.BM25Index.build(texts), jlex.BM25Index.build(texts)
    _same_index(a, b)
    _same_search(a, b, ["passage 97 w6", "w1"], 5)


def test_searches_beside_extend_and_delete_stay_consistent():
    """Four searching threads beside one that extends and deletes (the
    daemon's pattern): no search fails, no id past the corpus returns, and
    a deleted doc never returns after its delete."""
    ix = tlex.BM25Index.build(_texts(300, seed=13))
    errors, stop = [], threading.Event()
    gone = set()

    def searcher():
        try:
            while not stop.is_set():
                dead = set(gone)
                n = ix.n_docs
                _, ids = ix.search(["w1 w2 w3", "asthma", "w5"], 20)
                live = ids[ids >= 0]
                if (live >= ix.n_docs).any() or (dead & set(live.tolist())):
                    errors.append((n, sorted(dead & set(live.tolist()))))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        for j in range(40):
            ix.extend([f"w1 w2 new{j}", "asthma w3"])
            ix.delete([j])
            gone.add(j)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
