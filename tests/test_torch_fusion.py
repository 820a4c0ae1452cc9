"""cuvs_rag_tpu_torch.rag.fusion against the JAX package's rag/fusion.py:
the fusion rules on the same arrays, and HybridRetriever (flat + BM25 over
one corpus object, HashingEncoder queries) with the same fused ids, through
allow masks, extend, delete and save/load both ways. Also the port's
deliberate differences: extend commits nothing when an engine would fail,
a mask object seen once takes allow= (no cached view), shared embeddings
on a device grow there.

Tolerances: fused ids exact (RRF is rank-only; z-scores come from
distances equal within ~1e-6, and the corpus embeddings carry a 1e-3
seeded jitter so that no two docs tie); the rules' inputs are identical.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from cuvs_rag_tpu.models.encoder import HashingEncoder as JHashingEncoder
from cuvs_rag_tpu.rag import fusion as jfusion
from cuvs_rag_tpu.rag import lexical as jlex
from cuvs_rag_tpu.rag.corpus import Corpus as JCorpus
from cuvs_rag_tpu.rag.pipeline import Retriever as JRetriever
from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
from cuvs_rag_tpu_torch.rag import fusion
from cuvs_rag_tpu_torch.rag import lexical as tlex
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.pipeline import Retriever

torch.set_num_threads(1)

DIM = 64


def _lists(seed, engines=3, q=5, k=8, pad=True):
    rng = np.random.default_rng(seed)
    ids, scores = [], []
    for e in range(engines):
        i = np.stack([rng.choice(40, k, replace=False) for _ in range(q)])
        if pad:
            i[:, k - 1 - e:] = -1
        s = -np.sort(-rng.standard_normal((q, k)), axis=1)
        ids.append(i.astype(np.int64))
        scores.append(s)
    return ids, scores


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weights", [None, [1.0, 2.5, 0.5]])
def test_fusion_rules_equal_the_jax_package(seed, weights):
    ids, scores = _lists(seed)
    for k in (1, 5, 12):
        np.testing.assert_array_equal(
            fusion.rrf_fuse(ids, k, weights), jfusion.rrf_fuse(ids, k, weights))
        np.testing.assert_array_equal(
            fusion.rrf_fuse(ids, k, weights, c=7.0),
            jfusion.rrf_fuse(ids, k, weights, c=7.0))
        np.testing.assert_array_equal(
            fusion.zscore_fuse(ids, scores, k, weights),
            jfusion.zscore_fuse(ids, scores, k, weights))
    cand_i = np.concatenate(ids, axis=1)
    cand_s = np.concatenate(scores, axis=1)
    np.testing.assert_array_equal(fusion._fuse_candidates(cand_i, cand_s, 9),
                                  jfusion._fuse_candidates(cand_i, cand_s, 9))


def test_fusion_rules_validate_like_the_jax_package():
    ids, scores = _lists(0, engines=2)
    for mod in (fusion, jfusion):
        with pytest.raises(ValueError):
            mod.rrf_fuse([], 3)
        with pytest.raises(ValueError):
            mod.rrf_fuse(ids, 3, weights=[1.0])
        with pytest.raises(ValueError):
            mod.zscore_fuse(ids, scores[:1], 3)
        assert (mod.rrf_fuse([np.full((2, 3), -1)], 2) == -1).all()


def _passages(n=240, seed=5):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(120)]
    return [f"doc {i} " + " ".join(rng.choice(words, int(rng.integers(3, 15))))
            for i in range(n)]


def _embeddings(passages, seed=6):
    rng = np.random.default_rng(seed)
    emb = HashingEncoder(dim=DIM).encode(passages)
    return (emb + 1e-3 * rng.standard_normal(emb.shape)).astype(np.float32)


def _queries():
    return ["doc 3 t1 t2", "t40 t41", "t7", "doc 100", "nothing at all",
            "t1 t2 t3 t4 t5 t6"]


def _hybrids(method="zscore", **kw):
    """The JAX hybrid and the port's over the same passages, embeddings
    and hashing encoder (flat fp32 + BM25 sharing one corpus object)."""
    passages = _passages()
    emb = _embeddings(passages)
    jc = JCorpus(passages=list(passages), embeddings=emb.copy())
    tc = Corpus(passages=list(passages), embeddings=emb.copy())
    jh = jfusion.HybridRetriever(
        [JRetriever.build(jc, JHashingEncoder(dim=DIM)),
         jlex.LexicalRetriever(jc)], method=method, **kw)
    th = fusion.HybridRetriever(
        [Retriever.build(tc, HashingEncoder(dim=DIM), device="cpu"),
         tlex.LexicalRetriever(tc)], method=method, **kw)
    return jh, th


def _fused(h, queries, k, **kw):
    return [[p.index for p in r.passages] for r in h.retrieve_batch(
        queries, k, **kw)]


@pytest.mark.parametrize("method", ["zscore", "rrf"])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_hybrid_fused_ids_equal_the_jax_package(method, k):
    jh, th = _hybrids(method)
    assert _fused(th, _queries(), k) == _fused(jh, _queries(), k)


@pytest.mark.parametrize("method", ["zscore", "rrf"])
def test_hybrid_with_weights_fetch_k_and_masks(method):
    jh, th = _hybrids(method, weights=[2.0, 0.5], fetch_k=24)
    allow = np.arange(240) % 4 != 1
    for _ in range(3):  # one mask object, seen again: the port bakes views
        got = _fused(th, _queries(), 6, allow=allow)
        assert got == _fused(jh, _queries(), 6, allow=allow)
        assert all(allow[i] for r in got for i in r)


def test_a_mask_seen_once_takes_allow_and_bakes_no_view():
    """A fresh mask object per call never enters the view cache (the JAX
    package baked one for every new mask); the same object seen again is
    baked and served from the cache; results are the same either way."""
    _, th = _hybrids()
    base = np.arange(240) % 3 != 0
    first = _fused(th, _queries(), 5, allow=base.copy())
    for _ in range(3):
        assert _fused(th, _queries(), 5, allow=base.copy()) == first
    assert th._view_cache == {}
    assert _fused(th, _queries(), 5, allow=base) == first
    assert th._view_cache == {}  # first sight of `base`
    assert _fused(th, _queries(), 5, allow=base) == first
    assert len(th._view_cache) == 1  # the dense engine's baked view
    (allow, ix, _), = th._view_cache.values()
    assert allow is base and ix is th.retrievers[0].index


def test_extend_and_delete_equal_the_jax_package():
    jh, th = _hybrids()
    new = ["doc new t1 t2 t3", "another new one t99"]
    assert th.extend(new, titles=None) == jh.extend(new)
    assert len(th.corpus.passages) == len(jh.corpus.passages) == 242
    assert th.retrievers[1].bm25.n_docs == 242
    np.testing.assert_allclose(th.corpus.embeddings, jh.corpus.embeddings,
                               atol=0)
    th.delete([0, 240]), jh.delete([0, 240])
    qs = _queries() + new
    assert _fused(th, qs, 8) == _fused(jh, qs, 8)
    assert all(0 not in r and 240 not in r for r in _fused(th, qs, 8))


class _Broken:
    """An encoder whose vectors do not fit the index."""

    dim = DIM + 1

    def encode(self, texts, batch_size=0):
        return np.ones((len(texts), DIM + 1), np.float32)


def test_extend_commits_nothing_when_an_engine_would_fail():
    """Engine 0 (BM25) would grow the shared corpus first; the dense
    engine's encoder gives vectors of the wrong width, and a second dense
    engine's index growth raises: the port checks both before any commit,
    so every engine keeps its length."""
    passages = _passages(60)
    corpus = Corpus(passages=list(passages), embeddings=_embeddings(passages))
    dense = Retriever.build(corpus, HashingEncoder(dim=DIM), device="cpu")
    lex = tlex.LexicalRetriever(corpus)
    h = fusion.HybridRetriever([lex, dense])
    index0 = dense.index
    dense.encoder = _Broken()
    with pytest.raises(ValueError, match="encoder gives"):
        h.extend(["a new passage"])
    dense.encoder = HashingEncoder(dim=DIM)

    def fail(vectors):
        raise RuntimeError("device out of memory")

    dense._build_extended_index = fail
    with pytest.raises(RuntimeError, match="out of memory"):
        h.extend(["a new passage"])
    assert len(corpus.passages) == 60 and lex.bm25.n_docs == 60
    assert len(corpus.embeddings) == 60 and dense.index is index0
    del dense._build_extended_index
    assert h.extend(["a new passage"]) == range(60, 61)
    assert len(corpus.embeddings) == 61 and dense.index.n_valid == 61


def test_shared_tensor_embeddings_grow_on_their_device():
    passages = _passages(50)
    emb = torch.from_numpy(_embeddings(passages)).to(torch.bfloat16)
    corpus = Corpus(passages=list(passages), embeddings=emb)
    a = Retriever.build(corpus, HashingEncoder(dim=DIM), device="cpu")
    b = Retriever.build(corpus, HashingEncoder(dim=DIM), device="cpu")
    h = fusion.HybridRetriever([tlex.LexicalRetriever(corpus), a, b])
    h.extend(["grown t1", "grown t2"])
    assert isinstance(corpus.embeddings, torch.Tensor)
    assert corpus.embeddings.dtype == torch.bfloat16
    assert corpus.embeddings.shape == (52, DIM)
    assert a.index.n_valid == b.index.n_valid == 52
    assert _fused(h, ["grown t1"], 1) == [[50]]


@pytest.mark.parametrize("method", ["zscore", "rrf"])
def test_save_and_load_both_ways(tmp_path, method):
    jh, th = _hybrids(method, fetch_k=30)
    th.extend(["doc saved t5"]), jh.extend(["doc saved t5"])
    th.save(str(tmp_path / "port"))
    jh.save(str(tmp_path / "jax"))
    t2 = fusion.HybridRetriever.load(
        str(tmp_path / "jax"), [HashingEncoder(dim=DIM), None], device="cpu")
    j2 = jfusion.HybridRetriever.load(
        str(tmp_path / "port"), [JHashingEncoder(dim=DIM), None])
    assert t2.retrievers[1].corpus is t2.retrievers[0].corpus
    assert (t2.method, t2.fetch_k) == (method, 30)
    want = _fused(jh, _queries(), 7)
    assert _fused(t2, _queries(), 7) == want == _fused(j2, _queries(), 7)


def test_unported_placements_raise_naming_slice_6():
    """A hybrid whose dense engine is sharded over 4 CPU positions (once
    refused as unported) fuses the JAX hybrid's ids over a sharded engine,
    with and without an allow mask seen twice (the second time a baked
    sharded view)."""
    from cuvs_rag_tpu.parallel import search as jps
    from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
    from cuvs_rag_tpu_torch.parallel import search as tps
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    jh, th = _hybrids()
    emb = np.asarray(jh.retrievers[0].corpus.embeddings)
    jmesh, tmesh = JMesh(jax.devices()[:4]), DeviceMesh(["cpu"] * 4)
    jr, tr = jh.retrievers[0], th.retrievers[0]
    jr.index = jps.build_sharded("flat", jr.params, emb, jmesh)
    jr.dmesh = jmesh
    tr.index = tps.build_sharded("flat", tr.params, emb, tmesh)
    tr.dmesh = tmesh
    assert _fused(th, _queries(), 5) == _fused(jh, _queries(), 5)
    allow = np.arange(240) % 4 != 1
    for _ in range(2):
        got = _fused(th, _queries(), 5, allow=allow)
        assert got == _fused(jh, _queries(), 5, allow=allow)
        assert all(allow[i] for row in got for i in row)


def test_concurrent_batches_equal_serial():
    """Several threads through one hybrid (its engine pool and view cache
    shared): each gets the serial answer."""
    _, th = _hybrids()
    allow = np.arange(240) % 5 != 0
    want = {(q, m): _fused(th, [q], 5, allow=allow if m else None)
            for q in _queries() for m in (0, 1)}
    bad, errors = [], []

    def run(t):
        try:
            for j in range(30):
                q = _queries()[(t + j) % 6]
                m = j % 2
                if _fused(th, [q], 5, allow=allow if m else None) \
                        != want[(q, m)]:
                    bad.append((q, m))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad, (errors[:2], bad[:2])
