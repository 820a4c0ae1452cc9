"""The port's CAGRA index (index/cagra.py), its post-filter, io and
Retriever(family="cagra") against the JAX package's, on the same seeded
numpy corpora.

Indexes cross between the packages through their npz files, so both sides
search the same rows and graph. Tolerances:
- search: distances rtol 1e-5 / atol 1e-4 (both score exact products of the
  same fp32 / bf16 values summed in fp32 in another order, and a distance
  is ||q||² minus a score: the terms reach ~1e2 here, a few fp32 ulps of
  them stay under 1e-4), ids equal up to swaps among distances tied with the
  k-th.
- the tie-order case (many tombstoned rows, -inf beam slots): ids equal
  exactly, position by position.
- delete, the pre-format-3 migration: equal, bit for bit. Incremental
  extend: graph and stored values equal (the extend's beam ids are equal on
  these inputs), the new rows' sqnorms and [hi, lo] sums within rtol 1e-6
  (sums of the same squares in another order).
- builds (the port's own, and extend's rebuild): recall@10 against the exact
  oracle within 0.02 of the JAX build's on the same corpus (the IVF
  bootstrap's RNG and the graph's ranking differ, see ops/graph.py).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.eval import recall as jrecall
from cuvs_rag_tpu.index import cagra as jcagra
from cuvs_rag_tpu.index import filters as jfilters
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.models.encoder import HashingEncoder as JHashingEncoder
from cuvs_rag_tpu.rag.corpus import Corpus as JCorpus
from cuvs_rag_tpu.rag.pipeline import Retriever as JRetriever
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.index import cagra as tcagra
from cuvs_rag_tpu_torch.index import filters as tfilters
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
from cuvs_rag_tpu_torch.rag.corpus import Corpus
from cuvs_rag_tpu_torch.rag.pipeline import Retriever
from cuvs_rag_tpu_torch.utils import config as tconfig
from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams
from torch_parity import compare_topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM = 3000, 32
# (storage dtype, metric, build_algo) of the JAX-built indexes
CASES = [("float32", "sqeuclidean", "exact"), ("bfloat16", "sqeuclidean", "exact"),
         ("float32", "inner_product", "exact"), ("float32", "cosine", "exact"),
         ("float32", "sqeuclidean", "ivf"), ("bfloat16", "sqeuclidean", "ivf")]
SEARCH = [CagraSearchParams(),
          CagraSearchParams(itopk_size=32, max_iterations=12,
                            num_entry_points=16, search_width=4)]


def _params(dtype="float32", metric="sqeuclidean", algo="exact", mod=None):
    return (mod or jconfig).CagraParams(
        intermediate_graph_degree=32, graph_degree=16, metric=metric,
        dtype=dtype, build_algo=algo, build_nlists=6, build_nprobes=3)


def _j_search(sp):
    return jconfig.CagraSearchParams(**vars(sp))


def _corpus(seed=11, n=N):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((20, DIM)).astype(np.float32) * 1.5
    x = cent[rng.integers(0, 20, n)] + 0.5 * rng.standard_normal((n, DIM))
    q = cent[rng.integers(0, 20, 16)] + 0.5 * rng.standard_normal((16, DIM))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _corpus()


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """npz files of JAX-built CAGRA indexes, one per CASES entry."""
    x, _ = data
    out = {}
    for dtype, metric, algo in CASES:
        ix = jcagra.build(_params(dtype, metric, algo), jnp.asarray(x))
        path = str(tmp_path_factory.mktemp("jcagra") / f"{dtype}_{metric}_{algo}.npz")
        jio.save_index(path, ix)
        out[dtype, metric, algo] = path
    return out


def _signed(d, metric):
    """Distances -> larger-better scores (compare_topk's convention)."""
    d = np.asarray(d if not isinstance(d, torch.Tensor) else d.numpy())
    return -d if metric == "sqeuclidean" else d


def _same(tix, jix, q, k, sp, metric):
    d, i = tcagra.search(sp, tix, torch.from_numpy(q), k)
    rd, ri = jcagra.search(_j_search(sp), jix, jnp.asarray(q), k)
    assert d.shape == i.shape == (q.shape[0], k) and i.dtype == torch.int32
    compare_topk(_signed(d, metric), i, _signed(rd, metric), np.asarray(ri),
                 **TOL)
    return i.numpy()


@pytest.mark.parametrize("sp", SEARCH, ids=["default", "narrow"])
@pytest.mark.parametrize("dtype,metric,algo", CASES)
def test_search_matches_jax(data, jax_files, dtype, metric, algo, sp):
    """A JAX-built index loaded through npz searches the same in the port:
    default params (itopk 64, width 16, 128 entries: medoids then evenly
    spaced rows on the ivf builds) and a narrow beam."""
    _, q = data
    path = jax_files[dtype, metric, algo]
    jix, tix = jio.load_index(path), tio.load_index(path, device="cpu")
    assert tix.has_entry_map == (algo == "ivf") and tix.n_valid == N
    ids = _same(tix, jix, q, 10, sp, metric)
    for row in ids:  # no id twice in a row
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neg_inf_tie_order_matches_jax(data, tmp_path, dtype):
    """A corpus of 2,999 rows (5 pad rows) with two thirds of them deleted:
    the beam starts from 4 entries (60 of its 64 slots -inf with id -1),
    deleted and pad rows tie at a finite ~-2e30 by the hundred, and masked
    duplicates tie at -inf. The JAX search takes ties lowest position first;
    the port must return the same ids in the same slots, -1s included."""
    x, q = data
    jix = jcagra.build(_params(dtype), jnp.asarray(x[:2999]))
    jix = jcagra.delete(jix, np.nonzero(np.arange(2999) % 3 != 0)[0])
    path = str(tmp_path / "del.npz")
    jio.save_index(path, jix)
    tix = tio.load_index(path, device="cpu")
    assert tix.size == 3000
    empty = []
    for sp in (CagraSearchParams(itopk_size=64, num_entry_points=4,
                                 search_width=2, max_iterations=3),
               CagraSearchParams(itopk_size=64, num_entry_points=8,
                                 search_width=16)):
        d, i = tcagra.search(sp, tix, torch.from_numpy(q), 64)
        rd, ri = jcagra.search(_j_search(sp), jix, jnp.asarray(q), 64)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        fin = np.isfinite(np.asarray(rd))
        np.testing.assert_array_equal(np.isfinite(d.numpy()), fin)
        np.testing.assert_allclose(d.numpy()[fin], np.asarray(rd)[fin], **TOL)
        assert not (i.numpy()[i.numpy() >= 0] % 3).any()
        empty.append(int((i.numpy() == -1).sum()))
    assert empty[0] > 0  # the narrow beam saw fewer than k live rows


def test_masked_news_never_displace_beam_slots(tmp_path):
    """The tie the JAX search relies on, built by hand: entries are rows 0
    (live) and 15 (deleted), so the first iteration expands 0 and, for want
    of a second live candidate, the tombstoned 15, whose neighbours 3 and 4
    are masked to -inf with their real ids. Taking -inf ties lowest position
    first keeps the beam's own empty slots and leaves 3 out; row 1's
    expansion then admits 3, the nearest row, with its real score. A
    selection that let the masked copy of 3 into the beam would mark the
    real one "in beam" and lose it for good."""
    x = np.zeros((16, 2), np.float32)
    x[:7, 0] = [2.0, 1.0, 1.5, 0.1, 3.0, 2.5, 2.7]
    x[7:, 0] = 5.0 + np.arange(9)
    graph = np.arange(16, dtype=np.int32)[:, None].repeat(2, 1)
    graph[0], graph[15], graph[1], graph[2] = [1, 2], [3, 4], [3, 5], [5, 6]
    v = jnp.asarray(x)
    from cuvs_rag_tpu.ops import distance as jdist
    from cuvs_rag_tpu.ops import graph as jgraph

    jix = jcagra.CagraIndex(
        vectors=jgraph.augment_rows(v, jdist.sqnorms(v), jnp.int32(16),
                                    "sqeuclidean"),
        sqnorms=jdist.sqnorms(v), graph=jnp.asarray(graph),
        entry_centroids=jnp.zeros((0, 2), jnp.float32),
        entry_rows=jnp.zeros((0,), jnp.int32), n_valid=jnp.int32(16),
        metric="sqeuclidean", data_dim=2)
    jix = jcagra.delete(jix, np.arange(7, 16))
    path = str(tmp_path / "hand.npz")
    jio.save_index(path, jix)
    tix = tio.load_index(path, device="cpu")
    sp = CagraSearchParams(itopk_size=8, num_entry_points=2, search_width=2,
                           max_iterations=3)
    q = np.zeros((1, 2), np.float32)
    _, i = tcagra.search(sp, tix, torch.from_numpy(q), 8)
    _, ri = jcagra.search(_j_search(sp), jix, jnp.asarray(q), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i.numpy()[0, 0] == 3


def test_delete_equal(jax_files):
    """Tombstones in the sqnorm slot and the augmented [hi, lo] columns,
    bit for bit; unknown and repeated ids ignored; deleted ids reported
    alike by both packages' io.deleted_row_ids."""
    for key in (CASES[1], CASES[3]):
        path = jax_files[key]
        gone = np.array([5, 17, 17, 2999, -1, N + 3, 400])
        jix = jcagra.delete(jio.load_index(path), gone)
        tix = tcagra.delete(tio.load_index(path, device="cpu"), gone)
        for field in ("vectors", "sqnorms", "graph"):
            a = getattr(tix, field)
            np.testing.assert_array_equal(
                a.float().numpy() if a.is_floating_point() else a.numpy(),
                np.asarray(getattr(jix, field)).astype(
                    np.float32 if a.is_floating_point() else np.int32))
        np.testing.assert_array_equal(tio.deleted_row_ids(tix),
                                      jio.deleted_row_ids(jix))
        assert tio.deleted_row_ids(tix).tolist() == [5, 17, 400, 2999]


@pytest.mark.parametrize("key", [CASES[0], CASES[1], CASES[3], CASES[4]])
def test_extend_incremental_equal(data, jax_files, key):
    """40 new rows (under the 25% rebuild fraction), ten sources four times
    over, so new rows collide on their neighbours' reverse slots: the last
    writer wins as in the JAX package's CPU scatter. Graph and n_valid
    equal, rows and sqnorms equal up to the new rows' fp32 sums, and the
    extended index searches the same."""
    x, _ = data
    rng = np.random.default_rng(12)
    new = (np.repeat(x[rng.integers(0, N, 10)], 4, axis=0)
           + 0.01 * rng.standard_normal((40, DIM))).astype(np.float32)
    path = jax_files[key]
    jix = jcagra.extend(jcagra.delete(jio.load_index(path), [7]),
                        jnp.asarray(new))
    tix = tcagra.extend(tcagra.delete(tio.load_index(path, device="cpu"), [7]),
                        torch.from_numpy(new))
    assert tix.n_valid == int(jix.n_valid) == N + 40
    np.testing.assert_array_equal(tix.graph.numpy(), np.asarray(jix.graph))
    tv = tix.vectors.float().numpy()
    jv = np.asarray(jix.vectors).astype(np.float32)
    np.testing.assert_array_equal(tv[:N], jv[:N])
    # the new rows: sqnorms (and cosine's normalization) are sums of the same
    # squares in another order, so values agree to fp32 rounding and the
    # [hi, lo] sums to lo's own bf16 rounding (2^-17 of the sqnorm)
    np.testing.assert_allclose(tv[N:, :DIM], jv[N:, :DIM], rtol=1e-6)
    np.testing.assert_allclose(tix.sqnorms.numpy(), np.asarray(jix.sqnorms),
                               rtol=1e-6)
    np.testing.assert_allclose(tv[:, DIM] + tv[:, DIM + 1],
                               jv[:, DIM] + jv[:, DIM + 1], rtol=1e-5)
    assert not tv[:, DIM + 2:].any()
    # the copies of a source share their neighbours, so only the last
    # writer of each slot is linked: the same rows are found as in JAX
    _same(tix, jix, new, 5, SEARCH[0], key[1])
    assert tio.deleted_row_ids(tix).tolist() == [7]


def _recall(ids, x, q, k=10, metric="sqeuclidean"):
    gt = jrecall.exact_ground_truth(x, q, k, metric)
    return jrecall.recall_at_k(np.asarray(ids), gt, k)


def test_extend_rebuild_recall_held(data, jax_files):
    """1,000 new rows (past the 25% fraction) rebuild the graph: recall@10
    within 0.02 of the JAX rebuild's, the tombstones carried over."""
    x, q = data
    extra, _ = _corpus(seed=13, n=1000)
    full = np.concatenate([x, extra])
    path = jax_files[CASES[0]]
    jix = jcagra.extend(jcagra.delete(jio.load_index(path), [3]),
                        jnp.asarray(extra))
    tix = tcagra.extend(tcagra.delete(tio.load_index(path, device="cpu"), [3]),
                        torch.from_numpy(extra))
    assert tix.n_valid == N + 1000 and tix.graph_degree == 16
    assert tio.deleted_row_ids(tix).tolist() == [3]
    qq = np.concatenate([q, extra[:16] + 0.05])
    _, ti = tcagra.search(None, tix, torch.from_numpy(qq), 10)
    _, ji = jcagra.search(None, jix, jnp.asarray(qq), 10)
    full_live = full.copy()
    full_live[3] = 1e6  # the deleted row is nobody's neighbour
    rt, rj = _recall(ti.numpy(), full_live, qq), _recall(ji, full_live, qq)
    assert rt >= rj - 0.02 and rt >= 0.9, (rt, rj)


@pytest.mark.parametrize("dtype,metric,algo", [
    ("float32", "sqeuclidean", "exact"), ("bfloat16", "sqeuclidean", "exact"),
    ("float32", "cosine", "exact"), ("float32", "sqeuclidean", "ivf"),
    ("bfloat16", "sqeuclidean", "ivf")])
def test_own_build_recall_close_to_jax(data, dtype, metric, algo):
    """The port's own build: recall@10 (default search params, 64 queries)
    within 0.02 of the JAX build's on the same corpus; the graph has no self
    loop on a real row and no id past the corpus."""
    x, _ = data
    rng = np.random.default_rng(14)
    q = (x[rng.integers(0, N, 64)]
         + 0.3 * rng.standard_normal((64, DIM))).astype(np.float32)
    tix = tcagra.build(_params(dtype, metric, algo, tconfig), x, device="cpu")
    jix = jcagra.build(_params(dtype, metric, algo), jnp.asarray(x))
    g = tix.graph.numpy()
    assert g.shape == (N, 16) and g.min() >= 0 and g.max() < N
    assert not (g == np.arange(N)[:, None]).any()
    assert tix.has_entry_map == (algo == "ivf")
    _, ti = tcagra.search(None, tix, torch.from_numpy(q), 10)
    _, ji = jcagra.search(None, jix, jnp.asarray(q), 10)
    rt, rj = _recall(ti.numpy(), x, q, metric=metric), \
        _recall(ji, x, q, metric=metric)
    assert rt >= rj - 0.02 and rt >= 0.9, (rt, rj)


@pytest.mark.parametrize("key", [CASES[0], CASES[1], CASES[4]])
def test_postfilter_matches_jax(data, jax_files, key):
    """filters.search on a CagraIndex: the beam's over-fetched top-40 masked
    to the allow list, equal to the JAX package's and ⊆ allow; a selective
    filter leaves -1 slots in the same places; k past itopk_size raises."""
    _, q = data
    jix = jio.load_index(jax_files[key])
    tix = tio.load_index(jax_files[key], device="cpu")
    metric = key[1]
    for allow in (np.arange(N) % 3 != 0,
                  tfilters.allow_from_ids(N, [4, 900, 1500, 2500])):
        d, i = tfilters.search(None, tix, torch.from_numpy(q), 10, allow)
        rd, ri = jfilters.search(None, jix, jnp.asarray(q), 10, allow)
        compare_topk(_signed(d, metric), i, _signed(rd, metric),
                     np.asarray(ri), **TOL)
        ids = i.numpy()
        assert allow[ids[ids >= 0]].all()
    assert (ids == -1).any()
    with pytest.raises(ValueError, match="itopk_size"):
        tfilters.search(CagraSearchParams(itopk_size=32), tix,
                        torch.from_numpy(q), 40, allow)
    with pytest.raises(TypeError, match="post-filter"):
        tfilters.filtered_view(tix, allow)


@pytest.mark.parametrize("graph_degree,forward_edges", [
    (64, 0), (64, 48), (64, 64), (64, 1), (16, 12), (32, 31)])
def test_forward_split_equal(graph_degree, forward_edges):
    """The forward / reverse split against the realized degree, equal to the
    JAX package's for every degree a small corpus or shard can realize."""
    for final_deg in range(1, graph_degree + 1):
        kw = dict(graph_degree=graph_degree, forward_edges=forward_edges,
                  intermediate_graph_degree=2 * graph_degree)
        assert tcagra._forward_split(CagraParams(**kw), final_deg) \
            == jcagra._forward_split(jconfig.CagraParams(**kw), final_deg)


def test_io_torch_to_jax(data, tmp_path):
    """A port-built index (ivf, bf16, with a deletion) saved by the port
    loads in the JAX package and searches the same."""
    x, q = data
    tix = tcagra.delete(tcagra.build(_params("bfloat16", algo="ivf",
                                             mod=tconfig), x, device="cpu"),
                        [11, 12])
    path = str(tmp_path / "t.npz")
    tio.save_index(path, tix)
    jix = jio.load_index(path)
    assert jix.data_dim == DIM and int(jix.n_valid) == N
    for sp in SEARCH:
        ids = _same(tix, jix, q, 10, sp, "sqeuclidean")
        assert not np.isin(ids, [11, 12]).any()
    back = tio.load_index(path, device="cpu")
    for f in ("vectors", "graph", "entry_rows", "entry_centroids", "sqnorms"):
        assert torch.equal(getattr(back, f), getattr(tix, f))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_pre_format3_file_migrates(data, jax_files, tmp_path, metric):
    """A hand-made pre-format-3 file (raw (Np, D) rows, no data_dim, no
    entry map, tombstoned sqnorm slots) migrates to the same augmented rows
    in both packages and searches the same: deleted rows stay deleted in
    every metric."""
    _, q = data
    key = ("float32", metric, "exact")
    jix = jcagra.delete(jio.load_index(jax_files[key]), [0, 9, 33])
    raw = np.asarray(jix.vectors)[:, :DIM]
    meta = {"__class__": "CagraIndex", "static": {"metric": metric},
            "bf16": [], "format": 2}
    path = str(tmp_path / "v2.npz")
    np.savez(path, vectors=raw, sqnorms=np.asarray(jix.sqnorms),
             graph=np.asarray(jix.graph), n_valid=np.asarray(N, np.int32),
             __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    jmig, tmig = jio.load_index(path), tio.load_index(path, device="cpu")
    assert tmig.data_dim == DIM and not tmig.has_entry_map
    np.testing.assert_array_equal(tmig.vectors.numpy(), np.asarray(jmig.vectors))
    ids = _same(tmig, jmig, q, 10, SEARCH[0], metric)
    assert not np.isin(ids, [0, 9, 33]).any()


def test_retriever_cagra_matches_jax(tmp_path):
    """Retriever(family="cagra", device="cpu") against the JAX package's on
    the same passages and hashing encoder: retrieve, allow=, delete, extend,
    save and load (also a directory the JAX package saved)."""
    rng = np.random.default_rng(15)
    words = [f"w{i}" for i in range(300)]
    passages = [f"doc {i} " + " ".join(rng.choice(words, 12))
                for i in range(600)]
    queries = passages[:5] + ["w1 w2 w3 w4", "nothing like it"]
    params = dict(intermediate_graph_degree=32, graph_degree=16)
    tr = Retriever.build(Corpus(passages=list(passages)), HashingEncoder(64),
                         family="cagra", params=CagraParams(**params),
                         device="cpu")
    jr = JRetriever.build(JCorpus(passages=list(passages)),
                          JHashingEncoder(64), family="cagra",
                          params=jconfig.CagraParams(**params))

    def same(k=5, allow=None):
        d, i = tr.retrieve_ids(queries, k, allow=allow)
        rd, ri = jr.retrieve_ids(queries, k, allow=allow)
        compare_topk(-d, i, -np.asarray(rd), np.asarray(ri), rtol=1e-4,
                     atol=1e-4)
        return i

    assert same()[:5, 0].tolist() == list(range(5))
    allow = np.arange(600) % 2 == 1
    ids = same(8, allow)
    assert allow[ids[ids >= 0]].all()
    assert tr.retrieve(passages[3], 4, allow=allow).passages[0].index == 3
    tr.delete([2])
    jr.delete([2])
    assert 2 not in same()
    new = tr.extend(["an extended passage about w7 w8 w9"])
    jr.extend(["an extended passage about w7 w8 w9"])
    assert tr.retrieve("an extended passage about w7 w8 w9", 3) \
        .passages[0].index == new[0] == 600
    want = same()
    tr.save(str(tmp_path / "t"))
    jr.save(str(tmp_path / "j"))
    for d in ("t", "j"):
        back = Retriever.load(str(tmp_path / d), HashingEncoder(64),
                              device="cpu")
        assert back.family == "cagra" and back.index.n_valid == 601
        np.testing.assert_array_equal(back.retrieve_ids(queries, 5)[1], want)
