"""The port's sharded and replicated search (parallel/search.py) against its
single-device families and the JAX package's parallel/search.py, on a mesh
of ["cpu"] * S beside the JAX package's first S virtual CPU devices.

Tolerances:
- flat: exact in both packages, so sharded ids equal the single index's and
  the JAX package's, distances rtol 1e-5 / atol 1e-4 (the same fp32
  products summed in another order), ids up to swaps among ties at the
  k-th (utils/compare.compare_topk).
- an index built and saved by the JAX package (io.save_sharded), loaded and
  searched by the port: the same rows and the same lists or graph, so ids
  are identical and distances within 1.5e-5 (unit rows: distances <= 4).
- the port's own sharded IVF builds: recall@10 against the exact oracle
  within 0.02 of the JAX package's sharded build on the same corpus (their
  k-means draws differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.eval import recall as jrecall
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.parallel import search as jps
from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.index import flat as tflat
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.ops import flat_kernels, ivf_kernels
from cuvs_rag_tpu_torch.parallel import search as tps
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils import config as tconfig
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric
from cuvs_rag_tpu_torch.utils.metrics import default_registry
from torch_parity import compare_topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
S = 4


def _mesh(s=S):
    return DeviceMesh(["cpu"] * s)


def _jmesh(s=S):
    return JMesh(jax.devices()[:s])


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(seed, n=2000, d=32, c=16):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    x = cent[rng.integers(0, c, n)] + 0.3 * rng.standard_normal((n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    q = x[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal((16, d))
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _counter(name):
    return default_registry.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("metric", [Metric.SQEUCLIDEAN, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("n", [1000, 1024])
def test_sharded_flat_matches_single_device_and_jax(rng, metric, n):
    d, q, k = 32, 6, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    params = FlatParams(metric=metric, tile_n=64)
    dsh, ish = tps.search_sharded(
        None, tps.build_sharded("flat", params, corpus, _mesh(8)), queries,
        k, _mesh(8))
    d1, i1 = tflat.search(None, tflat.build(params, corpus, device="cpu"),
                          queries, k)
    jd, ji = jps.search_sharded(
        None, jps.build_sharded("flat", jconfig.FlatParams(
            metric=metric, tile_n=64), corpus, JMesh()), queries, k, JMesh())
    sign = -1 if metric == Metric.SQEUCLIDEAN else 1
    compare_topk(sign * dsh, ish, sign * d1, i1, **TOL)
    compare_topk(sign * dsh, ish, sign * np.asarray(jd), np.asarray(ji), **TOL)


def test_sharded_global_ids_are_global(rng):
    """Rows queried by their own vectors in different shards come back with
    their global ids."""
    corpus = rng.standard_normal((800, 16)).astype(np.float32)
    probe_rows = [5, 250, 777]
    six = tps.build_sharded("flat", FlatParams(tile_n=8), corpus, _mesh(8))
    dists, idx = tps.search_sharded(None, six, corpus[probe_rows], 1)
    assert idx[:, 0].tolist() == probe_rows
    np.testing.assert_allclose(dists[:, 0].numpy(), 0.0, atol=1e-3)


def test_sharded_k_exceeds_corpus_and_empty_shards(rng):
    """20 rows over 8 positions of 8 rows: three shards hold rows, five are
    empty (n_valid 0) and answer -1 / inf; the JAX package agrees."""
    corpus = rng.standard_normal((20, 8)).astype(np.float32)
    queries = rng.standard_normal((2, 8)).astype(np.float32)
    six = tps.build_sharded("flat", FlatParams(tile_n=8), corpus, _mesh(8))
    assert [ix.n_valid for ix in six.local] == [8, 8, 4, 0, 0, 0, 0, 0]
    dists, idx = tps.search_sharded(None, six, queries, 30, _mesh(8))
    assert idx.shape == (2, 30)
    assert (np.sort(idx[:, :20].numpy(), axis=1) == np.arange(20)).all()
    assert (idx[:, 20:] == -1).all() and torch.isinf(dists[:, 20:]).all()
    jd, ji = jps.search_sharded(None, jps.build_sharded(
        "flat", jconfig.FlatParams(tile_n=8), corpus, JMesh()), queries, 30,
        JMesh())
    compare_topk(-dists, idx, -np.asarray(jd), np.asarray(ji), **TOL)
    empty = six.local[5]
    d5, i5 = tflat.search(None, empty, queries, 3)
    assert (i5 == -1).all() and torch.isinf(d5).all()


def test_replicated_matches_sharded_and_jax(rng):
    n, d, q, k = 512, 16, 13, 5  # 13 queries over 4 positions
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    params = FlatParams(tile_n=64)
    dsh, ish = tps.search_sharded(
        None, tps.build_sharded("flat", params, corpus, _mesh()), queries, k,
        _mesh())
    rix = tps.build_replicated("flat", params, corpus, _mesh())
    assert len({id(r) for r in rix.replicas}) == 1  # one device, one copy
    drep, irep = tps.search_replicated(None, rix, queries, k, _mesh())
    compare_topk(-drep, irep, -dsh, ish, **TOL)
    jd, ji = jps.search_replicated(None, jps.build_replicated(
        "flat", jconfig.FlatParams(tile_n=64), corpus, _jmesh()), queries, k,
        _jmesh())
    compare_topk(-drep, irep, -np.asarray(jd), np.asarray(ji), **TOL)


def test_sharded_index_layout(rng):
    corpus = rng.standard_normal((64, 8)).astype(np.float32)
    six = tps.build_sharded("flat", FlatParams(tile_n=8), corpus, _mesh(8))
    assert six.family == "flat" and six.total == 64 and six.num_shards == 8
    assert six.offsets.tolist() == list(range(0, 64, 8))
    assert six.dim == 8 and six.metric == Metric.SQEUCLIDEAN
    import weakref

    assert weakref.ref(six.local)() is six.local  # the view cache's key


def test_sharded_int8_families(rng):
    """SQ8 storage through both sharded builds and the fan-out merge."""
    d, q, k = 32, 4, 5
    corpus = rng.standard_normal((2000, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    _, i1 = tps.search_sharded(None, tps.build_sharded(
        "flat", FlatParams(tile_n=8, dtype="int8"), corpus, _mesh(8)),
        queries, k, _mesh(8))
    assert i1.shape == (q, k) and i1.min() >= 0
    sivf = tps.build_sharded("ivf_flat", tconfig.IVFFlatParams(
        n_lists=8, dtype="int8"), corpus, _mesh(8))
    _, i2 = tps.search_sharded(tconfig.IVFFlatSearchParams(n_probes=8),
                               sivf, queries, k, _mesh(8))
    assert i2.shape == (q, k) and i2.min() >= 0
    _, gt = tflat.search(None, tflat.build(FlatParams(), corpus,
                                           device="cpu"), queries, k)
    for ids in (i1, i2):
        agree = np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / k
                         for r in range(q)])
        assert agree >= 0.8, agree


def test_extend_sharded_ids_and_deletions(rng):
    """New rows get ids total..total+B-1, old ids stay, the pre-extend
    delete survives the re-shard."""
    corpus = rng.standard_normal((1000, 32)).astype(np.float32)
    extra = rng.standard_normal((64, 32)).astype(np.float32)
    six = tps.build_sharded("flat", FlatParams(tile_n=8), corpus, _mesh(8))
    six = tps.delete_sharded(six, np.array([5]))
    grown = tps.extend_sharded(six, extra, _mesh(8), FlatParams(tile_n=8))
    assert grown.total == 1064
    q = np.vstack([corpus[123], extra[0], extra[63]])
    _, ids = tps.search_sharded(None, grown, q, 1, _mesh(8))
    assert ids[:, 0].tolist() == [123, 1000, 1063]
    _, i5 = tps.search_sharded(None, grown, corpus[5:6], 1, _mesh(8))
    assert int(i5[0, 0]) != 5


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "cagra"])
def test_extend_sharded_other_families(rng, family):
    corpus = rng.standard_normal((1000, 32)).astype(np.float32)
    extra = rng.standard_normal((40, 32)).astype(np.float32)
    params, sp = {
        "ivf_flat": (tconfig.IVFFlatParams(n_lists=4),
                     tconfig.IVFFlatSearchParams(n_probes=4)),
        "ivf_pq": (tconfig.IVFPQParams(n_lists=4, pq_dim=8),
                   tconfig.IVFPQSearchParams(n_probes=4, refine_ratio=4)),
        "cagra": (tconfig.CagraParams(graph_degree=16,
                                      intermediate_graph_degree=32), None),
    }[family]
    six = tps.build_sharded(family, params, corpus, _mesh())
    six = tps.delete_sharded(six, np.array([9]))
    grown = tps.extend_sharded(six, extra, _mesh(), params)
    assert grown.total == 1040
    _, ids = tps.search_sharded(sp, grown, np.vstack([corpus[7], extra[39]]),
                                1, _mesh())
    assert ids[:, 0].tolist() == [7, 1039]
    _, i9 = tps.search_sharded(sp, grown, corpus[9:10], 3, _mesh())
    assert 9 not in i9[0].tolist()


def test_extend_sharded_validates(rng):
    corpus = rng.standard_normal((256, 16)).astype(np.float32)
    six = tps.build_sharded("flat", FlatParams(tile_n=8), corpus, _mesh())
    with pytest.raises(ValueError, match="new vectors"):
        tps.extend_sharded(six, np.zeros((3, 8)), _mesh(),
                           FlatParams(tile_n=8))


# JAX-built sharded indexes of every family, saved with save_sharded and
# searched by the port: (family, JAX build params, search params pair)
_SAVED = [
    ("flat", jconfig.FlatParams(tile_n=64), (None, None)),
    ("ivf_flat", jconfig.IVFFlatParams(n_lists=6),
     (tconfig.IVFFlatSearchParams(n_probes=3),
      jconfig.IVFFlatSearchParams(n_probes=3))),
    ("ivf_pq", jconfig.IVFPQParams(n_lists=6, pq_dim=8, pq_bits=8),
     (tconfig.IVFPQSearchParams(n_probes=3, refine_ratio=4),
      jconfig.IVFPQSearchParams(n_probes=3, refine_ratio=4))),
    ("ivf_pq", jconfig.IVFPQParams(n_lists=6, pq_dim=8, pq_bits=4),
     (tconfig.IVFPQSearchParams(n_probes=3, refine_ratio=0),
      jconfig.IVFPQSearchParams(n_probes=3, refine_ratio=0))),
    ("cagra", jconfig.CagraParams(graph_degree=16,
                                  intermediate_graph_degree=32),
     (None, None)),
]


@pytest.mark.parametrize("family,jparams,sps", _SAVED,
                         ids=["flat", "ivf_flat", "ivf_pq8", "ivf_pq4",
                              "cagra"])
def test_jax_built_sharded_index_searches_identically(tmp_path, family,
                                                      jparams, sps):
    """A JAX-built sharded index, saved by the JAX package and loaded on a
    mesh of the same size: the port's fan-out search returns the JAX
    package's ids, and its distances within 1.5e-5; deleted rows stay
    deleted; a view and CAGRA's post-filter keep to the mask."""
    x, q = _clustered(3)
    jsix = jps.build_sharded(family, jparams, x, _jmesh())
    jsix = jps.delete_sharded(jsix, np.array([3, 1500]))
    prefix = str(tmp_path / family)
    jio.save_sharded(prefix, jsix)
    six = tio.load_sharded(prefix, _mesh())
    assert six.family == family and six.total == len(x)
    assert six.offsets.tolist() == np.asarray(jsix.offsets).tolist()
    tsp, jsp = sps
    d, i = tps.search_sharded(tsp, six, q, 10, _mesh())
    jd, ji = jps.search_sharded(jsp, jsix, jnp.asarray(q), 10, _jmesh())
    _same(d, i, jd, ji, ties=jparams.__class__.__name__ == "IVFPQParams"
          and jparams.pq_bits == 4 and tsp.refine_ratio == 0)
    assert not np.isin(i.numpy(), [3, 1500]).any()
    allow = np.arange(len(x)) % 3 != 0
    d, i = tps.search_sharded(tsp, six, q, 5, _mesh(), allow=allow)
    jd, ji = jps.search_sharded(jsp, jsix, jnp.asarray(q), 5, _jmesh(),
                                allow=allow)
    _same(d, i, jd, ji, ties=family == "ivf_pq")
    assert allow[i.numpy()[i.numpy() >= 0]].all()


def _same(d, i, jd, ji, ties: bool):
    """Distances within 1.5e-5 slot by slot; ids identical, or, where the
    ADC scores of 4-bit codes tie exactly (16 values a subspace), equal up
    to the order of tied slots and swaps at the k-th."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1.5e-5)
    if ties:
        compare_topk(-d, i, -jd, ji, rtol=0, atol=1.5e-5)
    else:
        np.testing.assert_array_equal(i.numpy(), ji)


def _recall(ids, gt, k=10):
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[r]) & set(gt[r])) / k
                          for r in range(len(gt))]))


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_port_sharded_builds_recall_like_jax(family):
    """The port's own two-phase sharded builds reach the JAX package's
    recall@10 (within 0.02) on the same corpus at a partial probe, with one
    probe window shared by every shard."""
    x, q = _clustered(5, n=4000)
    gt = jrecall.exact_ground_truth(x, q, 10, "sqeuclidean")
    kw = dict(n_lists=8) if family == "ivf_flat" else dict(n_lists=8,
                                                           pq_dim=8)
    tparams = getattr(tconfig, "IVFFlatParams" if family == "ivf_flat"
                      else "IVFPQParams")(**kw)
    jparams = getattr(jconfig, "IVFFlatParams" if family == "ivf_flat"
                      else "IVFPQParams")(**kw)
    sp_name = "IVFFlatSearchParams" if family == "ivf_flat" \
        else "IVFPQSearchParams"
    six = tps.build_sharded(family, tparams, x, _mesh())
    assert len({ix.max_list_size for ix in six.local}) == 1
    assert len({ix.row_ids.shape for ix in six.local}) == 1
    _, i = tps.search_sharded(getattr(tconfig, sp_name)(n_probes=3), six, q,
                              10, _mesh())
    _, ji = jps.search_sharded(
        getattr(jconfig, sp_name)(n_probes=3),
        jps.build_sharded(family, jparams, x, _jmesh()), jnp.asarray(q), 10,
        _jmesh())
    r, jr = _recall(i, gt), _recall(ji, gt)
    assert r >= jr - 0.02, (r, jr)


def test_filtered_views_and_the_cache_hit(rng):
    """allow= searches a cached sharded view: the view equals the JAX
    package's filtered search, a repeated mask hits the cache (the shard
    container takes a weak reference), and the baked view searched
    directly gives the same answer; deletes compose with the view."""
    x = _unit(rng, 1200, 32)
    q = x[:8] + 0.01
    params = FlatParams(tile_n=64)
    six = tps.delete_sharded(tps.build_sharded("flat", params, x, _mesh()),
                             [0, 600])
    jsix = jps.delete_sharded(jps.build_sharded(
        "flat", jconfig.FlatParams(tile_n=64), x, _jmesh()), np.array([0, 600]))
    allow = np.arange(1200) % 2 == 0
    hits0 = _counter("parallel.view_cache_hits")
    d, i = tps.search_sharded(None, six, q, 10, _mesh(), allow=allow)
    assert _counter("parallel.view_cache_hits") == hits0
    d2, i2 = tps.search_sharded(None, six, q, 10, _mesh(), allow=allow.copy())
    assert _counter("parallel.view_cache_hits") == hits0 + 1
    assert torch.equal(i, i2)
    jd, ji = jps.search_sharded(None, jsix, jnp.asarray(q), 10, _jmesh(),
                                allow=allow)
    compare_topk(-d, i, -np.asarray(jd), np.asarray(ji), **TOL)
    assert allow[i.numpy()].all() and not np.isin(i.numpy(), [0, 600]).any()
    view = tps.filtered_view_sharded(six, allow)
    assert torch.equal(tps.search_sharded(None, view, q, 10, _mesh())[1], i)
    with pytest.raises(ValueError, match="bool mask"):
        tps.filtered_view_sharded(six, np.ones(5, bool))
    cix = tps.build_sharded("cagra", tconfig.CagraParams(
        graph_degree=8, intermediate_graph_degree=16), x, _mesh())
    with pytest.raises(ValueError, match="post-filter only"):
        tps.filtered_view_sharded(cix, allow)


def test_batched_search_equals_one_call(rng):
    x = _unit(rng, 900, 16)
    q = _unit(rng, 23, 16)
    six = tps.build_sharded("flat", FlatParams(tile_n=8), x, _mesh())
    allow = np.arange(900) % 5 != 0
    for kw in ({}, {"allow": allow}):
        d, i = tps.search_sharded_batched(None, six, q, 7, _mesh(),
                                          batch_size=5, **kw)
        d1, i1 = tps.search_sharded(None, six, q, 7, _mesh(), **kw)
        assert torch.equal(i, i1) and torch.allclose(d, d1)
    jd, ji = jps.search_sharded_batched(
        None, jps.build_sharded("flat", jconfig.FlatParams(tile_n=8), x,
                                _jmesh()), jnp.asarray(q), 7, _jmesh(),
        batch_size=5)
    d, i = tps.search_sharded_batched(None, six, q, 7, _mesh(), batch_size=5)
    compare_topk(-d, i, -np.asarray(jd), np.asarray(ji), **TOL)


def test_replicated_filters_deletes_and_extends(rng):
    x = _unit(rng, 400, 16)
    q = x[[3, 17, 250]]
    rix = tps.build_replicated("flat", FlatParams(), x, _mesh())
    jrix = jps.build_replicated("flat", jconfig.FlatParams(), x, _jmesh())
    allow = np.arange(400) % 2 == 1
    d, i = tps.search_replicated(None, rix, q, 4, _mesh(), allow=allow)
    jd, ji = jps.search_replicated(None, jrix, jnp.asarray(q), 4, _jmesh(),
                                   allow=allow)
    compare_topk(-d, i, -np.asarray(jd), np.asarray(ji), **TOL)
    rix = tps.delete_replicated(rix, [17])
    rix = tps.extend_replicated(rix, x[:2] + 0.5)
    assert len({id(r) for r in rix.replicas}) == 1
    _, i = tps.search_replicated(None, rix, np.vstack([q, x[:2] + 0.5]), 1,
                                 _mesh())
    assert i[:, 0].tolist() == [3, i[1, 0].item(), 250, 400, 401]
    assert i[1, 0].item() != 17
    cix = tps.build_replicated("cagra", tconfig.CagraParams(
        graph_degree=8, intermediate_graph_degree=16), x, _mesh())
    _, i = tps.search_replicated(None, cix, q, 4, _mesh(), allow=allow)
    assert allow[i.numpy()[i.numpy() >= 0]].all()


def test_cagra_postfilter_keeps_the_first_of_tied_candidates():
    """The merged post-filter selects like `lax.top_k`: among tied scores
    the earlier candidate wins, position by position equal to the JAX
    package's _postfilter_merged."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (6, 40)).astype(np.float32)
    scores[:, 30:] = -np.inf
    idx = np.tile(rng.permutation(200)[:40], (6, 1)).astype(np.int32)
    idx[:, 30:] = -1
    mask = rng.random(200) < 0.6
    ts, ti = tps._postfilter_merged(torch.from_numpy(scores),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(mask), 12)
    js, ji = jps._postfilter_merged(jnp.asarray(scores), jnp.asarray(idx),
                                    jnp.asarray(mask), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("family", ["flat", "ivf_flat"])
def test_large_k_certificates_and_with_a_forced_failure(monkeypatch, family):
    """32 < k: every shard takes its family's certified kernel (its plain
    version on CPU tensors: flat K3, IVF-Flat K5) with no re-run; when one
    shard fails one row's certificate, the whole batch re-runs through the
    plain scan, counted, with the same answer (flat: the single index's)."""
    x, q = _clustered(7, n=1600)
    if family == "flat":
        monkeypatch.setattr(tflat, "_DENSE_THRESHOLD", 0)
        params, sp = FlatParams(tile_n=64), None
        kmod, name = flat_kernels, "flat_topk_large"
    else:
        params = tconfig.IVFFlatParams(n_lists=4)
        sp = tconfig.IVFFlatSearchParams(n_probes=4)
        kmod, name = ivf_kernels, "ivf_scan_large"
    calls = {"n": 0, "fail": False}
    real = getattr(kmod, name)

    def counted(*a, **kw):
        calls["n"] += 1
        s, i, cert = real(*a, **kw)
        if calls["fail"] and calls["n"] == 2:  # the second shard, one row
            cert = cert.clone()
            cert[0] = False
        return s, i, cert

    monkeypatch.setattr(kmod, name, counted)
    six = tps.build_sharded(family, params, x, _mesh())
    reruns = _counter(f"{family}.certificate_reruns")
    want = tps.search_sharded(sp, six, q, 40, _mesh())
    assert calls["n"] == S
    assert _counter(f"{family}.certificate_reruns") == reruns
    calls.update(n=0, fail=True)
    got = tps.search_sharded(sp, six, q, 40, _mesh())
    assert calls["n"] == S
    assert _counter(f"{family}.certificate_reruns") == reruns + 1
    compare_topk(-got[0], got[1], -want[0], want[1], **TOL)
    if family == "flat":
        single = tflat.search(None, tflat.build(params, x, device="cpu"),
                              q, 40)
        compare_topk(-got[0], got[1], -single[0], single[1], **TOL)


def test_ivf_build_local_is_one_shard_of_the_sharded_build(rng):
    """ivf_flat.build_local over one padded block (rows past n_valid dead)
    at the sharded build's window is that build's shard: the same lists,
    window and answers."""
    from cuvs_rag_tpu_torch.index import ivf_flat as tivf

    x = _unit(rng, 1000, 16)
    params = tconfig.IVFFlatParams(n_lists=8)
    one = tps.build_sharded("ivf_flat", params, x, _mesh(1), row_multiple=256)
    block = torch.from_numpy(np.vstack([x, np.zeros((24, 16), np.float32)]))
    ix = tivf.build_local(params, block, 1000, n_lists=8,
                          max_list_size=one.local[0].max_list_size)
    assert ix.max_list_size == one.local[0].max_list_size
    assert torch.equal(ix.row_ids, one.local[0].row_ids)
    sp = tconfig.IVFFlatSearchParams(n_probes=3)
    assert torch.equal(tivf.search(sp, ix, x[:6], 5)[1],
                       tps.search_sharded(sp, one, x[:6], 5)[1])


@pytest.mark.parametrize("algo", ["exact", "ivf"])
def test_a_cagra_shard_is_the_cagra_index_of_its_rows(algo):
    """Each shard of a sharded CAGRA build (its IVF bootstrap from the
    two-phase sharded IVF build) equals cagra.build over that shard's rows:
    the same graph, rows and entry map."""
    from cuvs_rag_tpu_torch.index import cagra as tcagra

    x, _ = _clustered(9, n=2400, d=16)
    params = tconfig.CagraParams(graph_degree=8, intermediate_graph_degree=16,
                                 build_algo=algo)
    six = tps.build_sharded("cagra", params, x, _mesh())
    for ix, off in zip(six.local, six.offsets):
        one = tcagra.build(params, x[off:off + ix.n_valid], device="cpu")
        for name in ("graph", "vectors", "entry_rows", "entry_centroids"):
            assert torch.equal(getattr(ix, name), getattr(one, name)), name
