"""eval/tune.py of the port: the JAX package's tests/test_tune.py (12
tests) against the port, and the port against the JAX package: the
ladder's walk, the recall at every point of each family's ladder on the
same JAX-built index (loaded through the npz format), and the build
candidates for a budget. Latency decides only between points that both
meet the target, so the recall curve is held, not the choice."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.eval import tune as jtune
from cuvs_rag_tpu.index import cagra as jcagra
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.index import ivf_pq as jpq
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu.utils import memory as jmem
from cuvs_rag_tpu_torch.eval import recall as recall_lib
from cuvs_rag_tpu_torch.eval import tune as ttune
from cuvs_rag_tpu_torch.eval.sweeps import SweepPoint
from cuvs_rag_tpu_torch.eval.tune import (
    candidate_ladder, route_large_k, tune, tune_build)
from cuvs_rag_tpu_torch.index import cagra, flat, io, ivf_flat, ivf_pq
from cuvs_rag_tpu_torch.utils.config import (
    CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
    IVFFlatSearchParams, IVFPQParams, IVFPQSearchParams)
from cuvs_rag_tpu_torch.utils.memory import DeviceBudget

torch.set_num_threads(1)

N, D, K = 2000, 64, 10


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, D)).astype(np.float32)
    labels = rng.integers(0, 16, N)
    corpus = (centers[labels] + 0.3 * rng.standard_normal((N, D))).astype(
        np.float32)
    qlab = rng.integers(0, 16, 20)
    queries = (centers[qlab] + 0.3 * rng.standard_normal((20, D))).astype(
        np.float32)
    gt = recall_lib.exact_ground_truth(corpus, queries, K, "sqeuclidean",
                                       device="cpu")
    return corpus, queries, gt


def _recall(mod, sp, ix, queries, gt):
    _, i = mod.search(sp, ix, queries, K)
    return recall_lib.recall_at_k(np.asarray(i), gt, K)


# --- the JAX package's tests, on the port ---------------------------------


def test_tune_ivf_flat_minimal_nprobe(clustered):
    corpus, queries, gt = clustered
    ix = ivf_flat.build(IVFFlatParams(n_lists=16), corpus, device="cpu")
    res = tune("ivf_flat", ix, queries, k=K, target_recall=0.95,
               ground_truth=gt, iters=1)
    assert res.met and res.point.recall >= 0.95
    np_best = res.search_params.n_probes
    if np_best > 1:  # one probe fewer must miss the target
        assert _recall(ivf_flat, IVFFlatSearchParams(n_probes=np_best - 1),
                       ix, queries, gt) < 0.95


def test_tune_ivf_flat_unreachable_target(clustered):
    corpus, queries, gt = clustered
    ix = ivf_flat.build(IVFFlatParams(n_lists=16, dtype="int8"), corpus,
                        device="cpu")
    res = tune("ivf_flat", ix, queries, k=K, target_recall=1.01,
               ground_truth=gt, iters=1)
    assert not res.met and res.search_params is None
    assert len(res.curve) > 0
    assert "NOT met" in repr(res)


def test_tune_flat(clustered):
    corpus, queries, gt = clustered
    ix = flat.build(FlatParams(), corpus, device="cpu")
    res = tune("flat", ix, queries, k=K, target_recall=0.9,
               ground_truth=gt, iters=1)
    assert res.met and res.point.recall >= 0.9
    # the sketch (approx=True) is measured first, the exact scan only when
    # it misses
    assert res.curve[0].param.approx is True
    exact = tune("flat", ix, queries, k=K, target_recall=1.0,
                 ground_truth=gt, iters=1)
    assert exact.met and exact.point.recall == 1.0
    # the exact scan is measured only where the sketch missed
    assert len(exact.curve) == (1 if exact.curve[0].recall >= 1.0 else 2)


def test_tune_ivf_pq_refine_walk(clustered):
    corpus, queries, gt = clustered
    ix = ivf_pq.build(
        IVFPQParams(n_lists=8, pq_dim=16, pq_bits=4, store_raw=True), corpus,
        device="cpu")
    res = tune("ivf_pq", ix, queries, k=K, target_recall=0.9,
               ground_truth=gt, iters=1)
    assert res.met
    assert _recall(ivf_pq, res.search_params, ix, queries, gt) >= 0.9


def test_tune_cagra(clustered):
    corpus, queries, gt = clustered
    ix = cagra.build(CagraParams(graph_degree=16, build_algo="exact"), corpus,
                     device="cpu")
    res = tune("cagra", ix, queries, k=K, target_recall=0.85,
               ground_truth=gt, iters=1)
    assert res.met
    assert _recall(cagra, res.search_params, ix, queries, gt) >= 0.85


def test_tune_computes_gt_from_corpus(clustered):
    corpus, queries, _ = clustered
    ix = ivf_flat.build(IVFFlatParams(n_lists=16), corpus, device="cpu")
    res = tune("ivf_flat", ix, queries, k=K, target_recall=0.9,
               corpus=corpus, iters=1)
    assert res.met
    with pytest.raises(ValueError, match="ground_truth or corpus"):
        tune("ivf_flat", ix, queries, k=K)


def test_candidate_ladder_budget_filter_and_order():
    cands = candidate_ladder(768, 10_000_000, 8 << 30, working_factor=1.0)
    labels = [c.label() for c in cands]
    assert any("codes-only" in lab for lab in labels)
    assert all("ivf_flat[bfloat16]" != lab for lab in labels)
    assert "ivf_flat[int8]" in labels
    assert [c.est_bytes for c in cands] == sorted(c.est_bytes for c in cands)


def test_candidate_ladder_tiny_budget_pq_only():
    cands = candidate_ladder(768, 30_000_000, 6 << 30, working_factor=1.0)
    assert cands, "codes-only PQ must fit 30M in 6 GB"
    assert all(c.family == "ivf_pq" and not c.params.store_raw for c in cands)


def test_tune_build_picks_in_budget_winner(clustered):
    corpus, queries, gt = clustered
    res = tune_build(
        corpus, queries, n_total=1_000_000, k=K, target_recall=0.85,
        budget=DeviceBudget(limit_bytes=(1 << 30) + (2 << 30)),
        families=["ivf_flat", "ivf_pq"], ground_truth=gt, iters=1,
        device="cpu",
    )
    assert res.met
    assert res.candidate.est_bytes <= res.budget_bytes
    assert res.point.recall >= 0.85
    passing = [t for t in res.trials if t["tune"].met]
    fastest = min(p["tune"].point.latency_ms_per_query for p in passing)
    assert res.point.latency_ms_per_query == fastest


def test_tune_build_unreachable_target(clustered):
    corpus, queries, gt = clustered
    res = tune_build(
        corpus, queries, n_total=1_000_000, k=K, target_recall=1.01,
        budget=DeviceBudget(limit_bytes=64 << 30),
        families=["ivf_flat"], ground_truth=gt, iters=1, device="cpu",
    )
    assert not res.met
    assert res.candidate is None and res.search_params is None
    assert len(res.trials) >= 1


def test_candidate_ladder_flat_and_unknown_families():
    cands = candidate_ladder(64, 100_000, 10**12, families=["flat"])
    assert cands and all(c.family == "flat" for c in cands)
    assert any("flat[" in c.label() for c in cands)
    with pytest.raises(ValueError, match="unknown families"):
        candidate_ladder(64, 1000, 10**9, families=["hnsw"])


def test_route_large_k_contract(clustered):
    """The winner meets the recall target — through tuned approximate
    params when they are cheaper, else the exact path at recall 1.0 — and
    the measurements back the choice."""
    corpus, queries, _ = clustered
    fx = flat.build(FlatParams(), corpus, device="cpu")
    ivf = ivf_flat.build(IVFFlatParams(n_lists=16), corpus, device="cpu")
    k_large = 50
    res = route_large_k("ivf_flat", ivf, fx, queries, k_large,
                        target_recall=0.95, iters=1)
    assert res.route in ("approx", "exact")
    assert res.exact_point.recall == 1.0
    assert res.point.recall >= 0.95
    assert res.curve, "the approximate family was tuned"
    if res.route == "approx":
        assert res.search_params is not None
        assert (res.point.latency_ms_per_query
                < res.exact_point.latency_ms_per_query)
        _, ids = ivf_flat.search(res.search_params, ivf, queries, k_large)
        _, gtl = flat.search(None, fx, queries, k_large)
        hit = recall_lib.recall_at_k(ids.numpy(), gtl.numpy(), k_large)
        assert hit >= 0.9
    else:
        assert res.search_params is None
        assert res.point.latency_ms_per_query == \
            res.exact_point.latency_ms_per_query


# --- the port against the JAX package --------------------------------------


@pytest.mark.parametrize("curve", [
    lambda p: min(1.0, 0.1 * p),                 # reaches 0.95 at 10
    lambda p: 0.5,                               # plateau
    lambda p: 0.002 * p,                         # low recall, linear
    lambda p: 1.0,                               # hit at the first rung
    lambda p: 0.96 if p >= 37 else 0.9,          # a step between rungs
    lambda p: 0.9 + 0.0001 * p,                  # saturating, under target
])
@pytest.mark.parametrize("plateau_after", [0, 2])
def test_ladder_then_bisect_visits_the_jax_packages_points(curve,
                                                           plateau_after):
    """On a scripted measurement both packages visit the same knob values
    in the same order and return the same point."""
    def walk(mod):
        seen = []

        def meas(p):
            seen.append(p)
            return SweepPoint(param=p, recall=curve(p),
                              latency_ms_per_query=float(p), qps=1.0 / p)

        best = mod._ladder_then_bisect(meas, lambda p: p, hi=64,
                                       target=0.95,
                                       plateau_after=plateau_after)
        return seen, None if best is None else best.param

    assert walk(ttune) == walk(jtune)


@pytest.fixture(scope="module")
def jax_indexes(clustered, tmp_path_factory):
    """IVF-Flat, IVF-PQ and CAGRA built by the JAX package, with their
    loads in the port (npz format 3)."""
    corpus, _, _ = clustered
    tmp = tmp_path_factory.mktemp("tune_ix")
    cj = jnp.asarray(corpus)
    built = {
        "ivf_flat": jivf.build(jconfig.IVFFlatParams(n_lists=16), cj),
        "ivf_pq": jpq.build(jconfig.IVFPQParams(n_lists=8, pq_dim=16,
                                                pq_bits=4, store_raw=True),
                            cj),
        "cagra": jcagra.build(jconfig.CagraParams(graph_degree=16,
                                                  build_algo="exact"), cj),
    }
    out = {}
    for fam, jix in built.items():
        path = str(tmp / f"{fam}.npz")
        jio.save_index(path, jix)
        out[fam] = (jix, io.load_index(path, device="cpu"))
    return out


def _ladder_points(family):
    """(JAX params, port params) over the rungs of the tuner's ladders."""
    if family == "ivf_flat":
        return [(jconfig.IVFFlatSearchParams(n_probes=p),
                 IVFFlatSearchParams(n_probes=p))
                for p in (1, 2, 3, 4, 6, 8, 12, 16)]
    if family == "ivf_pq":
        return [(jconfig.IVFPQSearchParams(n_probes=p, refine_ratio=r),
                 IVFPQSearchParams(n_probes=p, refine_ratio=r))
                for r in (16, 64, 2) for p in (1, 4, 8)]
    return [(jconfig.CagraSearchParams(itopk_size=i, max_iterations=m),
             CagraSearchParams(itopk_size=i, max_iterations=m))
            for i in (32, 64, 128) for m in (0, 6, 4)]


def _pool_ties(tix, sp, queries, rows):
    """Whether IVF-PQ's ADC pool (min(k * refine_ratio, k + 1024) best
    ADC scores) ends inside a tie for each of `rows`: a row outside the
    pool may then score equal to one inside it, and which one a package
    keeps is tie order."""
    pool = min(K * sp.refine_ratio, K + 1024)
    s, _ = ivf_pq.search(IVFPQSearchParams(n_probes=sp.n_probes,
                                           refine_ratio=0),
                         tix, torch.from_numpy(queries[rows]), pool + 1)
    return (s[:, pool - 1] == s[:, pool]).tolist()


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "cagra"])
def test_ladder_recall_equals_the_jax_package(clustered, jax_indexes, family):
    """Every rung of the family's ladders returns the JAX package's ids
    (as sets, so recall is equal) on the same index and queries; for
    IVF-PQ a query may differ only where its ADC pool ends in a tie."""
    _, queries, gt = clustered
    jix, tix = jax_indexes[family]
    jmod = {"ivf_flat": jivf, "ivf_pq": jpq, "cagra": jcagra}[family]
    tmod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "cagra": cagra}[family]
    for jsp, tsp in _ladder_points(family):
        _, ti = tmod.search(tsp, tix, torch.from_numpy(queries), K)
        _, ji = jmod.search(jsp, jix, jnp.asarray(queries), K)
        ti, ji = ti.numpy(), np.asarray(ji)
        differ = [q for q in range(len(queries))
                  if set(ti[q]) != set(ji[q])]
        if family == "ivf_pq" and differ:
            assert all(_pool_ties(tix, tsp, queries, differ)), (tsp, differ)
            same = [q for q in range(len(queries)) if q not in differ]
            ti, ji, g = ti[same], ji[same], gt[same]
        else:
            assert not differ, (tsp, differ)
            g = gt
        assert recall_lib.recall_at_k(ti, g, K) == \
            recall_lib.recall_at_k(ji, g, K)


@pytest.mark.parametrize("family", ["ivf_flat", "cagra"])
def test_tune_meets_the_target_where_the_jax_package_does(clustered,
                                                          jax_indexes,
                                                          family):
    """tune() on the same index reaches the target in both packages, and
    every point the port measured has the JAX package's recall at the
    same params (IVF-PQ's points are held rung by rung above)."""
    _, queries, gt = clustered
    jix, tix = jax_indexes[family]
    jmod = {"ivf_flat": jivf, "cagra": jcagra}[family]
    tres = tune(family, tix, queries, k=K, target_recall=0.9,
                ground_truth=gt, iters=1)
    jres = jtune.tune(family, jix, queries, k=K, target_recall=0.9,
                      ground_truth=gt, iters=1)
    assert tres.met == jres.met
    jtype = type(jres.curve[0].param)
    for pt in tres.curve:
        jsp = jtype(**dataclasses.asdict(pt.param))
        assert pt.recall == _recall(jmod, jsp, jix, jnp.asarray(queries), gt)


@pytest.mark.parametrize("budget", [6 << 30, 8 << 30, 16 << 30, 10 ** 12])
@pytest.mark.parametrize("families", [None, ["flat"], ["ivf_flat", "cagra"]])
def test_candidate_ladder_equals_the_jax_package(budget, families):
    for dim, n_total, dtype in ((768, 10_000_000, "bfloat16"),
                                (384, 30_000_000, "float32"),
                                (64, 100_000, "bfloat16")):
        t = candidate_ladder(dim, n_total, budget, families=families,
                             corpus_dtype=dtype)
        j = jtune.candidate_ladder(dim, n_total, budget, families=families,
                                   corpus_dtype=dtype)
        assert [(c.label(), c.est_bytes, dataclasses.asdict(c.params))
                for c in t] == \
            [(c.label(), c.est_bytes, dataclasses.asdict(c.params))
             for c in j]


def test_memory_budget_types_are_interchangeable():
    """tune_build takes either package's budget object or a byte count."""
    assert jmem.DeviceBudget(8 << 30).usable_bytes == \
        DeviceBudget(8 << 30).usable_bytes
