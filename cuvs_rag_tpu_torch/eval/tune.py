"""Auto-tuning: cheapest search params that hit a recall target.

The counterpart of the JAX package's `eval/tune.py`, with its ladders and
its choices unchanged:

    result = tune("ivf_flat", index, queries, corpus=corpus, k=10,
                  target_recall=0.95)
    dists, ids = ivf_flat.search(result.search_params, index, queries, 10)

Strategy per family (each knob is monotone in recall AND in cost, so a
ladder walk + one refinement step finds the frontier point without a full
grid):
  * flat    — approx (the int8 sketch, K2) if it meets the target, else
              exact (recall 1.0 by construction).
  * ivf_flat — doubling ladder over n_probes, then binary refinement
              between the last miss and the first hit.
  * ivf_pq  — refine_ratio outermost over [16, 32, 64, 100], an n_probes
              ladder within each, then refine_ratio walked down to 8 / 4 /
              2 while the target still holds.
  * cagra   — itopk ladder 32 ... 512, then max_iterations 6 / 4 while
              recall holds.

Ground truth: pass `ground_truth` directly, or `corpus` and it is computed
with the exact streamed oracle (eval/recall.exact_ground_truth_streamed:
one chunk of the corpus at a time, on the index's device).

Latency is measured by CUDA events around each search after a warm-up
(eval/sweeps.measure_point); two runs may pick different parameters where
two points' latencies are close, but not a different recall curve.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from cuvs_rag_tpu_torch.eval import recall as recall_lib
from cuvs_rag_tpu_torch.eval.sweeps import SweepPoint, measure_point
from cuvs_rag_tpu_torch.index import base as index_base
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import (
    CagraSearchParams,
    FlatSearchParams,
    IVFFlatSearchParams,
    IVFPQSearchParams,
)


@dataclasses.dataclass
class TuneResult:
    search_params: Any  # cheapest params meeting the target (None: not met)
    point: Optional[SweepPoint]  # its measured recall/latency
    target_recall: float
    curve: List[SweepPoint]  # every configuration measured along the way
    met: bool

    def __repr__(self):
        if not self.met:
            return (f"TuneResult(target {self.target_recall} NOT met; best "
                    f"measured {max((p.recall for p in self.curve), default=0):.3f})")
        return (f"TuneResult({self.search_params}, recall "
                f"{self.point.recall:.3f}, "
                f"{self.point.latency_ms_per_query:.3f} ms/query)")


def _measure(mod, index, sp, queries_t, gt, k, iters) -> SweepPoint:
    return measure_point(lambda: mod.search(sp, index, queries_t, k), sp,
                         queries_t.shape[0], gt, k, iters)


def tune(
    family: str,
    index: Any,
    queries: np.ndarray,
    *,
    k: int = 10,
    target_recall: float = 0.95,
    ground_truth: Optional[np.ndarray] = None,
    corpus: Optional[np.ndarray] = None,
    iters: int = 3,
) -> TuneResult:
    """Find the cheapest search params with recall@k >= target_recall.

    queries: a REPRESENTATIVE sample (tuning on off-distribution queries
    tunes for the wrong operating point — same caveat as FAISS autotune).
    """
    from cuvs_rag_tpu_torch.parallel import search as psearch

    mod = psearch.FAMILIES[family]
    queries_t = index_base.as_tensor(queries, index.device)
    if ground_truth is None:
        if corpus is None:
            raise ValueError("pass ground_truth or corpus")
        # streamed oracle: one chunk of the corpus at a time on the
        # index's device, no second full fp32 flat index
        ground_truth = recall_lib.exact_ground_truth_streamed(
            index_base.as_tensor(corpus, index.device), queries_t, k,
            index.metric
        )
    gt = np.asarray(ground_truth)
    curve: List[SweepPoint] = []

    def meas(sp) -> SweepPoint:
        pt = _measure(mod, index, sp, queries_t, gt, k, iters)
        curve.append(pt)
        return pt

    if family == "flat":
        approx = meas(FlatSearchParams(approx=True))
        if approx.recall >= target_recall:
            return TuneResult(approx.param, approx, target_recall, curve, True)
        exact = meas(FlatSearchParams(approx=False))
        met = exact.recall >= target_recall
        # search_params stays None only when the target was NOT met
        # (the documented contract); exact-that-meets returns approx=False
        return TuneResult(exact.param if met else None, exact,
                          target_recall, curve, met)

    if family == "ivf_flat":
        best = _ladder_then_bisect(
            meas, lambda p: IVFFlatSearchParams(n_probes=p),
            hi=index.n_lists, target=target_recall,
        )
        return TuneResult(
            best.param if best else None, best, target_recall, curve,
            best is not None,
        )

    if family == "ivf_pq":
        # refine depth CAPS recall regardless of probes (the ADC shortlist
        # is the quality bound, the exact re-rank only reorders it), so the
        # probe ladder alone can plateau below target. Tune refine
        # outermost (ascending), nprobe innermost:
        # the first (refine, minimal-nprobe) hit is the cheapest operating
        # point since refine dominates latency above the plateau.
        ladder = [16, 32, 64, 100] if index.has_raw else [0]
        best = None
        for rr in ladder:
            best = _ladder_then_bisect(
                meas,
                lambda p, rr=rr: IVFPQSearchParams(
                    n_probes=p, refine_ratio=rr),
                hi=index.n_lists, target=target_recall,
                plateau_after=2,
            )
            if best is not None:
                break
        if best is not None and index.has_raw:
            # walk refine down while the target holds (refine dominates cost)
            np_best = best.param.n_probes
            for rr in (8, 4, 2):
                pt = meas(IVFPQSearchParams(n_probes=np_best, refine_ratio=rr))
                if pt.recall >= target_recall and (
                    pt.latency_ms_per_query < best.latency_ms_per_query
                ):
                    best = pt
                else:
                    break
        return TuneResult(
            best.param if best else None, best, target_recall, curve,
            best is not None,
        )

    if family == "cagra":
        best = None
        for itopk in (32, 64, 128, 256, 512):
            pt = meas(CagraSearchParams(itopk_size=itopk))
            if pt.recall >= target_recall:
                best = pt
                break
        if best is not None:
            # shallower traversals at the winning beam width (clustered
            # corpora need few hops)
            itopk = best.param.itopk_size
            for mi in (6, 4):
                pt = meas(CagraSearchParams(itopk_size=itopk,
                                            max_iterations=mi))
                if pt.recall >= target_recall and (
                    pt.latency_ms_per_query < best.latency_ms_per_query
                ):
                    best = pt
                else:
                    break
        return TuneResult(
            best.param if best else None, best, target_recall, curve,
            best is not None,
        )

    raise ValueError(f"no tuner for family {family!r}")


@dataclasses.dataclass
class RouteResult:
    """route_large_k outcome: which path serves k and at what cost."""

    route: str  # "approx" (tuned family params) | "exact" (flat scan)
    search_params: Any  # tuned approx params; None when route == "exact"
    point: SweepPoint  # the winner's measured recall/latency
    exact_point: SweepPoint  # the exact path's measurement (recall 1.0)
    curve: List[SweepPoint]  # approx configs measured along the way

    def __repr__(self):
        return (f"RouteResult({self.route}, recall {self.point.recall:.3f}, "
                f"{self.point.latency_ms_per_query:.3f} ms/query; exact was "
                f"{self.exact_point.latency_ms_per_query:.3f})")


def route_large_k(
    family: str,
    index: Any,
    flat_index: Any,
    queries: np.ndarray,
    k: int = 2000,
    *,
    target_recall: float = 0.95,
    ground_truth: Optional[np.ndarray] = None,
    iters: int = 2,
) -> RouteResult:
    """Pick the cheaper of {tuned approximate search, exact flat scan} at a
    LARGE k (the reference's default SearchConfig.top_k=2000,
    improved_multi_gpu_rag.py:37-48).

    At k=2000 an IVF shortlist must cover 2000 true neighbors spread over
    many lists, so the nprobe needed for recall>=target can cost more than
    the exact scan (flat's certified large-k kernel, K3). The approx
    family is tuned with `tune()` (ladder + bisect at this k; IVF-Flat
    takes its certified large-k kernel, K5, where the window admits it);
    the exact path is measured on `flat_index` (recall 1.0 by
    construction); the cheaper config meeting the target wins.
    """
    from cuvs_rag_tpu_torch.parallel import search as psearch

    flat_mod = psearch.FAMILIES["flat"]
    queries_t = index_base.as_tensor(queries, flat_index.device)
    if ground_truth is None:
        _, gtl = flat_mod.search(None, flat_index, queries_t, k)
        ground_truth = gtl.cpu().numpy()
    gt = np.asarray(ground_truth)
    exact_pt = _measure(flat_mod, flat_index, None, queries_t, gt, k, iters)
    tr = tune(family, index, queries, k=k, target_recall=target_recall,
              ground_truth=gt, iters=iters)
    if tr.met and (
        tr.point.latency_ms_per_query < exact_pt.latency_ms_per_query
    ):
        return RouteResult("approx", tr.search_params, tr.point, exact_pt,
                           tr.curve)
    return RouteResult("exact", None, exact_pt, exact_pt, tr.curve)


@dataclasses.dataclass
class BuildCandidate:
    """One (family, build params) point on the memory/quality ladder."""

    family: str
    params: Any
    est_bytes: int  # estimated resident footprint at n_total rows

    def label(self) -> str:
        p = self.params
        if self.family in ("flat", "ivf_flat"):
            return f"{self.family}[{p.dtype}]"
        if self.family == "ivf_pq":
            bits = p.pq_bits
            raw = "+raw" if p.store_raw else ",codes-only"
            opq = "+opq" if p.opq else ""
            return f"ivf_pq[{bits}b,m={p.pq_dim}{opq}{raw}]"
        return self.family


@dataclasses.dataclass
class TuneBuildResult:
    candidate: Optional[BuildCandidate]  # winner (None: target not met)
    search_params: Any  # its tuned search params
    point: Optional[SweepPoint]  # measured recall/latency of the winner
    build_seconds: float  # winner's sample build time
    target_recall: float
    n_total: int
    budget_bytes: int
    trials: List[dict]  # every candidate: {candidate, tune, build_s, fits}
    met: bool

    def __repr__(self):
        if not self.met:
            return (f"TuneBuildResult(target {self.target_recall} NOT met "
                    f"by any in-budget candidate; {len(self.trials)} tried)")
        return (f"TuneBuildResult({self.candidate.label()}, "
                f"{self.search_params}, recall {self.point.recall:.3f}, "
                f"{self.point.latency_ms_per_query:.3f} ms/query, "
                f"~{self.candidate.est_bytes/1e9:.2f} GB at "
                f"n={self.n_total})")


def candidate_ladder(
    dim: int,
    n_total: int,
    budget_bytes: int,
    *,
    families: Optional[Sequence[str]] = None,
    corpus_dtype: str = "bfloat16",
    working_factor: float = 1.3,
) -> List[BuildCandidate]:
    """Build-param candidates that FIT `budget_bytes` at n_total rows,
    cheapest-memory first.

    The ladder covers the framework's storage/recall trade-offs (the knobs
    the reference hard-coded per notebook — n_lists heuristics at
    index_building_coordinator.py:394, pq_dim=96 at
    VectorSearch_QuestionRetrieval.ipynb#cell6): IVF-PQ codes-only
    (smallest, ADC-bounded recall), IVF-PQ + raw refine store, int8 SQ8
    IVF-Flat, bf16/fp32 IVF-Flat, CAGRA. n_lists stays 0 (auto) so the
    full-corpus build re-derives it from n_total, not the sample size.
    `working_factor` reserves build-temp headroom above the resident
    estimate.
    """
    from cuvs_rag_tpu_torch.utils import memory as memlib
    from cuvs_rag_tpu_torch.utils.config import (
        CagraParams,
        IVFFlatParams,
        IVFPQParams,
    )

    families = list(families) if families else ["ivf_pq", "ivf_flat", "cagra"]
    known = {"flat", "ivf_flat", "ivf_pq", "cagra"}
    unknown = sorted(set(families) - known)
    if unknown:
        raise ValueError(
            f"unknown families {unknown}; choose from {sorted(known)}"
        )
    m8 = max(1, dim // 8)
    m4 = max(1, dim // 4)
    cands: List[BuildCandidate] = []

    def est(family, **kw):
        return int(
            memlib.index_bytes_estimate(n_total, dim, family, **kw)
            * working_factor
        )

    if "ivf_pq" in families:
        for m, opq in ((m8, True), (m4, True)):
            cands.append(BuildCandidate(
                "ivf_pq",
                IVFPQParams(pq_dim=m, pq_bits=8, opq=opq, store_raw=False),
                est("ivf_pq", pq_dim=m, store_raw=False,
                    dtype=corpus_dtype),
            ))
        for m in (m8,):
            cands.append(BuildCandidate(
                "ivf_pq",
                IVFPQParams(pq_dim=m, pq_bits=8, store_raw=True),
                est("ivf_pq", pq_dim=m, store_raw=True, dtype=corpus_dtype),
            ))
    if "ivf_flat" in families:
        for dt in ("int8", "bfloat16", "float32"):
            if dt == "float32" and corpus_dtype != "float32":
                continue
            cands.append(BuildCandidate(
                "ivf_flat", IVFFlatParams(dtype=dt), est("ivf_flat", dtype=dt)
            ))
    if "cagra" in families:
        cands.append(BuildCandidate(
            "cagra", CagraParams(dtype="auto"),
            est("cagra", dtype=corpus_dtype),
        ))
    if "flat" in families:
        # the module-docstring crossover: exact flat beats both approximate
        # families on unclusterable corpora up to ~4M rows — measurable
        # only if the ladder actually contains it
        from cuvs_rag_tpu_torch.utils.config import FlatParams

        for dt in ("int8", "bfloat16", "float32"):
            if dt == "float32" and corpus_dtype != "float32":
                continue
            cands.append(BuildCandidate(
                "flat", FlatParams(dtype=dt), est("flat", dtype=dt)
            ))
    cands = [c for c in cands if c.est_bytes <= budget_bytes]
    cands.sort(key=lambda c: c.est_bytes)
    return cands


def tune_build(
    corpus_sample: Any,
    queries: np.ndarray,
    *,
    n_total: int,
    k: int = 10,
    target_recall: float = 0.95,
    budget: Optional[Any] = None,
    families: Optional[Sequence[str]] = None,
    ground_truth: Optional[np.ndarray] = None,
    iters: int = 3,
    working_factor: float = 1.3,
    verbose: bool = False,
    device=None,
) -> TuneBuildResult:
    """Pick build params (family, storage dtype, pq_dim/bits, OPQ,
    refine store) that fit a device budget at `n_total` rows AND hit a
    recall target — measured, not heuristic (VERDICT r3 #7; the loop the
    reference never closed: its param choices were fixed per notebook).

        res = tune_build(sample, queries, n_total=30_000_000,
                         target_recall=0.95,
                         budget=memory.detect_budget())
        ix = FAMILIES[res.candidate.family].build(res.candidate.params,
                                                  full_corpus)

    Every in-budget candidate is built on `corpus_sample` and its search
    params tuned with `tune()`; the winner is the candidate meeting the
    target with the lowest measured ms/query (tie: fewest bytes — the
    ladder is pre-sorted by footprint, and Python's sort is stable).
    Latency is measured on the sample, so it ranks candidates rather than
    predicting full-corpus latency; recall on a uniform sample is a good
    proxy because both list population and query neighborhoods subsample
    together. A numpy sample goes to `device` (the card when None); a
    tensor stays where it is.
    """
    from cuvs_rag_tpu_torch.parallel import search as psearch
    from cuvs_rag_tpu_torch.utils import memory as memlib

    sample = index_base.as_tensor(corpus_sample, device)
    n_s, dim = sample.shape
    if budget is None:
        budget = memlib.detect_budget(sample.device)
    budget_bytes = (budget.usable_bytes
                    if hasattr(budget, "usable_bytes") else int(budget))
    corpus_dtype = str(sample.dtype).replace("torch.", "")
    cands = candidate_ladder(
        dim, n_total, budget_bytes, families=families,
        corpus_dtype=corpus_dtype, working_factor=working_factor,
    )
    if ground_truth is None:
        ground_truth = recall_lib.exact_ground_truth_streamed(
            sample, np.asarray(queries), k, "sqeuclidean"
        )
    trials: List[dict] = []
    best = None  # (point, candidate, tuneres, build_s)
    for cand in cands:
        mod = psearch.FAMILIES[cand.family]
        t0 = time.perf_counter()
        ix = mod.build(cand.params, sample)
        profiling.drain(ix)
        build_s = time.perf_counter() - t0
        tr = tune(cand.family, ix, queries, k=k,
                  target_recall=target_recall, ground_truth=ground_truth,
                  iters=iters)
        trials.append({"candidate": cand, "tune": tr, "build_s": build_s})
        if verbose:
            print(f"  {cand.label():28s} ~{cand.est_bytes/1e9:6.2f} GB  "
                  f"build {build_s:5.1f}s  {tr}", flush=True)
        if tr.met and (
            best is None
            or tr.point.latency_ms_per_query
            < best[0].latency_ms_per_query
        ):
            best = (tr.point, cand, tr, build_s)
        del ix
        gc.collect()
    if best is None:
        return TuneBuildResult(
            None, None, None, 0.0, target_recall, n_total, budget_bytes,
            trials, False,
        )
    point, cand, tr, build_s = best
    return TuneBuildResult(
        cand, tr.search_params, point, build_s, target_recall, n_total,
        budget_bytes, trials, True,
    )


def _ladder_then_bisect(meas, make, hi: int, target: float,
                        plateau_after: int = 0):
    """Doubling ladder over an int knob, then binary refinement between the
    last miss and the first hit. Returns the cheapest passing SweepPoint
    (None if even `hi` misses). plateau_after > 0: give up early when the
    knob has SATURATED — recall gains under 0.005 absolute AND under 20%
    relative over that many consecutive doublings (the relative clause
    keeps the low-recall regime alive: at recall 0.002 a doubling that
    doubles recall is linear progress, not a plateau) — e.g. nprobe under
    a refine-depth recall cap, where measuring up to `hi` only burns time
    on a lost cause."""
    lo_fail = 0
    first_hit = None  # (knob, SweepPoint)
    p = 1
    flat_steps = 0
    prev_recall = -1.0
    while p < hi:
        pt = meas(make(p))
        if pt.recall >= target:
            first_hit = (p, pt)
            break
        gain = pt.recall - prev_recall
        if plateau_after and gain < 0.005 and (
            gain < 0.2 * max(prev_recall, 1e-9)
        ):
            flat_steps += 1
            if flat_steps >= plateau_after:
                return None
        else:
            flat_steps = 0
        prev_recall = pt.recall
        lo_fail = p
        p *= 2
    if first_hit is None:
        pt = meas(make(hi))
        if pt.recall < target:
            return None
        first_hit = (hi, pt)
        # bisect in (lo_fail, hi)
    # track the knob value alongside the point: reading it back off
    # param.n_probes would break any non-IVF caller of this generic helper
    (hi_knob, hi_pass), lo = first_hit, lo_fail
    while hi_knob - lo > 1:
        mid = (lo + hi_knob) // 2
        pt = meas(make(mid))
        if pt.recall >= target:
            hi_knob, hi_pass = mid, pt
        else:
            lo = mid
    return hi_pass
