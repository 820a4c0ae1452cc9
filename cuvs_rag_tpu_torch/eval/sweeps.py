"""Parameter sweeps: recall/latency operating curves.

The counterpart of the JAX package's `eval/sweeps.py`: sweep n_probes
(IVF) or beam width (CAGRA) and report the recall-vs-latency frontier
against the exact oracle. Latency on a card comes from CUDA events around
each call after a warm-up (`utils/profiling.call_seconds`); on the CPU from
the host clock.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from cuvs_rag_tpu_torch.eval import recall as recall_lib
from cuvs_rag_tpu_torch.utils import profiling


@dataclasses.dataclass
class SweepPoint:
    param: Any
    recall: float
    latency_ms_per_query: float
    qps: float


def measure_point(fn, label, n_queries: int, ground_truth: np.ndarray,
                  k: int, iters: int) -> SweepPoint:
    """One configuration: fn() -> (distances, ids), warmed up once, then
    timed over `iters` calls; recall@k of its ids against `ground_truth`."""
    dt = float(np.mean(profiling.call_seconds(fn, iters)))
    _, i = fn()
    r = recall_lib.recall_at_k(i.cpu().numpy(), ground_truth, k)
    return SweepPoint(param=label, recall=r,
                      latency_ms_per_query=dt / n_queries * 1e3,
                      qps=n_queries / dt)


def operating_curve(
    search_fns: Sequence[tuple],
    queries,
    ground_truth: np.ndarray,
    k: int,
    iters: int = 3,
) -> List[SweepPoint]:
    """search_fns: [(param_label, fn(queries, k) -> (dists, ids)), ...].

    Returns one SweepPoint per configuration, recall measured against the
    exact ground truth.
    """
    return [
        measure_point(lambda fn=fn: fn(queries, k), label, len(queries),
                      ground_truth, k, iters)
        for label, fn in search_fns
    ]


def best_operating_point(
    curve: Sequence[SweepPoint], min_recall: float = 0.95
) -> Optional[SweepPoint]:
    """Highest-QPS point meeting the recall target (the north-star metric)."""
    ok = [p for p in curve if p.recall >= min_recall]
    return max(ok, key=lambda p: p.qps) if ok else None


def nprobe_sweep(
    family_mod,
    index,
    make_params: Callable[[int], Any],
    queries,
    ground_truth: np.ndarray,
    k: int,
    n_probes_list: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
) -> List[SweepPoint]:
    """Convenience wrapper for IVF-style indexes."""
    fns = [
        (p, (lambda p_: lambda q, kk: family_mod.search(make_params(p_), index, q, kk))(p))
        for p in n_probes_list
    ]
    return operating_curve(fns, queries, ground_truth, k)
