"""SearchResultAggregator — the reference's spec, implemented.

The reference's `search_result_aggregator.py` was an EMPTY file; its entire
contract lives in the 502-line test file
(Attempt_1/test_search_result_aggregator.py, SURVEY.md §2 #4). This module
implements that contract faithfully — per-device `SearchResult` records,
row-wise global merge, NaN rejection, query-count consistency checks,
distance filtering — as the *host-side/API-edge* aggregation layer.

In the port the hot path never materializes per-shard results on the host
(parallel/search.py merges on the first mesh device); this layer exists for
(a) cross-process / multi-host-without-ICI aggregation, (b) mixing results
from heterogeneous backends, (c) spec parity. The merge core delegates to
the native C++ heap merge (cuvs_rag_tpu_torch/native).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from cuvs_rag_tpu_torch import native


@dataclasses.dataclass
class SearchResult:
    """Per-device search output (spec: test_search_result_aggregator.py:33-47).

    distances/indices: (Q, k) arrays; device_id replaces the reference's
    gpu_id; query_time in seconds.
    """

    distances: np.ndarray
    indices: np.ndarray
    device_id: int
    query_time: float
    k_requested: int

    def __post_init__(self):
        self.distances = np.asarray(self.distances)
        self.indices = np.asarray(self.indices)
        if self.distances.ndim != 2 or self.indices.ndim != 2:
            raise ValueError("distances and indices must be 2-D (Q, k)")
        if self.distances.shape != self.indices.shape:
            raise ValueError(
                f"shape mismatch: distances {self.distances.shape} vs "
                f"indices {self.indices.shape}"
            )

    @property
    def k_returned(self) -> int:
        return self.distances.shape[1]

    @property
    def num_queries(self) -> int:
        return self.distances.shape[0]


@dataclasses.dataclass
class AggregatedSearchResult:
    """Merged output (spec :140-168)."""

    final_distances: np.ndarray
    final_indices: np.ndarray
    total_query_time: float
    device_results: List[SearchResult]
    k: int

    @property
    def num_devices(self) -> int:
        return len(self.device_results)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Spec :212-225 (`SearchConfig` there; renamed to avoid clashing with
    the global SearchConfig)."""

    k: int = 10
    ascending: bool = True  # True for distances (L2), False for similarities
    validate: bool = True
    timeout_s: float = 300.0


def validate_search_results(results: Sequence[SearchResult]) -> None:
    """NaN rejection (spec :292-306) + query-count consistency (:365-387)."""
    if not results:
        raise ValueError("no search results to aggregate")
    q0 = results[0].num_queries
    for r in results:
        if r.num_queries != q0:
            raise ValueError(
                f"inconsistent query counts across devices: "
                f"{[x.num_queries for x in results]}"
            )
        finite_or_inf = np.isfinite(r.distances) | np.isinf(r.distances)
        if not np.all(finite_or_inf):
            raise ValueError(
                f"NaN distances in device {r.device_id} results"
            )


def merge_search_results(
    results: Sequence[SearchResult], k: int, ascending: bool = True
):
    """Row-wise global merge across devices (spec golden semantics :330-358).

    Per-shard lists must be sorted (ascending distances or descending
    similarities); invalid slots marked index -1.
    """
    if not results:
        raise ValueError("no search results to merge")
    k_in = max(r.k_returned for r in results)
    s = len(results)
    q = results[0].num_queries
    scores = np.full((s, q, k_in), np.inf if ascending else -np.inf, np.float32)
    ids = np.full((s, q, k_in), -1, np.int32)
    for i, r in enumerate(results):
        scores[i, :, : r.k_returned] = r.distances
        ids[i, :, : r.k_returned] = r.indices
    out_s, out_i = native.topk_merge(scores, ids, k, descending=not ascending)
    return out_s, out_i


def combine_search_results(
    results: Sequence[SearchResult], k: int, ascending: bool = True
) -> AggregatedSearchResult:
    """Free-function surface (spec import list :14-21)."""
    d, i = merge_search_results(results, k, ascending)
    return AggregatedSearchResult(
        final_distances=d,
        final_indices=i,
        total_query_time=sum(r.query_time for r in results),
        device_results=list(results),
        k=k,
    )


def filter_search_results_by_distance(
    result: AggregatedSearchResult,
    max_distance: float,
) -> AggregatedSearchResult:
    """Drop hits beyond max_distance (spec import list :14-21); removed
    slots become (inf, -1)."""
    keep = result.final_distances <= max_distance
    d = np.where(keep, result.final_distances, np.inf)
    i = np.where(keep, result.final_indices, -1)
    return dataclasses.replace(result, final_distances=d, final_indices=i)


class SearchResultAggregator:
    """Distributed search over per-device search callables.

    `perform_distributed_search` (spec :405-457): validates the query, runs
    each device's searcher, validates, merges. Device searchers are
    callables (queries, k) -> (distances, indices) — in-process indexes,
    RPC stubs, or the simulated backend below.
    """

    def __init__(self, config: Optional[AggregatorConfig] = None):
        self.config = config or AggregatorConfig()

    def perform_distributed_search(
        self,
        queries: np.ndarray,
        device_searchers: Dict[int, Callable],
        k: Optional[int] = None,
    ) -> AggregatedSearchResult:
        queries = np.asarray(queries)
        if queries.ndim != 2 or queries.shape[0] == 0:
            raise ValueError(f"queries must be non-empty 2-D, got {queries.shape}")
        if not device_searchers:
            raise ValueError("no device searchers provided")
        k = k or self.config.k

        results: List[SearchResult] = []
        for dev_id, fn in sorted(device_searchers.items()):
            t0 = time.perf_counter()
            d, i = fn(queries, k)
            results.append(
                SearchResult(
                    distances=np.asarray(d),
                    indices=np.asarray(i),
                    device_id=dev_id,
                    query_time=time.perf_counter() - t0,
                    k_requested=k,
                )
            )
        if self.config.validate:
            validate_search_results(results)
        return combine_search_results(results, k, self.config.ascending)


def simulated_searcher(corpus: np.ndarray, global_offset: int = 0) -> Callable:
    """Fake backend (spec `_simulate_search` :389-403): exact CPU search via
    the native brute-force kernel, with global-id offsetting."""

    def fn(queries: np.ndarray, k: int):
        d, i = native.brute_topk_l2(corpus, queries, k)
        return d, np.where(i >= 0, i + global_offset, -1)

    return fn
