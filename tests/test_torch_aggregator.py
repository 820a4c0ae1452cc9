"""The port's host-side result aggregator (parallel/aggregator.py, a copy of
the JAX package's with its native merge repointed) against the JAX
package's: every spec case runs through both modules and must give the
same arrays, bit for bit (the same C++ merge on the same inputs)."""

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.parallel import aggregator as jagg
from cuvs_rag_tpu_torch.parallel import aggregator as tagg

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("agg", [tagg, jagg], ids=["port", "jax"])


def _sr(agg, d, i, dev=0):
    d = np.asarray(d, np.float32)
    i = np.asarray(i, np.int32)
    return agg.SearchResult(d, i, device_id=dev, query_time=0.01,
                            k_requested=d.shape[1])


@BOTH
def test_search_result_validation(agg):
    with pytest.raises(ValueError, match="2-D"):
        agg.SearchResult(np.array([1.0, 2.0], np.float32),
                         np.array([1, 2], np.int32), 0, 0.0, 2)
    with pytest.raises(ValueError, match="mismatch"):
        agg.SearchResult(np.zeros((2, 3), np.float32),
                         np.zeros((2, 2), np.int32), 0, 0.0, 3)


def test_merge_golden_two_devices():
    """The golden row-wise interleave across devices by distance."""
    outs = []
    for agg in (tagg, jagg):
        r0 = _sr(agg, [[1.0, 5.0, 9.0]], [[0, 1, 2]], dev=0)
        r1 = _sr(agg, [[2.0, 3.0, 10.0]], [[100, 101, 102]], dev=1)
        outs.append(agg.merge_search_results([r0, r1], k=4))
    d, i = outs[0]
    assert i[0].tolist() == [0, 100, 101, 1]
    assert d[0].tolist() == [1.0, 2.0, 3.0, 5.0]
    for got, want in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(got, want)


@BOTH
def test_merge_single_device_identity(agg):
    d, i = agg.merge_search_results([_sr(agg, [[0.5, 1.5]], [[7, 8]])], k=2)
    assert i[0].tolist() == [7, 8]


@BOTH
def test_nan_rejection(agg):
    with pytest.raises(ValueError, match="NaN"):
        agg.validate_search_results([_sr(agg, [[np.nan, 1.0]], [[0, 1]])])


@BOTH
def test_inconsistent_query_counts(agg):
    r0 = _sr(agg, [[1.0]], [[0]])
    r1 = _sr(agg, [[1.0], [2.0]], [[0], [1]], dev=1)
    with pytest.raises(ValueError, match="inconsistent query counts"):
        agg.validate_search_results([r0, r1])


def test_distance_filter():
    outs = []
    for agg in (tagg, jagg):
        res = agg.combine_search_results(
            [_sr(agg, [[1.0, 2.0, 8.0]], [[0, 1, 2]])], k=3)
        outs.append(agg.filter_search_results_by_distance(res, 5.0))
    assert outs[0].final_indices[0].tolist() == [0, 1, -1]
    np.testing.assert_array_equal(outs[0].final_distances,
                                  outs[1].final_distances)


def test_distributed_search_with_simulated_backends(rng):
    """End to end with the simulated per-device backends, global offsets
    included: both packages return the same merged arrays."""
    corpus = rng.standard_normal((300, 16)).astype(np.float32)
    queries = corpus[[10, 200]]
    outs = []
    for agg in (tagg, jagg):
        searchers = {
            0: agg.simulated_searcher(corpus[:150], global_offset=0),
            1: agg.simulated_searcher(corpus[150:], global_offset=150),
        }
        a = agg.SearchResultAggregator(agg.AggregatorConfig(k=5))
        outs.append(a.perform_distributed_search(queries, searchers))
    out = outs[0]
    assert out.final_indices[0, 0] == 10
    assert out.final_indices[1, 0] == 200  # global id, not shard-local 50
    assert out.num_devices == 2
    assert out.final_distances[0, 0] < 1e-4
    np.testing.assert_array_equal(out.final_indices, outs[1].final_indices)
    np.testing.assert_array_equal(out.final_distances,
                                  outs[1].final_distances)


@BOTH
def test_empty_inputs_rejected(agg):
    a = agg.SearchResultAggregator()
    with pytest.raises(ValueError, match="non-empty"):
        a.perform_distributed_search(np.zeros((0, 4), np.float32),
                                     {0: lambda q, k: None})
    with pytest.raises(ValueError, match="searchers"):
        a.perform_distributed_search(np.zeros((1, 4), np.float32), {})
