"""The spans the port's search path records (utils/profiling), on the CPU
with the recorder on: the exact tree of names, parents and attrs, one
request id a call, for a single flat search, a single IVF-Flat search, a
replicated flat search over four CPU positions and a single CAGRA search
(with the CAGRA counters' nominal work). The answers are the same with the
recorder on and off. K1's and K4's `kernel.launch` spans
need the card: tests/test_torch_cuda_kernels.py holds them."""

import pytest
import torch

from cuvs_rag_tpu_torch.index import cagra, flat, ivf_flat
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import (
    CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
    IVFFlatSearchParams)
from cuvs_rag_tpu_torch.utils.metrics import default_registry

torch.set_num_threads(1)


@pytest.fixture
def data():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2048, 32), generator=g)
    return x, x[:12] + 0.01 * torch.randn((12, 32), generator=g)


@pytest.fixture
def recorder():
    profiling.record_spans(False)
    profiling.clear()
    yield profiling
    profiling.record_spans(False)
    profiling.clear()


def tree(spans):
    """[(name, attrs, [children...])] of the spans' roots, children in the
    order they started."""
    kids = {}
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        kids.setdefault(s["parent"], []).append(s)

    def node(s):
        return (s["name"], s["attrs"], [node(c) for c in kids.get(s["id"],
                                                                  [])])
    return [node(s) for s in kids.get(None, [])]


def traced(recorder, fn):
    """fn() with the recorder off and on: (answers equal, spans of the
    traced call)."""
    off = fn()
    assert recorder.spans() == []
    recorder.record_spans(True)
    on = fn()
    recorder.record_spans(False)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    return recorder.spans()


def test_single_flat_search(recorder, data):
    x, q = data
    ix = flat.build(FlatParams(), x)
    spans = traced(recorder, lambda: psearch.search(None, ix, q, 5))
    assert tree(spans) == [
        ("search", {"family": "flat", "placement": "single", "queries": 12},
         [("flat.search", {}, [])])]
    assert len({s["request"] for s in spans}) == 1


def test_single_ivf_flat_search(recorder, data):
    x, q = data
    ix = ivf_flat.build(IVFFlatParams(n_lists=16), x)
    sp = IVFFlatSearchParams(n_probes=4)
    spans = traced(recorder, lambda: psearch.search(sp, ix, q, 5))
    assert tree(spans) == [
        ("search", {"family": "ivf_flat", "placement": "single",
                    "queries": 12},
         [("ivf_flat.search", {}, [("ivf_flat.probe", {}, [])])])]
    assert len({s["request"] for s in spans}) == 1
    # a second call is a request of its own
    recorder.record_spans(True)
    psearch.search(sp, ix, q, 5)
    assert len({s["request"] for s in recorder.spans()}) == 2


def test_replicated_flat_search_over_four_positions(recorder, data):
    x, q = data
    mesh = DeviceMesh(["cpu"] * 4)
    rix = psearch.build_replicated("flat", FlatParams(), x, mesh)
    spans = traced(recorder, lambda: psearch.search(None, rix, q, 5, mesh))
    position = [("fan_out.position", {"position": i},
                 [("flat.search", {}, [])]) for i in range(4)]
    assert tree(spans) == [
        ("search", {"family": "flat", "placement": "replicate",
                    "queries": 12},
         position + [("fan_out.join", {}, [])])]
    assert len({s["request"] for s in spans}) == 1
    # the positions run one after another, the join after the last
    pos = sorted((s for s in spans if s["name"] == "fan_out.position"),
                 key=lambda s: s["start_ns"])
    join = [s for s in spans if s["name"] == "fan_out.join"][0]
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(pos, pos[1:]))
    assert pos[-1]["end_ns"] <= join["start_ns"]


CAGRA_COUNTERS = ("cagra.queries", "cagra.iterations", "cagra.entry_rows",
                  "cagra.candidate_rows")


def cagra_counters():
    c = default_registry.snapshot()["counters"]
    return {k: c.get(k, 0.0) for k in CAGRA_COUNTERS}


@pytest.mark.parametrize("algo", ["exact", "ivf"])
def test_single_cagra_search(recorder, data, algo):
    x, q = data
    ix = cagra.build(CagraParams(intermediate_graph_degree=16,
                                 graph_degree=8, build_algo=algo,
                                 build_nlists=16), x)
    sp = CagraSearchParams(itopk_size=32, search_width=4)
    before = cagra_counters()
    spans = traced(recorder, lambda: psearch.search(sp, ix, q, 5))
    assert tree(spans) == [
        ("search", {"family": "cagra", "placement": "single",
                    "queries": 12},
         [("cagra.search", {}, [("cagra.entry", {}, []),
                                ("cagra.beam", {}, [])])])]
    assert len({s["request"] for s in spans}) == 1
    # the traced call alone counted: 12 queries, 2 * ceil(32 / 4) = 16
    # iterations of 4 parents x 8 neighbours, 128 entry rows each (the
    # medoids of the 16 lists, then 112 evenly spaced rows, on the ivf
    # graph)
    after = cagra_counters()
    assert {k: after[k] - before[k] for k in CAGRA_COUNTERS} == {
        "cagra.queries": 12, "cagra.iterations": 16 * 12,
        "cagra.entry_rows": 12 * 128,
        "cagra.candidate_rows": 12 * (16 * 4 * 8 + 128)}


def test_cagra_counters_follow_the_parameters(recorder, data):
    """Counted from the call's parameters: a given iteration count, a
    search width past the beam (clamped to it), fewer entry points than
    rows; nothing while the recorder is off."""
    x, q = data
    ix = cagra.build(CagraParams(intermediate_graph_degree=16,
                                 graph_degree=8), x)
    before = cagra_counters()
    psearch.search(CagraSearchParams(itopk_size=16, search_width=64,
                                     max_iterations=3,
                                     num_entry_points=20), ix, q, 5)
    assert cagra_counters() == before
    recorder.record_spans(True)
    psearch.search(CagraSearchParams(itopk_size=16, search_width=64,
                                     max_iterations=3,
                                     num_entry_points=20), ix, q, 5)
    recorder.record_spans(False)
    after = cagra_counters()
    assert {k: after[k] - before[k] for k in CAGRA_COUNTERS} == {
        "cagra.queries": 12, "cagra.iterations": 3 * 12,
        "cagra.entry_rows": 12 * 20,
        "cagra.candidate_rows": 12 * (3 * 16 * 8 + 20)}
