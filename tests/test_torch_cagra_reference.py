"""The port's CAGRA search against the benchmark's plain beam-search
reference (`benchmark/reference/cagra_beam.py`), on the CPU at a small
seeded size: 2,048 x 64 rows near a 16-dim subspace (as the benchmark's
rows lie near one), graph degree 16 over 32, itopk 32, search width 4,
k = 10, exact and IVF-bootstrapped graphs, fp32 and bf16 rows.

Both walk the same graph from the same entry rows by the same rules, so
they return the same ids wherever no two distances they compare are tied
within the port's fp32 rounding. A near-tie can send the two walks down
different paths, which is why agreement is held on 99% of the queries and
not on each. At the auto iteration count both beams have settled, so the
check's teeth are shown where the count binds: four iterations from four
entry rows, against a reference one iteration short. The reference itself
is held to brute force on a complete graph, and its evenly spaced entry
rows and iteration count to the port's."""

import numpy as np
import pytest
import torch

from benchmark.reference import cagra_beam as ref
from cuvs_rag_tpu_torch.index import cagra
from cuvs_rag_tpu_torch.ops import graph as graph_ops
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.utils.compare import compare_topk
from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams

N, D, Q, K = 2048, 64, 200, 10
SP = CagraSearchParams(itopk_size=32, search_width=4)
# where the iteration count binds: each iteration changes the answer
SP_SHORT = CagraSearchParams(itopk_size=32, search_width=4,
                             num_entry_points=4, max_iterations=4)
# the share of queries whose ids must agree as sets (ties at the k-th place
# allowed): fp32 against float64 may order near-ties differently, and a
# walk that turns another way there may end elsewhere
AGREE = 0.99


def tolerance(q, ix, dtype) -> float:
    """What the port's rounding allows a reported distance of query `q`:
    ||q||² - (2 q·v - ||v||²) is summed in fp32 over D + 2 terms, each at
    most ||q||² + ||v||² in size, so D + 2 roundings of 2^-24 of that;
    bf16 rows also carry ||v||² as hi + lo in two bf16 lanes, lo rounded to
    2^-9 of a remainder of at most 2^-9 ||v||²."""
    r2 = float(ix.sqnorms[:ix.n_valid].max())
    out = (D + 2) * 2.0 ** -24 * (float(q.double().square().sum()) + r2)
    return out + (2.0 ** -17 * r2 if dtype == "bfloat16" else 0.0)


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(20)
    basis, _ = torch.linalg.qr(torch.randn((D, 16), generator=g))
    x = torch.randn((N, 16), generator=g) @ basis.T \
        + 0.02 * torch.randn((N, D), generator=g)
    q = torch.randn((Q, 16), generator=g) @ basis.T \
        + 0.02 * torch.randn((Q, D), generator=g)
    return x, q


def build(x, algo, dtype):
    return cagra.build(CagraParams(
        intermediate_graph_degree=32, graph_degree=16, build_algo=algo,
        build_nlists=16, dtype=dtype), x)


def reference(ix, q, sp=SP, max_iterations=0):
    return ref.beam_search(
        ix.vectors, ix.graph, ix.n_valid, ix.entry_centroids, ix.entry_rows,
        q, K, itopk=sp.itopk_size, search_width=sp.search_width,
        num_entry_points=sp.num_entry_points,
        max_iterations=max_iterations)


def agreement(ix, q, dist, ids, ref_d, ref_i, dtype):
    """(share of queries whose ids agree with the reference's as sets, ties
    at the k-th allowed, and whose distances are within `tolerance` of the
    reference's rank by rank; the worst distance gap among them, as a share
    of that tolerance)."""
    ok, worst = 0, 0.0
    for j in range(ids.shape[0]):
        tol = tolerance(q[j], ix, dtype)
        try:
            gap = compare_topk(-dist[j:j + 1].double(), ids[j:j + 1].long(),
                               -ref_d[j:j + 1], ref_i[j:j + 1], rtol=0.0,
                               atol=tol)
        except AssertionError:
            continue
        ok += 1
        worst = max(worst, gap / tol)
    return ok / ids.shape[0], worst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["exact", "ivf"])
def test_port_returns_the_reference_ids(data, algo, dtype):
    torch.set_num_threads(1)
    x, q = data
    ix = build(x, algo, dtype)
    assert ix.has_entry_map == (algo == "ivf")
    dist, ids = psearch.search(SP, ix, q, K)
    ref_d, ref_i = reference(ix, q)
    share, worst = agreement(ix, q, dist, ids, ref_d, ref_i, dtype)
    assert share >= AGREE, share
    assert worst <= 1.0


@pytest.mark.parametrize("algo", ["exact", "ivf"])
def test_a_beam_one_iteration_short_fails(data, algo):
    """Where the iteration count binds, the port agrees with the reference
    at its own count, and the check tells it from a reference one
    iteration short."""
    torch.set_num_threads(1)
    x, q = data
    ix = build(x, algo, "float32")
    dist, ids = psearch.search(SP_SHORT, ix, q, K)
    ref_d, ref_i = reference(ix, q, SP_SHORT, max_iterations=4)
    assert agreement(ix, q, dist, ids, ref_d, ref_i, "float32")[0] >= AGREE
    short_d, short_i = reference(ix, q, SP_SHORT, max_iterations=3)
    assert agreement(ix, q, dist, ids, short_d, short_i,
                     "float32")[0] < AGREE


def test_reference_is_exact_on_a_complete_graph():
    """Every row a neighbour of every row: one expansion scores them all,
    so the reference returns brute force's top-k (ties to the lower id)."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((40, 8), generator=g)
    q = torch.randn((7, 8), generator=g)
    graph = torch.stack([torch.cat([torch.arange(i), torch.arange(i + 1, 40)])
                         for i in range(40)])
    d, i = ref.beam_search(x, graph, 40, torch.zeros((0, 8)),
                           torch.zeros(0, dtype=torch.int32), q, 5, itopk=8,
                           search_width=1, num_entry_points=3)
    full = ((q.double()[:, None, :] - x.double()[None]) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(40), full.shape),
                       full.numpy()), axis=1)[:, :5]
    assert i.tolist() == want.tolist()
    assert torch.allclose(d, torch.gather(full, 1, torch.from_numpy(want)))


@pytest.mark.parametrize("n,count", [(2048, 128), (2048, 1), (1000, 37),
                                     (10_000_000, 112), (33, 33)])
def test_evenly_spaced_rows_are_the_ports(n, count):
    torch.set_num_threads(1)
    assert ref.evenly_spaced(n, count) == \
        graph_ops.linspace_rows(n, count, "cpu").tolist()


def test_plan_is_the_ports():
    for itopk, k, width, iters in [(32, 10, 4, 0), (64, 10, 16, 0),
                                   (8, 10, 32, 0), (256, 10, 1, 0),
                                   (64, 10, 16, 5)]:
        assert ref.plan(itopk, k, width, iters) == graph_ops.beam_plan(
            itopk, k, width, iters)
    assert ref.plan(64, 10, 16) == (64, 16, 8)
