"""The port's graph ops (ops/graph.py) against the JAX package's, on the
same seeded numpy inputs.

Tolerances, by what each op computes:
- augment_rows / augmented_query, augment_reverse_edges, list_medoids, the
  evenly spaced entry rows: equal, bit for bit (the npz layout is shared and
  the ops are deterministic; the medoids' scores agree to fp32 rounding and
  no row of these inputs is within it of its list's best).
- build_knn_graph: neighbour sets equal up to ties at the k-th distance
  (utils/compare.py, rtol 1e-5 / atol 1e-4 on fp32 scores).
- build_knn_graph_ivf, on the same JAX-built IVF index: the JAX package
  ranks bf16 scores with approx_max_k(recall_target=0.98), the port fp32
  scores exactly. bf16 scores of these rows tie at the 24th neighbour, so
  the JAX graph shares under 0.95 of each row's neighbours with the exact
  kNN graph (asserted, as the reason for the rule), and an overlap of 0.95
  with it is out of reach for an exact ranking. Held instead: the port's
  graph is at least as close to the exact kNN graph as the JAX graph is,
  and the two overlap within 0.02 of the JAX graph's own overlap with it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.ops import distance as jdist
from cuvs_rag_tpu.ops import graph as jgraph
from cuvs_rag_tpu.utils.config import IVFFlatParams as JIVFParams
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import graph as tgraph
from torch_parity import compare_topk, to_numpy, to_torch

torch.set_num_threads(1)

N, DIM = 2000, 32
METRICS = ("sqeuclidean", "inner_product", "cosine")


def _corpus(seed=11, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((16, d)).astype(np.float32) * 3
    return (cent[rng.integers(0, 16, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def _both(x, dtype):
    """The same rows as a JAX array and a CPU tensor of storage `dtype`."""
    j = jnp.asarray(x).astype(dtype)
    return j, to_torch(j)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_rows_bit_equal(dtype, metric):
    """[v, hi, lo, 0...] with pad rows past n_valid, bit for bit; the sqnorms
    are chosen so the bf16 lo column is live (sq ~ 1,200, bf16 spacing 8)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((301, 40)) + 3.0).astype(np.float32)
    jv, tv = _both(x, dtype)
    jsq = jdist.sqnorms(jv)
    n_valid = 290
    want = jgraph.augment_rows(jv, jsq, jnp.int32(n_valid), metric)
    got = tgraph.augment_rows(tv, to_torch(jsq), n_valid, metric)
    assert got.dtype == tv.dtype and tuple(got.shape) == (301, 128)
    np.testing.assert_array_equal(to_numpy(got), to_numpy(want))
    if metric == "sqeuclidean" and dtype == "bfloat16":
        assert (to_numpy(got)[:n_valid, 41] != 0).any()  # lo is live


@pytest.mark.parametrize("metric", METRICS)
def test_augmented_query_bit_equal(metric):
    q = np.random.default_rng(4).standard_normal((5, 40)).astype(np.float32)
    want = jgraph.augmented_query(jnp.asarray(q), metric, 128)
    got = tgraph.augmented_query(torch.from_numpy(q), metric, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_graph(seed, n, g, invalid=0.0):
    rng = np.random.default_rng(seed)
    graph = rng.integers(0, n, (n, g)).astype(np.int32)
    graph[rng.random((n, g)) < invalid] = -1
    return graph


@pytest.mark.parametrize("forward", [None, 1, 5, 12, 16])
@pytest.mark.parametrize("invalid", [0.0, 0.2])
def test_augment_reverse_edges_equal(forward, invalid):
    """Random intermediate graphs (with -1 destinations) and every split of
    the `forward` argument, including pure-forward."""
    graph = _random_graph(5, 500, 24, invalid)
    want = jgraph.augment_reverse_edges(jnp.asarray(graph), 16, forward)
    got = tgraph.augment_reverse_edges(torch.from_numpy(graph), 16, forward)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_reverse_edges_collisions_equal():
    """Seven sources pointing at node 0 in one rank pass, and the -1 case of
    the JAX package's own tests: every candidate lands as there."""
    fwd = np.tile(np.array([0, 1, 2, 3], np.int32), (8, 1))
    fwd[0] = [1, 2, 3, 4]
    bad = np.array([[1, -1, 2, 3], [-1, 0, 2, 3], [0, 1, -1, 3],
                    [0, 1, 2, -1]], np.int32)
    for graph in (fwd, bad):
        want = jgraph.augment_reverse_edges(jnp.asarray(graph), 4)
        got = tgraph.augment_reverse_edges(torch.from_numpy(graph), 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if graph is fwd:  # node 0's two reverse slots: distinct sources
            rev0 = got.numpy()[0, 2:].tolist()
            assert len(set(rev0)) == 2 and set(rev0) <= set(range(1, 8))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_knn_graph_equal_up_to_ties(dtype, metric):
    x = _corpus()[:1000]
    n_valid = 995  # the last five rows are pads
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    jv, tv = _both(x, dtype)
    jsq = jdist.sqnorms(jv)
    want = np.asarray(jgraph.build_knn_graph(
        jv, jsq, jnp.int32(n_valid), degree=12, metric=metric, tile_n=1000))
    got = tgraph.build_knn_graph(tv, to_torch(jsq), n_valid, degree=12,
                                 metric=metric, query_chunk=256).numpy()
    # pad rows are queries too (with real rows here), never neighbours
    assert got.max() < n_valid
    assert not (got == np.arange(1000)[:, None]).any()

    def scores(ids):
        v = to_numpy(jv).astype(np.float64)
        s = (v[:, None, :] * v[ids]).sum(-1)
        if metric == "sqeuclidean":
            s = 2 * s - (v[ids] ** 2).sum(-1)
        order = np.argsort(-s, axis=1, kind="stable")
        return np.take_along_axis(s, order, 1), np.take_along_axis(ids, order, 1)

    ks, ki = scores(got)
    ps, pi = scores(want)
    compare_topk(ks, ki, ps, pi, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    """A JAX-built IVF-Flat index per storage dtype, and the port's load of
    the same npz file."""
    x = _corpus()
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        jix = jivf.build(JIVFParams(n_lists=8, dtype=dtype), jnp.asarray(x))
        path = str(tmp_path_factory.mktemp("givf") / f"{dtype}.npz")
        jio.save_index(path, jix)
        out[dtype] = (jix, tio.load_index(path, device="cpu"))
    return x, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_list_medoids_equal(ivf_pair, dtype):
    _, ix = ivf_pair
    jix, tix = ix[dtype]
    np.testing.assert_array_equal(tgraph.list_medoids(tix).numpy(),
                                  np.asarray(jgraph.list_medoids(jix)))


def _overlap(a, b):
    """Mean share of each row's neighbours two graphs have in common."""
    return np.mean([len(np.intersect1d(r, s)) / a.shape[1]
                    for r, s in zip(a, b)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_knn_graph_ivf_overlaps_jax(ivf_pair, dtype):
    x, ix = ivf_pair
    jix, tix = ix[dtype]
    n_pad = x.shape[0]
    want = np.asarray(jgraph.build_knn_graph_ivf(
        jnp.asarray(x), jnp.int32(N), jix, degree=24, n_probes=3))
    got = tgraph.build_knn_graph_ivf(torch.from_numpy(x), N, tix, degree=24,
                                     n_probes=3).numpy()
    assert got.shape == want.shape == (n_pad, 24)
    rows = np.arange(n_pad)[:, None]
    assert not (got == rows).any()  # every row got 24 candidates
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    exact = np.argsort(d2, axis=1)[:, :24]
    jax_exact = _overlap(want, exact)
    assert jax_exact < 0.95
    assert _overlap(got, exact) >= jax_exact
    assert _overlap(got, want) >= jax_exact - 0.02


def test_linspace_rows_equal_jnp():
    """The evenly spaced entry rows are jnp.linspace's int32 rows exactly,
    including the sizes where fp32 rounding lands next to an integer."""
    for n_pad in list(range(1, 400, 7)) + [6_290_000, 1_048_576, 131_080]:
        for count in (1, 2, 3, 16, 32, 64, 100, 127, 128):
            want = np.asarray(jnp.linspace(0, n_pad - 1, count)
                              .astype(jnp.int32))
            got = tgraph.linspace_rows(n_pad, count, "cpu").numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{n_pad} {count}")


def test_earlier_copy_and_topk_first():
    """earlier_copy marks exactly what the O(m²) compare marks; topk_first
    takes ties lowest position first, as lax.top_k."""
    rng = np.random.default_rng(8)
    v = rng.integers(-1, 20, (6, 50)).astype(np.int32)
    eq = v[:, :, None] == v[:, None, :]
    earlier = np.tril(np.ones((50, 50), bool), -1)
    want = (eq & earlier).any(axis=2)
    np.testing.assert_array_equal(
        tgraph.earlier_copy(torch.from_numpy(v)).numpy(), want)
    s = rng.integers(0, 4, (6, 50)).astype(np.float32)
    s[s == 0] = -np.inf
    import jax

    js, ji = jax.lax.top_k(jnp.asarray(s), 20)
    ts, ti = tgraph.topk_first(torch.from_numpy(s), 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16, 1 << 30])
def test_bootstrap_steps_cover_each_list_once(budget):
    """The IVF bootstrap's steps: every non-empty list once, by falling
    size; windows that hold the step's largest list and candidate total,
    in whole 8-row units; the score tile within the budget unless a step
    holds one list alone."""
    g = np.random.default_rng(5)
    counts = g.integers(0, 300, 57)
    counts[[3, 9, 40]] = 0
    nbrs = np.concatenate([np.arange(57)[:, None],
                           g.integers(0, 57, (57, 3))], axis=1)
    steps = tgraph._bootstrap_steps(counts, nbrs, budget)
    lists = [i for s, _, _ in steps for i in s]
    assert lists == [int(i) for i in np.argsort(-counts, kind="stable")
                     if counts[i] > 0]
    totals = counts[nbrs].sum(axis=1)
    for s, own, cand in steps:
        assert own % 8 == 0 and cand % 8 == 0
        assert own >= counts[s].max() and cand >= totals[s].max()
        assert len(s) == 1 or len(s) * own * cand * 4 <= budget
    # a budget past the whole tile takes every list in one step
    assert (len(steps) == 1) == (budget == 1 << 30)


# ---------------------------------------------- the beam's candidate step ---


def _old_loop_body(aug, graph, aq, pick_ids, pick_s, ids):
    """The candidate step as beam_search wrote it inline before the step
    was factored out (and given a kernel on the card)."""
    from cuvs_rag_tpu_torch.ops import distance as dist_ops

    n_q, e = pick_ids.shape
    g = graph.shape[1]
    valid = pick_s > -dist_ops.DELETED_THRESHOLD
    nbrs = graph[pick_ids.clamp(min=0).long()].reshape(n_q, e * g)
    n_scores = tgraph._score_rows(aug, aq, nbrs).view(n_q, e, g) \
        .masked_fill(~valid[:, :, None], tgraph.NEG_INF).view(n_q, e * g)
    dup = (nbrs[:, :, None] == ids[:, None, :]).any(dim=2) \
        | tgraph.earlier_copy(nbrs)
    return nbrs, n_scores.masked_fill(dup, tgraph.NEG_INF)


def _step_case(case, seed=4):
    """Rows, graph, queries, parents, their scores and a beam for one of
    the step's masked cases."""
    g = torch.Generator().manual_seed(seed)
    n, d, deg, n_q, e, b = 300, 30, 8, 5, 4, 16
    x = torch.randn((n, d), generator=g)
    aug = tgraph.augment_rows(x, (x * x).sum(1), n - 20, "sqeuclidean")
    aq = tgraph.augmented_query(torch.randn((n_q, d), generator=g),
                                "sqeuclidean", aug.shape[1])
    graph = torch.randint(0, n, (n, deg), generator=g, dtype=torch.int32)
    picks = torch.randint(0, n - 20, (n_q, e), generator=g, dtype=torch.int32)
    pick_s = torch.randn((n_q, e), generator=g)
    ids = torch.randint(0, n, (n_q, b), generator=g, dtype=torch.int32)
    if case == "empty_and_tombstoned_parents":
        picks[:, 0] = -1  # an empty beam slot picked: it reads graph row 0
        pick_s[:, 0] = -float("inf")
        pick_s[:, 2] = -2e30  # a tombstoned row picked
        graph[0] = graph[picks[0, 1]]  # its news copy a live parent's
    elif case == "one_id_from_two_parents":
        graph[picks[:, 1].long(), :3] = graph[picks[:, 0].long(), 5:]
        graph[picks[:, 2].long(), 4] = graph[picks[:, 2].long(), 6]
    elif case == "ids_already_in_the_beam":
        news = graph[picks.long()].reshape(n_q, e * deg)
        ids[:, ::2] = news[:, 1:2 * (b // 2):2]
        ids[:, -1] = -1
    return aug, graph, aq, picks, pick_s, ids


@pytest.mark.parametrize("case", ["empty_and_tombstoned_parents",
                                  "one_id_from_two_parents",
                                  "ids_already_in_the_beam"])
def test_candidates_plain_equals_the_old_loop_body(case):
    """The factored candidate step gives the inline loop body's news ids
    and scores bit for bit, -inf where a parent is empty or tombstoned
    (those news still mask later copies), where an id repeats an earlier
    news' and where the beam holds it; the entry step (no graph, no beam)
    masks later copies alone."""
    aug, graph, aq, picks, pick_s, ids = _step_case(case)
    want = _old_loop_body(aug, graph, aq, picks, pick_s, ids)
    got = tgraph.candidates_plain(aug, aq, picks, graph=graph,
                                  src_scores=pick_s, beam=ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    masked = torch.isinf(want[1])
    assert 0 < int(masked.sum()) < masked.numel()
    if case == "empty_and_tombstoned_parents":
        # the empty parent's news are graph row 0, masked, and copied by
        # the live parent's news, which they mask in turn
        assert torch.equal(got[0][0, :8], graph[0])
        assert masked[:, :8].all() and masked[0, 8:16].all()
    entry = torch.cat([picks, picks[:, :2]], dim=1).clamp(min=0)
    s_entry = tgraph.candidates_plain(aug, aq, entry)[1]
    want_entry = tgraph._score_rows(aug, aq, entry).masked_fill(
        tgraph.earlier_copy(entry), tgraph.NEG_INF)
    assert torch.equal(s_entry, want_entry) and torch.isinf(
        s_entry[:, -2:]).all()


def _card_rows(dtype, width):
    """A stand-in for (64, width) contiguous rows on the card: the route
    reads their type and shape, never their data."""
    import types

    return types.SimpleNamespace(
        is_cuda=True, ndim=2, dtype=dtype, shape=(64, width),
        is_contiguous=lambda: True, device=torch.device("cuda", 0))


def test_candidate_route_is_the_plain_step_on_the_cpu():
    """The kernel takes CUDA rows alone: on CPU rows the route is the plain
    step, whatever the shapes, launches nothing and warns of nothing (the
    warning is the card's)."""
    import warnings

    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    aug, graph, aq, picks, pick_s, ids = _step_case("ids_already_in_the_beam")
    rows = torch.zeros((64, 896), dtype=torch.bfloat16)
    assert not gk.takes(rows, 1024, 128)
    assert gk.takes(_card_rows(rows.dtype, 896), 1024, 128)
    before = build.launches["cagra_candidates"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        route, step = tgraph.candidate_step(aug, aq, picks.shape[1],
                                            graph=graph, beam_width=16)
    assert route == "torch"
    got = step(picks, pick_s, ids)
    want = _old_loop_body(aug, graph, aq, picks, pick_s, ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert build.launches["cagra_candidates"] == before


@pytest.mark.parametrize("dtype,width,m,b,takes", [
    (torch.bfloat16, 896, 1024, 128, True),  # the CAGRA cell's step
    (torch.float32, 896, 1024, 64, True),
    (torch.bfloat16, 128, 128, 0, True),  # an entry step
    (torch.float32, 1152, 1024, 128, True),  # fp32 rows of 1,024 dims
    (torch.bfloat16, 4224, 8192, 4096, True),  # every limit at its edge
    (torch.float32, 1024, 1, 0, True),
    (torch.int8, 896, 1024, 128, False),  # storage the kernel does not read
    (torch.float16, 896, 1024, 128, False),
    (torch.bfloat16, 900, 1024, 128, False),  # width not a multiple of 8
    (torch.float32, 0, 1024, 128, False),
    (torch.bfloat16, 896, 8193, 128, False),  # news past shared memory
    (torch.bfloat16, 896, 1024, 4097, False),  # a beam past it
    (torch.bfloat16, 896, 0, 0, False),
])
def test_candidate_kernel_limits(dtype, width, m, b, takes):
    """Which storage types and shapes the kernel takes on the card (the
    rest run the plain step there too): every CAGRA storage (bf16, fp32)
    and augmented width (a multiple of 128) at any row length."""
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    assert gk.takes(_card_rows(dtype, width), m, b) is takes


def test_candidate_kernel_constants_match_its_source():
    """The wrapper's limits are the CUDA source's, which checks them again
    and refuses a launch past them."""
    import re

    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    src = (build.CSRC / "graph.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([\d *]+);", src).group(1)
        return int(np.prod([int(f) for f in expr.split("*")]))

    assert const("MAX_CANDIDATES") == gk.MAX_CANDIDATES
    assert const("MAX_BEAM") == gk.MAX_BEAM
    assert const("MAX_TABLE_BITS") == gk._TABLE_BITS[1]
    assert "bits < 6" in src and gk._TABLE_BITS[0] == 6
    # a block at every limit within the 227 KB an H100 block may have
    cap, beam = gk.MAX_CANDIDATES, gk.MAX_BEAM
    most = 4 * ((2 << gk._TABLE_BITS[1]) + beam + 2 * cap) + beam + cap
    assert most == 225_280 <= 227 * 1024


@pytest.mark.parametrize("n_q,m,b,sms,per_sm", [
    (100, 1024, 128, 132, 2), (1, 1024, 128, 132, 2), (16, 128, 0, 132, 3),
    (256, 2048, 1024, 132, 1), (3, 8, 0, 4, 8), (16, 8192, 4096, 132, 1)])
def test_candidate_kernel_plan(monkeypatch, n_q, m, b, sms, per_sm):
    """The launch plan: the blocks the card holds at once, no block with
    fewer than 32 news (but one), each block's share of the positions
    within its segment capacity, and a table of at least twice the ids."""
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    monkeypatch.setattr(gk, "_blocks_per_sm", lambda *args: per_sm)
    gk.plan.cache_clear()
    try:
        bits, live_cap, blocks = gk.plan(0, 0, 896, n_q, m, b, sms)
    finally:
        gk.plan.cache_clear()
    assert 1 <= blocks <= sms * per_sm
    assert blocks == 1 or n_q * m // blocks >= 32
    assert live_cap == min(m, -(-n_q * m // blocks))
    assert 6 <= bits <= 14 and (1 << bits) >= min(2 * (b + m), 1 << 14)


def _route_counts(monkeypatch, kernel):
    """A CAGRA search on the CPU with the recorder on: the counters it adds,
    and its answers, with the kernel's route stood in for by the plain
    step where `kernel`."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk
    from cuvs_rag_tpu_torch.utils import profiling
    from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    names = ("cagra.iterations", "cagra.expand.kernel", "cagra.expand.torch")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1024, 24), generator=g)
    ix = cagra.build(CagraParams(intermediate_graph_degree=16, graph_degree=8),
                     x)
    if kernel:
        monkeypatch.setattr(gk, "takes", lambda *args, **kwargs: True)
        monkeypatch.setattr(gk, "prepare", lambda rows, aq, cols, graph=None,
                            beam_width=0: lambda src, s=None, beam=None:
                            tgraph.candidates_plain(rows, aq, src, graph=graph,
                                                    src_scores=s, beam=beam))
    before = default_registry.snapshot()["counters"]
    profiling.record_spans(True)
    try:
        out = cagra.search(CagraSearchParams(itopk_size=32, search_width=4),
                           ix, x[:9] + 0.01, 5)
    finally:
        profiling.record_spans(False)
        profiling.clear()
    after = default_registry.snapshot()["counters"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}, out


def test_expand_counters_follow_the_route(monkeypatch):
    """cagra.expand.torch on the CPU, cagra.expand.kernel where the route
    takes the kernel, each queries x iterations, so equal to
    cagra.iterations; the two routes' answers agree."""
    torch_counts, want = _route_counts(monkeypatch, kernel=False)
    assert torch_counts == {"cagra.iterations": 9 * 16,
                            "cagra.expand.kernel": 0,
                            "cagra.expand.torch": 9 * 16}
    kernel_counts, got = _route_counts(monkeypatch, kernel=True)
    assert kernel_counts == {"cagra.iterations": 9 * 16,
                             "cagra.expand.kernel": 9 * 16,
                             "cagra.expand.torch": 0}
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
