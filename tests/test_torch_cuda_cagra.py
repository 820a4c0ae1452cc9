"""The CAGRA path on the card against the same path on the CPU, and the
beam's candidate and merge kernels (ops/graph_kernels, csrc/graph.cu)
against their plain steps. What the card can change is the order of ties (torch.sort and
scatters on CUDA) and of fp32 sums, so these hold the port's explicit tie
rules there: the beam's stable selections, the reverse edges' stable sort
and extend's explicit last writer. The candidate kernel gives the plain
step's ids and -inf masks bit for bit; its other scores are fp32 sums in
its own order, held within 1e-6 of the sum of |products| against a float64
dot of the same values (a lane's sum of its FMAs and five shuffles), at the
CAGRA cell's shapes, at rows past 4,096 bytes and at the id limits; past
those, the plain step runs on the card with one warning. A
whole beam by the kernel's route equals the torch route's on at least 99%
of positions: the two routes' scores differ in the last bits, which moves
near-ties. The merge kernel moves values and computes none, so its
outputs equal merge_plain's bit for bit (ties across beam and news, -inf
runs, tombstones, every slot expanded, few live news, news in pieces, the
widest beam it holds), and a whole search by its route returns the plain
merge route's ids and scores exactly; a wider beam on the card raises.
Without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda_cagra.py

Tolerances: ids equal position by position where the test says so (the
tie cases, the deterministic build steps); elsewhere distances rtol 1e-5 /
atol 1e-4 and ids up to ties at the k-th (utils/compare.py), since the
card sums fp32 products in another order.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from cuvs_rag_tpu_torch.kernels import build  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these hold the card's tie order")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(index, device):
    from cuvs_rag_tpu_torch.index import cagra

    return dataclasses.replace(index, **{
        f: getattr(index, f).to(device) for f in cagra.CagraIndex._tensor_fields})


def _corpus(n=20_000, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    cent = torch.nn.functional.normalize(torch.randn(40, d, generator=g), dim=1)
    x = cent[torch.randint(0, 40, (n,), generator=g)] \
        + 0.05 * torch.randn(n, d, generator=g)
    q = x[:64] + 0.02 * torch.randn(64, d, generator=g)
    return torch.nn.functional.normalize(x, dim=1), q


@pytest.mark.parametrize("algo", ["exact", "ivf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_on_card_matches_cpu(cuda_device, algo, dtype):
    """A CPU-built index copied to the card searches as on the CPU, at the
    default and at a narrow beam, with two rows in three deleted."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams

    x, q = _corpus()
    ix = cagra.build(CagraParams(graph_degree=32, intermediate_graph_degree=64,
                                 dtype=dtype, build_algo=algo), x,
                     device="cpu")
    for index in (ix, cagra.delete(ix, torch.nonzero(
            torch.arange(ix.n_valid) % 3 != 0).flatten())):
        dev = _to(index, cuda_device)
        for sp in (CagraSearchParams(), CagraSearchParams(
                itopk_size=32, num_entry_points=4, search_width=2,
                max_iterations=4)):
            d, i = cagra.search(sp, index, q, 10)
            cd, ci = cagra.search(sp, dev, q.to(cuda_device), 10)
            compare_topk(-cd, ci, -d, i, **TOL)


def test_masked_news_tie_on_card(cuda_device):
    """The hand-built tie case of tests/test_torch_cagra.py: the masked
    neighbours of a tombstoned pick never take the beam's empty slots, so
    row 3 is found; ids equal to the CPU's position by position."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.ops import distance as dist_ops
    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.utils.config import CagraSearchParams

    x = torch.zeros(16, 2)
    x[:7, 0] = torch.tensor([2.0, 1.0, 1.5, 0.1, 3.0, 2.5, 2.7])
    x[7:, 0] = 5.0 + torch.arange(9.0)
    graph = torch.arange(16, dtype=torch.int32)[:, None].repeat(1, 2)
    graph[0], graph[15] = torch.tensor([1, 2]), torch.tensor([3, 4])
    graph[1], graph[2] = torch.tensor([3, 5]), torch.tensor([5, 6])
    sq = dist_ops.sqnorms(x)
    ix = cagra.CagraIndex(
        vectors=graph_ops.augment_rows(x, sq, 16, "sqeuclidean"), sqnorms=sq,
        graph=graph, entry_centroids=torch.zeros(0, 2),
        entry_rows=torch.zeros(0, dtype=torch.int32), n_valid=16,
        metric="sqeuclidean", data_dim=2)
    ix = cagra.delete(ix, torch.arange(7, 16))
    sp = CagraSearchParams(itopk_size=8, num_entry_points=2, search_width=2,
                           max_iterations=3)
    q = torch.zeros(1, 2)
    _, i = cagra.search(sp, ix, q, 8)
    _, ci = cagra.search(sp, _to(ix, cuda_device), q.to(cuda_device), 8)
    assert torch.equal(ci.cpu(), i) and int(i[0, 0]) == 3


def test_deterministic_steps_on_card(cuda_device):
    """augment_reverse_edges (a stable sort of 2.6M candidates, with -1
    destinations) and extend's reverse-edge patch (40 new rows colliding on
    their neighbours' slots, the last writer explicit) give the CPU's
    result exactly; the beam's helpers keep ties lowest position first."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.utils.config import CagraParams

    g = torch.Generator().manual_seed(3)
    graph = torch.randint(0, 80_000, (80_000, 48), generator=g,
                          dtype=torch.int32)
    graph[torch.rand(80_000, 48, generator=g) < 0.1] = -1
    for fwd in (None, 20):
        want = graph_ops.augment_reverse_edges(graph, 32, fwd)
        got = graph_ops.augment_reverse_edges(graph.to(cuda_device), 32, fwd)
        assert torch.equal(got.cpu(), want)

    s = torch.randint(0, 3, (64, 500), generator=g).float()
    s[s == 0] = -float("inf")
    want = graph_ops.topk_first(s, 100)
    got = graph_ops.topk_first(s.to(cuda_device), 100)
    assert torch.equal(got[1].cpu(), want[1])
    v = torch.randint(-1, 30, (64, 500), generator=g, dtype=torch.int32)
    assert torch.equal(graph_ops.earlier_copy(v.to(cuda_device)).cpu(),
                       graph_ops.earlier_copy(v))

    x, _ = _corpus(n=5_000)
    ix = cagra.build(CagraParams(graph_degree=16, intermediate_graph_degree=32),
                     x, device="cpu")
    new = x[torch.arange(10).repeat_interleave(4)] \
        + 0.01 * torch.randn(40, x.shape[1], generator=g)
    want = cagra.extend(ix, new)
    got = cagra.extend(_to(ix, cuda_device), new.to(cuda_device))
    assert torch.equal(got.graph.cpu(), want.graph)


def test_build_on_card_recall(cuda_device):
    """The IVF-bootstrapped build on the card: every row gets candidates,
    and recall@10 against the exact oracle is within 0.02 of the CPU
    build's (the bootstrap's k-means draws differ between the devices)."""
    from cuvs_rag_tpu_torch.index import cagra, flat
    from cuvs_rag_tpu_torch.eval.recall import recall_at_k
    from cuvs_rag_tpu_torch.utils.config import CagraParams, FlatParams

    x, q = _corpus(n=60_000, d=128)
    params = CagraParams(graph_degree=32, intermediate_graph_degree=64,
                         dtype="bfloat16", build_algo="ivf")
    _, want = flat.search(None, flat.build(FlatParams(), x, device="cpu"), q, 10)
    recalls = []
    for device in ("cpu", cuda_device):
        ix = cagra.build(params, x.to(device))
        rows = torch.arange(ix.n_valid, device=ix.device)[:, None]
        assert not (ix.graph[:ix.n_valid, :16] == rows).all(dim=1).any()
        _, got = cagra.search(None, ix, q.to(device), 10)
        recalls.append(recall_at_k(got.cpu().numpy(), want.numpy(), 10))
    assert recalls[1] >= recalls[0] - 0.02 and recalls[1] >= 0.9, recalls


def _step_inputs(device, dtype, width, m, *, n=20_000, g=64, n_q=100, b=128,
                 seed=0):
    """A candidate step's inputs with every masked case in it: a quarter of
    each graph row drawn from 300 ids (the same id from two parents, and
    twice from one), parents of id -1 (scored -inf, as the beam's empty
    slots are) and tombstoned ones (~-2e30), half the beam taken from the
    step's own news and a few empty (-1) beam slots; the parents' scores a
    strided view, as the beam's sorted slice is."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e = m // g
    rows = torch.randn((n, width), generator=gen, device=device).to(dtype)
    graph = torch.randint(0, n, (n, g), generator=gen, device=device,
                          dtype=torch.int32)
    graph[:, : g // 4] = torch.randint(0, 300, (n, g // 4), generator=gen,
                                       device=device, dtype=torch.int32)
    aq = torch.randn((n_q, width), generator=gen, device=device)
    parents = torch.randint(0, n, (n_q, e), generator=gen, device=device,
                            dtype=torch.int32)
    both = torch.randn((n_q, 2 * e), generator=gen, device=device)
    parents[::4, -1] = -1
    both[::4, e - 1] = -float("inf")
    both[1::3, 0] = -2e30
    parent_s = both[:, :e]
    news = graph[parents.clamp(min=0).long()].reshape(n_q, m)
    beam = torch.randint(0, n, (n_q, b), generator=gen, device=device,
                         dtype=torch.int32)
    take = torch.randint(0, m, (n_q, b // 2), generator=gen, device=device)
    beam[:, : b // 2] = torch.gather(news, 1, take)
    beam[:, -3:] = -1
    return rows, graph, aq, parents, parent_s, beam


def _hold_step(got, want, rows, aq):
    """The kernel's (ids, scores) against the plain step's: ids and -inf
    masks equal, scores within 1e-6 of the float64 dot's scale; -> the
    masked count."""
    nbrs, scores = got
    assert torch.equal(nbrs, want[0])
    masked = torch.isinf(want[1])
    assert torch.equal(torch.isinf(scores), masked)
    assert (scores[masked] < 0).all()
    prods = rows[nbrs.long()].double() * aq[:, None, :].double()
    exact, scale = prods.sum(-1), prods.abs().sum(-1)
    err = (scores.double() - exact).abs()[~masked]
    assert (err <= 1e-6 * scale[~masked]).all(), float(
        (err / scale[~masked]).max())
    return int(masked.sum())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("width", [512, 896])
def test_candidate_kernel_matches_plain_step(cuda_device, width, m, dtype):
    """The kernel's iteration step against candidates_plain on the card:
    ids and -inf masks equal, scores within 1e-6 of the float64 dot's
    scale; one launch a step; then the entry step (given ids, one row of
    them repeated by a stride-0 view, and rows with copies) the same way."""
    _hold_kernel_step(cuda_device, dtype, width, m, 128)


def _hold_kernel_step(device, dtype, width, m, b):
    """The kernel's route of one iteration's step and of two entry steps
    against candidates_plain on the same card tensors (_hold_step)."""
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    rows, graph, aq, parents, parent_s, beam = _step_inputs(
        device, dtype, width, m, b=b)
    route, step = graph_ops.candidate_step(rows, aq, parents.shape[1],
                                           graph=graph, beam_width=b)
    assert route == "kernel"
    before = build.launches["cagra_candidates"]
    got = step(parents, parent_s, beam)
    torch.cuda.synchronize()
    assert build.launches["cagra_candidates"] == before + 1
    want = graph_ops.candidates_plain(rows, aq, parents, graph=graph,
                                      src_scores=parent_s, beam=beam)
    masked = _hold_step(got, want, rows, aq)
    # every kind of mask is present, and most news are scored
    assert 0.1 * got[0].numel() < masked < 0.6 * got[0].numel()

    entry = graph[:128].reshape(-1)[:128]
    for ids in (entry[None].expand(aq.shape[0], -1),
                graph[: aq.shape[0], :48].repeat(1, 2).contiguous()):
        route, step = graph_ops.candidate_step(rows, aq, ids.shape[1])
        assert route == "kernel"
        got = step(ids)
        want = graph_ops.candidates_plain(rows, aq, ids)
        assert _hold_step(got, want, rows, aq) > 0 or ids.stride(0) == 0


@pytest.mark.parametrize("dtype,width,m,b", [
    (torch.float32, 1152, 1024, 128),  # fp32 rows of a 1,024-dim encoder
    (torch.bfloat16, 2176, 1024, 128),  # bf16 rows past 4,096 bytes
    (torch.float32, 4224, 256, 64),  # fp32 rows of 4,096 dims
    (torch.bfloat16, 896, 4096, 1024),  # search_width 64, itopk 1,024
    (torch.float32, 512, 8192, 4096),  # every id limit at its edge
])
def test_candidate_kernel_long_rows_and_wide_steps(cuda_device, dtype, width,
                                                   m, b):
    """Rows past 4,096 bytes (scored in pieces) and steps up to the shared
    memory's limits take the kernel too, held as the cell's shapes are."""
    _hold_kernel_step(cuda_device, dtype, width, m, b)


def test_candidate_step_past_the_kernel_warns_once(cuda_device, monkeypatch):
    """A step of more news than the kernel holds runs the plain step on the
    card, with one warning in a process; the beam's answers are that
    step's."""
    import warnings

    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    monkeypatch.setattr(graph_ops.candidate_step, "warned", False)
    rows, graph, aq, parents, parent_s, beam = _step_inputs(
        cuda_device, torch.bfloat16, 512, gk.MAX_CANDIDATES + 64, n_q=8)
    with pytest.warns(RuntimeWarning, match="runs as PyTorch ops"):
        route, step = graph_ops.candidate_step(
            rows, aq, parents.shape[1], graph=graph, beam_width=128)
    assert route == "torch"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert graph_ops.candidate_step(rows, aq, parents.shape[1],
                                        graph=graph, beam_width=128)[0] \
            == "torch"
    got = step(parents, parent_s, beam)
    want = graph_ops.candidates_plain(rows, aq, parents, graph=graph,
                                      src_scores=parent_s, beam=beam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prepared_launch_checks_its_first_call(cuda_device):
    """A prepared launch refuses arguments of another type, shape or device
    on its first call (the kernel would read past them) and launches
    nothing then; a good first call is checked once."""
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    rows, graph, aq, parents, parent_s, beam = _step_inputs(
        cuda_device, torch.bfloat16, 512, 256, n_q=8)
    before = build.launches["cagra_candidates"]
    for bad in ((parents.long(), parent_s, beam),
                (parents[:, :2], parent_s, beam),
                (parents.cpu(), parent_s, beam),
                (parents, parent_s.double(), beam),
                (parents, parent_s, beam[:, :64]),
                (parents, parent_s, None)):
        step = graph_ops.candidate_step(rows, aq, parents.shape[1],
                                        graph=graph, beam_width=128)[1]
        with pytest.raises(ValueError):
            step(*bad)
    assert build.launches["cagra_candidates"] == before
    step = graph_ops.candidate_step(rows, aq, parents.shape[1], graph=graph,
                                    beam_width=128)[1]
    for _ in range(2):
        got = step(parents, parent_s, beam)
    want = graph_ops.candidates_plain(rows, aq, parents, graph=graph,
                                      src_scores=parent_s, beam=beam)
    _hold_step(got, want, rows, aq)
    assert build.launches["cagra_candidates"] == before + 2


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("float32", 1024)])
def test_beam_by_kernel_matches_torch_route(cuda_device, monkeypatch, dtype,
                                            d):
    """A whole beam (k = itopk: every slot) on the 20,000-row corpus with
    two rows in three deleted, at 64 dims and at 1,024 (fp32 rows of the
    port's encoder: 4,608 bytes augmented, scored in pieces): the kernel's
    route launches once an iteration and once for the entry rows, counts
    queries x iterations in cagra.expand.kernel (equal to cagra.iterations)
    while the recorder is on, and its ids equal the torch route's on at
    least 99% of positions."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk
    from cuvs_rag_tpu_torch.utils import profiling
    from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    def counters():
        c = default_registry.snapshot()["counters"]
        return [c.get(k, 0) for k in ("cagra.iterations",
                                      "cagra.expand.kernel",
                                      "cagra.expand.torch")]

    x, q = _corpus(d=d)
    ix = cagra.build(CagraParams(graph_degree=32, intermediate_graph_degree=64,
                                 dtype=dtype), x, device="cpu")
    sp = CagraSearchParams()
    _, _, iters = graph_ops.beam_plan(sp.itopk_size, sp.itopk_size,
                                      sp.search_width, sp.max_iterations)
    for index in (ix, cagra.delete(ix, torch.nonzero(
            torch.arange(ix.n_valid) % 3 != 0).flatten())):
        dev = _to(index, cuda_device)
        before, counted = build.launches["cagra_candidates"], counters()
        profiling.record_spans(True)
        try:
            _, got = cagra.search(sp, dev, q.to(cuda_device), sp.itopk_size)
        finally:
            profiling.record_spans(False)
            profiling.clear()
        assert build.launches["cagra_candidates"] == before + iters + 1
        n = iters * q.shape[0]
        assert [a - b for a, b in zip(counters(), counted)] == [n, n, 0]
        with monkeypatch.context() as patch:
            patch.setattr(gk, "takes", lambda *args, **kwargs: False)
            patch.setattr(graph_ops.candidate_step, "warned", True)
            _, want = cagra.search(sp, dev, q.to(cuda_device), sp.itopk_size)
        assert build.launches["cagra_candidates"] == before + iters + 1
        assert (got == want).float().mean() >= 0.99


# ------------------------------------------------------- the merge kernel ---

# scores drawn from few values, so that beam and news tie across each other
_TIED = (3.0, 1.5, 1.5, 0.0, -1.0, -2e30, -float("inf"))
MERGE_CASES = ("many_ties", "runs_of_minus_inf", "tombstones",
               "every_slot_expanded", "fewer_live_news_than_b", "random")


def _merge_inputs(device, case, n_q, b, m, seed=0):
    """A merge step's inputs on `device`: the beam (scores sorted
    descending with ties by position, ids, flags) and the news (scores,
    ids), built for one case."""
    g = torch.Generator(device=device).manual_seed(seed)
    tied = torch.tensor(_TIED, device=device)

    def draw(cols):
        if case in ("many_ties", "every_slot_expanded"):
            return tied[torch.randint(0, len(_TIED), (n_q, cols), generator=g,
                                      device=device)]
        s = torch.randn((n_q, cols), generator=g, device=device)
        if case == "runs_of_minus_inf":
            s[:, cols // 3:] = -float("inf")
            s[::2, : cols // 5] = -float("inf")
        if case == "tombstones":
            s[torch.rand((n_q, cols), generator=g, device=device) < 0.4] = -2e30
        if case == "fewer_live_news_than_b":
            s[:, min(cols, max(1, b // 4)):] = -float("inf")
        return s

    scores = torch.sort(draw(b), dim=1, descending=True, stable=True)[0]
    ids = torch.randint(-1, 4 * (b + m), (n_q, b), generator=g, device=device,
                        dtype=torch.int32)
    expanded = torch.rand((n_q, b), generator=g, device=device) < 0.4
    n_scores = draw(m)
    if case == "every_slot_expanded":
        expanded[:] = True
        n_scores[:, : m // 2] = -float("inf")
    nbrs = torch.randint(-1, 4 * (b + m), (n_q, m), generator=g,
                         device=device, dtype=torch.int32)
    return (scores, ids, expanded), n_scores, nbrs


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _hold_merge(got, want):
    """Every output of the kernel equal to the plain step's, bit for bit."""
    names = ("scores", "ids", "expanded", "pick_s", "pick_ids")
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(_bits(a), _bits(w)), name


def _built_beam(merge, beam):
    """merge.beam filled with a built beam: the kernel's launches read and
    rewrite that one beam in place."""
    for own, built in zip(merge.beam, beam):
        own.copy_(built)
    return merge.beam


@pytest.mark.parametrize("case", MERGE_CASES)
@pytest.mark.parametrize("n_q,b,m,e", [
    (100, 128, 1024, 16),  # the CAGRA cell's step
    (7, 16, 9, 16),  # every slot picked; fewer news than slots
    (3, 4096, 8192, 64),  # the candidate kernel's limits: one piece
    (3, 4096, 20_000, 64),  # news in three pieces
    (2, 16384, 40_000, 16),  # the widest beam: pieces of 2,048 news
    (5, 33, 0, 5),  # no news
])
def test_merge_kernel_matches_plain_step(cuda_device, case, n_q, b, m, e):
    """The merge kernel against merge_plain on the same card tensors, bit
    for bit: the new beam's scores, ids and flags, the picks' scores and
    ids. One library call a step (a launch a piece of news); an
    iteration's step reads the beam that the entry step wrote in place,
    and the entry beam (no beam, the news as its rows: in pieces, the
    beam part filled between them) is held the same way."""
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    beam, n_scores, nbrs = _merge_inputs(cuda_device, case, n_q, b, m)
    route, merge = graph_ops.merge_step(n_scores, n_q, b, e)
    assert route == "kernel"
    before = build.launches["cagra_merge"]
    want = graph_ops.merge_plain(n_scores, nbrs, beam, b=b, e=e)
    _hold_merge(merge(n_scores, nbrs, _built_beam(merge, beam)), want)
    if m:
        entry = merge(n_scores, nbrs)
        _hold_merge(entry, graph_ops.merge_plain(n_scores, nbrs, b=b, e=e))
        # the next step reads the entry's beam and rewrites it
        want = graph_ops.merge_plain(n_scores, nbrs, tuple(
            t.clone() for t in entry[:3]), b=b, e=e)
        again = merge(n_scores, nbrs, merge.beam)
        assert again[0].data_ptr() == entry[0].data_ptr()
        _hold_merge(again, want)
    torch.cuda.synchronize()
    assert build.launches["cagra_merge"] == before + (3 if m else 1)


def test_merge_kernel_takes_strided_entry_ids(cuda_device):
    """The entry step's ids may be one row repeated (a stride-0 view, the
    evenly spaced entry rows): the kernel reads them by their row stride."""
    from cuvs_rag_tpu_torch.ops import graph as graph_ops

    _, n_scores, nbrs = _merge_inputs(cuda_device, "many_ties", 12, 64, 100)
    ids = nbrs[:1].expand(12, -1)
    merge = graph_ops.merge_step(n_scores, 12, 64, 8)[1]
    _hold_merge(merge(n_scores, ids),
                graph_ops.merge_plain(n_scores, ids, b=64, e=8))


def test_prepared_merge_checks_its_first_call(cuda_device):
    """A prepared merge refuses news of another type, shape or device, and
    any beam but its own (`launch.beam`, rewritten in place), on the first
    call of each kind, and launches nothing then."""
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    beam, n_scores, nbrs = _merge_inputs(cuda_device, "random", 8, 64, 256)
    before = build.launches["cagra_merge"]
    for bad in ((n_scores.double(), nbrs, beam), (n_scores, nbrs.long(), beam),
                (n_scores.cpu(), nbrs.cpu(), beam),
                (n_scores, nbrs[:, :100], beam),
                (n_scores, nbrs, (beam[0], beam[1], beam[2].int())),
                (n_scores, nbrs, (beam[0][:, :32], beam[1], beam[2])),
                (n_scores, nbrs, beam)):
        with pytest.raises(ValueError):
            gk.prepare_merge(cuda_device, 8, 64, 8)(*bad)
    assert build.launches["cagra_merge"] == before
    with pytest.raises(ValueError):
        gk.prepare_merge(cuda_device, 8, 64, 65)


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("bfloat16", 1024)])
def test_beam_by_merge_kernel_equals_plain_merge_route(cuda_device,
                                                       monkeypatch, dtype, d):
    """A whole search on the 20,000-row corpus, with and without two rows
    in three deleted, both with the candidate kernel: by the merge kernel's
    route it returns the plain merge route's ids and scores exactly; it
    launches the merge kernel once an iteration and once for the entry
    beam, and counts queries x iterations in cagra.merge.kernel (equal to
    cagra.iterations) while the recorder is on."""
    from cuvs_rag_tpu_torch.index import cagra
    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk
    from cuvs_rag_tpu_torch.utils import profiling
    from cuvs_rag_tpu_torch.utils.config import CagraParams, CagraSearchParams
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    def counters():
        c = default_registry.snapshot()["counters"]
        return [c.get(k, 0) for k in ("cagra.iterations", "cagra.merge.kernel",
                                      "cagra.merge.torch")]

    def plain_merge_step(rows, n_q, b, e):
        return "torch", lambda n_scores, nbrs, beam=None: (
            graph_ops.merge_plain(n_scores, nbrs, beam, b=b, e=e))

    x, q = _corpus(d=d)
    ix = cagra.build(CagraParams(graph_degree=32, intermediate_graph_degree=64,
                                 dtype=dtype), x, device="cpu")
    for sp in (CagraSearchParams(), CagraSearchParams(itopk_size=128,
                                                      search_width=16)):
        _, _, iters = graph_ops.beam_plan(sp.itopk_size, 10, sp.search_width,
                                          sp.max_iterations)
        for index in (ix, cagra.delete(ix, torch.nonzero(
                torch.arange(ix.n_valid) % 3 != 0).flatten())):
            dev = _to(index, cuda_device)
            before, counted = build.launches["cagra_merge"], counters()
            cand = build.launches["cagra_candidates"]
            profiling.record_spans(True)
            try:
                got = cagra.search(sp, dev, q.to(cuda_device), 10)
            finally:
                profiling.record_spans(False)
                profiling.clear()
            assert build.launches["cagra_merge"] == before + iters + 1
            assert build.launches["cagra_candidates"] == cand + iters + 1
            n = iters * q.shape[0]
            assert [a - b for a, b in zip(counters(), counted)] == [n, n, 0]
            with monkeypatch.context() as patch:
                patch.setattr(graph_ops, "merge_step", plain_merge_step)
                want = cagra.search(sp, dev, q.to(cuda_device), 10)
            assert build.launches["cagra_merge"] == before + iters + 1
            assert build.launches["cagra_candidates"] == cand + 2 * iters + 2
            assert torch.equal(got[1], want[1])
            assert torch.equal(_bits(got[0]), _bits(want[0]))


def test_merge_step_past_the_kernel_raises(cuda_device):
    """A beam wider than the merge kernel holds is refused on the card,
    and so is a search with such a beam: the plain step runs on CPU
    tensors only. Nothing is launched."""
    from cuvs_rag_tpu_torch.ops import graph as graph_ops
    from cuvs_rag_tpu_torch.ops import graph_kernels as gk

    wide = gk.MERGE_MAX_BEAM + 8
    _, n_scores, _ = _merge_inputs(cuda_device, "random", 2, 16, 64)
    before = build.launches["cagra_merge"]
    with pytest.raises(ValueError, match=str(gk.MERGE_MAX_BEAM)):
        graph_ops.merge_step(n_scores, 2, wide, 4)
    rows = torch.zeros((64, 64), dtype=torch.float32, device=cuda_device)
    graph = torch.zeros((64, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=str(gk.MERGE_MAX_BEAM)):
        graph_ops.beam_search(rows, graph, torch.zeros(
            (2, 62), device=cuda_device), k=10, itopk=wide,
            metric=graph_ops.Metric.SQEUCLIDEAN)
    assert build.launches["cagra_merge"] == before
