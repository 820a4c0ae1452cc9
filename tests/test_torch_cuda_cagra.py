"""The CAGRA path on the card against the same path on the CPU. The path has
no hand kernel; what the card can change is the order of ties (torch.sort
and scatters on CUDA) and of fp32 sums, so these hold the port's explicit
tie rules there: the beam's stable selections, the reverse edges' stable
sort and extend's explicit last writer. Without a GPU these skip.

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
