"""Sharded and replicated search on the card: four mesh positions on one
GPU, each shard searched on its own CUDA stream. CUDA kernels have no CPU
mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest -q tests/test_torch_cuda_sharded.py

Tolerances: the streamed fan-out must give bit for bit what a serial loop
over the same shards gives on one stream (the same kernels on the same
inputs; the streams only change when they run), so results are held with
torch.equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ROWS, DIM, S = 1_200_000, 384, 4


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def corpus(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cent = torch.nn.functional.normalize(
        torch.randn(512, DIM, generator=g, device=cuda_device), dim=1)
    pick = torch.randint(0, 512, (ROWS,), generator=g, device=cuda_device)
    x = torch.nn.functional.normalize(
        cent[pick] + 0.05 * torch.randn(ROWS, DIM, generator=g,
                                        device=cuda_device), dim=1)
    q = torch.nn.functional.normalize(
        x[:16] + 0.02 * torch.randn(16, DIM, generator=g, device=cuda_device),
        dim=1)
    return x.to(torch.bfloat16), q


def _serial(sindex, queries, kk, scan):
    """The fan-out as a plain loop on the current stream."""
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    scores, ids = [], []
    for i, ix in enumerate(sindex.local):
        s, lidx = scan(ix, queries)[:2]
        scores.append(s)
        ids.append(torch.where(lidx >= 0,
                               lidx.to(torch.int32) + int(sindex.offsets[i]),
                               torch.full_like(lidx, -1, dtype=torch.int32)))
    return topk_ops.merge_topk(torch.cat(scores, 1), torch.cat(ids, 1), kk)


@pytest.mark.parametrize("family,k", [("flat", 10), ("flat", 2000),
                                      ("ivf_flat", 10), ("ivf_flat", 2000)])
def test_streamed_fan_out_equals_a_serial_loop(cuda_device, corpus, family,
                                               k):
    """flat K1 (k = 10) and K3 (k = 2,000), IVF-Flat K4 and K5: each shard
    launches its kernel once on its own stream, and the merge equals a
    serial loop over the shards, bit for bit."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.parallel import search as ps
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.utils import config

    x, q = corpus
    dmesh = DeviceMesh([cuda_device] * S)
    if family == "flat":
        params, sp = config.FlatParams(dtype="bfloat16"), None
        kern = fk.flat_topk_exact if k <= fk.MAX_KERNEL_K else \
            fk.flat_topk_large
    else:
        params = config.IVFFlatParams(dtype="bfloat16")
        sp = config.IVFFlatSearchParams(n_probes=5)
        kern = ik.ivf_scan if k <= ik.MAX_KERNEL_K else ik.ivf_scan_large
    six = ps.build_sharded(family, params, x, dmesh)
    large = ps._sharded_large_route(six, k, sp)
    if k > 32:
        assert large is not None

        def scan(ix, qq):
            return large(sp, ix, qq, k)
    else:
        def scan(ix, qq):
            return ps.FAMILIES[family].search_scores(sp, ix, qq, k)
    kern.launches = 0
    got_s, got_i, cert = ps._fan_out_search(dmesh, six, q, k, scan)
    assert kern.launches == S
    assert bool(cert.all())
    torch.cuda.synchronize()
    want_s, want_i = _serial(six, q, k, scan)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s, want_s)


def test_replicas_on_one_card_share_storage(cuda_device, corpus):
    """Four replicas on one card are one copy: every replica's tensors are
    the same memory, and so are a filtered view's."""
    from cuvs_rag_tpu_torch.parallel import search as ps
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.utils import config

    x, q = corpus
    dmesh = DeviceMesh([cuda_device] * S)
    before = torch.cuda.memory_allocated(cuda_device)
    rix = ps.build_replicated("flat", config.FlatParams(dtype="bfloat16"), x,
                              dmesh)
    grown = torch.cuda.memory_allocated(cuda_device) - before
    one = rix.index.vectors.numel() * rix.index.vectors.element_size()
    assert grown < 2 * one  # one index, not four
    ptrs = {r.vectors.data_ptr() for r in rix.replicas}
    assert len(ptrs) == 1 and len({r.sqnorms.data_ptr()
                                   for r in rix.replicas}) == 1
    view = ps.filtered_view_replicated(rix, np.arange(ROWS) % 2 == 0)
    assert {r.vectors.data_ptr() for r in view.replicas} == ptrs
    assert len({r.sqnorms.data_ptr() for r in view.replicas}) == 1
    # each position searches its 4 of the 16 queries on its own stream:
    # bit for bit what the same 4-query searches give one after another
    # (one 16-query search differs from four 4-query ones in the last
    # bits of its distances)
    from cuvs_rag_tpu_torch.index import flat

    d, i = ps.search_replicated(None, rix, q, 10, dmesh)
    parts = [flat.search(None, rix.index, q[p:p + 4], 10)
             for p in range(0, 16, 4)]
    assert torch.equal(i, torch.cat([x[1] for x in parts]))
    assert torch.equal(d, torch.cat([x[0] for x in parts]))
    d1, i1 = flat.search(None, rix.index, q, 10)
    assert torch.equal(i, i1)
    torch.testing.assert_close(d, d1, rtol=1e-5, atol=1e-3)


def test_the_default_mesh_is_every_visible_card(cuda_device):
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    mesh = DeviceMesh()
    assert mesh.devices == [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
    assert all(d.type == "cuda" for d in mesh.devices)
    assert DeviceMesh(["cuda"] * 2).devices == [cuda_device] * 2
    info = mesh.device_infos()[0]
    assert info.platform == "gpu" and info.memory_free_bytes > 0
    assert mesh.stream(0) is not None and mesh.stream(0) is mesh.stream(0)


def test_fan_out_over_every_visible_card(cuda_device, corpus):
    """A mesh of distinct cards (DeviceMesh(), where the machine has more
    than one): each shard on its own card and stream, the candidates copied
    to the first card and merged there; the same answers as one index on
    the first card (ids up to ties at the k-th, scores within rtol 1e-5 /
    atol 1e-3) at k = 10 (K1) and k = 2,000 (K3), and through a view."""
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.parallel import search as ps
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.utils import config
    from cuvs_rag_tpu_torch.utils.compare import compare_topk

    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one GPU")
    x, q = corpus
    dmesh = DeviceMesh()
    params = config.FlatParams(dtype="bfloat16")
    six = ps.build_sharded("flat", params, x, dmesh)
    assert [ix.device for ix in six.local] == dmesh.devices
    single = flat.build(params, x)
    allow = torch.arange(ROWS) % 3 != 0
    for k, kw in ((10, {}), (2000, {}), (10, {"allow": allow.numpy()})):
        d, i = ps.search_sharded(None, six, q, k, dmesh, **kw)
        assert d.device == dmesh.first
        ref = single if not kw else flat.build(params, x[allow])
        d1, i1 = flat.search(None, ref, q, k)
        if kw:  # the view's ids are global; the filtered index's local
            i1 = torch.where(i1 >= 0, torch.nonzero(allow)[:, 0].to(
                i1.device)[i1.clamp(min=0).long()].to(torch.int32), i1)
        compare_topk(-d, i, -d1, i1, rtol=1e-5, atol=1e-3)
