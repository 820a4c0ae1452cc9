"""The CUDA kernels of cuvs_rag_tpu_torch against their plain versions, on
the card. CUDA kernels have no CPU mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_kernels_match_plain_versions(cuda_device):
    """K1 (3 dtypes x 2 metrics x k in {1, 10, 32}), K2 (bf16, int8 x int8)
    and K3 (3 dtypes, k = 600 and the few-planes certificate case) on a
    tile-aligned and a ragged corpus with tombstones: scores within rtol
    1e-5 / atol 1e-3, ids equal up to k-th-score ties."""
    import chip_smoke

    out = chip_smoke.parity_phase(50_000, 40_003, seed=0, device=cuda_device,
                                  k_large=600)
    assert out["cases"] == 68


def test_ivf_kernels_match_plain_versions(cuda_device):
    """K4 (k in {1, 10, 32}) and K5 (k = 600, and the few-planes
    certificate case) on fp32, bf16 and int8 IVF-Flat indexes of a
    clustered corpus with deletions, and on an index with empty and short
    lists, both metrics: scores within rtol 1e-5 / atol 1e-3, ids equal up
    to k-th-score ties, certificate flags equal to the plain K5's."""
    import chip_smoke

    out = chip_smoke.ivf_parity_phase(60_000, seed=0, device=cuda_device,
                                      k_large=600)
    assert out["cases"] == 40


def test_search_launches_each_kernel(cuda_device):
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.config import FlatParams, FlatSearchParams

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((flat._DENSE_THRESHOLD + 5, 64), generator=g,
                    device=cuda_device)
    ix = flat.build(FlatParams(dtype="bfloat16"), x)
    before = [fk.flat_topk_exact.launches, fk.flat_topk_sketch.launches,
              fk.flat_topk_large.launches]
    for k, sp in ((5, None), (5, FlatSearchParams(approx=True)), (100, None)):
        _, i = flat.search(sp, ix, x[:4], k)
        assert i[:, 0].tolist() == [0, 1, 2, 3]
    after = [fk.flat_topk_exact.launches, fk.flat_topk_sketch.launches,
             fk.flat_topk_large.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_ivf_search_launches_each_kernel(cuda_device):
    """IVF-Flat search runs K4 at k <= 32 and K5 above it."""
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((20_000, 64), generator=g, device=cuda_device)
    ix = ivf_flat.build(IVFFlatParams(n_lists=40, dtype="bfloat16"), x)
    before = [ik.ivf_scan.launches, ik.ivf_scan_large.launches]
    for k in (5, 100):
        _, i = ivf_flat.search(None, ix, x[:4], k)
        assert i[:, 0].tolist() == [0, 1, 2, 3]
    after = [ik.ivf_scan.launches, ik.ivf_scan_large.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1]
