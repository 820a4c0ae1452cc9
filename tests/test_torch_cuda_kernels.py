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


@pytest.mark.parametrize("mb,window,cap", [(48, 1280, 9000), (5, 333, 1001),
                                           (400, 130, 700)])
@pytest.mark.parametrize("use_corr", [True, False])
def test_pq_adc_kernel_matches_plain(cuda_device, mb, window, cap, use_corr):
    """K6 on random packed codes and tables: any mb (400 streams need more
    than 48 KB of shared memory), a window and a cap that no tile divides,
    empty, full and straddling lists, windows that run past the layout's
    end, and tombstoned slots. Ids and the -inf pattern equal the plain
    version's exactly; scores within rtol 1e-5 / atol 1e-4 (another
    summation order)."""
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk

    g = torch.Generator(device=cuda_device).manual_seed(mb + window)
    q_n, p_n = 7, 5
    kw = dict(generator=g, device=cuda_device)
    codes = torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw)
    row_ids = torch.arange(cap, dtype=torch.int32, device=cuda_device)
    row_ids[::7] = -1
    corr = torch.randn(cap, **kw) if use_corr else None
    luts = torch.randn((q_n, p_n, 2 * mb, 16), **kw)
    offs = torch.randint(0, cap - window // 2, (q_n, p_n), **kw).to(torch.int32)
    cnts = torch.randint(0, window + 1, (q_n, p_n), **kw).to(torch.int32)
    cnts[0, 0], cnts[0, 1], cnts[1, 0] = 0, window, min(window, 130)
    offs[2, 0], cnts[2, 0] = cap - 3, window  # runs past the layout
    coarse = torch.randn((q_n, p_n), **kw)
    args = (codes, row_ids, corr, luts, offs, cnts, coarse)
    before = pk.pq_adc_scores.launches
    s, i = pk.pq_adc_scores(*args, window=window)
    torch.cuda.synchronize()
    assert pk.pq_adc_scores.launches == before + 1
    ps, pi = pk.pq_adc_scores_plain(*args, window=window)
    assert torch.equal(i, pi)
    assert torch.equal(torch.isinf(s), torch.isinf(ps))
    live = ~torch.isinf(ps)
    assert live.any() and (~live).any()
    torch.testing.assert_close(s[live], ps[live], rtol=1e-5, atol=1e-4)


def test_pq_kernel_matches_plain_on_indexes(cuda_device):
    """K6 on real IVF-PQ layouts (two-level with the correction, 4-bit
    without, 1% deleted, and the ragged index with empty lists and a list
    of one row), 16 queries and one: ids and -inf pattern equal, scores
    within rtol 1e-5 / atol 1e-4."""
    import chip_smoke

    out = chip_smoke.pq_parity_phase(60_000, seed=0, device=cuda_device)
    assert out["cases"] == 6 and out["k6"] <= 1e-3


def test_ivf_pq_search_launches_the_kernel(cuda_device):
    """ivf_pq.search scans packed codes through K6 (and finds each row
    first with refine); unpacked one-byte codes never reach it."""
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((20_000, 64), generator=g, device=cuda_device)
    sp = IVFPQSearchParams(n_probes=8, refine_ratio=8)
    for kw, launched in ((dict(), 1), (dict(pq_bits=4), 1),
                         (dict(two_level=False), 0)):
        ix = ivf_pq.build(IVFPQParams(n_lists=40, **kw), x)
        pk.pq_adc_scores.launches = 0
        d, i = ivf_pq.search(sp, ix, x[:32], 5)
        torch.cuda.synchronize()
        assert pk.pq_adc_scores.launches == launched
        assert i[:, 0].tolist() == list(range(32))


def test_flash_attention_matches_plain(cuda_device):
    """K7 on the whole output for bf16 and fp32, head_dim 128 and 64, GQA
    and MHA, S no multiple of the 64-row tiles, right, left and two-sided
    padding down to a one-token row: within rtol 1e-4 / atol 1e-5 (fp32) or
    rtol 2^-8 / atol 2e-5 (bf16: the output's one rounding) of the plain
    version on the same values in fp32, no NaN."""
    import chip_smoke

    out = chip_smoke.attn_parity_phase(0, device=cuda_device, s_long=1100,
                                       s_batch=130)
    assert out["cases"] == 7


@pytest.mark.parametrize("bad", ["head_dim", "dtype"])
def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda_device,
                                                                  bad):
    """No fallback to the plain version on a CUDA tensor."""
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    hd, dtype = (32, torch.bfloat16) if bad == "head_dim" \
        else (64, torch.float16)
    q = torch.zeros((1, 8, 2, hd), dtype=dtype, device=cuda_device)
    mask = torch.ones((1, 8), dtype=torch.int32, device=cuda_device)
    before = ak.flash_attention.launches
    with pytest.raises(ValueError, match="the kernel takes"):
        ak.flash_attention(q, q, q, mask, 1.0)
    assert ak.flash_attention.launches == before


def test_stream_kernels_match_plain(cuda_device):
    """M1 in both modes (bit-equal, also on a ragged row count), M2 / M4 on
    bf16, int8 and fp32 rows at span 1 and 32 with duplicate ids (bit-equal), M3
    on bf16, int8 and fp32 rows within rtol 1e-4 / atol 2e-3."""
    import chip_smoke

    g = torch.Generator(device=cuda_device).manual_seed(5)
    corpus = torch.randn((60_004, 384), generator=g,
                         device=cuda_device).to(torch.bfloat16)
    out = chip_smoke.stream_parity_phase(corpus, 40_003, seed=0, m=8192)
    assert out["cases"] == 22


def test_stream_kernels_count_launches_and_check_ids(cuda_device):
    from cuvs_rag_tpu_torch.ops import stream_kernels as sk

    x = torch.zeros((64, 128), dtype=torch.bfloat16, device=cuda_device)
    ids = torch.tensor([0, 63], device=cuda_device)
    before = [sk.read_all.launches, sk.gather_rows.launches,
              sk.gather_reduce.launches]
    sk.read_all(x, True)
    sk.gather_rows(x, ids)
    sk.gather_reduce(x, ids)
    torch.cuda.synchronize()
    after = [sk.read_all.launches, sk.gather_rows.launches,
             sk.gather_reduce.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    with pytest.raises(IndexError):
        sk.gather_rows(x, ids, span=2)
    with pytest.raises(ValueError, match="16"):
        sk.gather_rows(x[:, :4].contiguous(), ids)


def test_qwen_encoder_runs_through_the_kernel(cuda_device):
    """A small Qwen3 stack on the card launches K7 once per layer and
    forward call, and embeds like the same weights on the CPU (the plain
    attention) in fp32."""
    import copy

    from cuvs_rag_tpu_torch.models import qwen_encoder as qe
    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    cfg = qe.QwenConfig(vocab_size=500, hidden_size=128, num_layers=3,
                        num_heads=4, num_kv_heads=2, head_dim=64,
                        intermediate_size=256)
    model = qe.QwenModel(cfg).init_random_(torch.Generator().manual_seed(0))
    tok = HashTokenizer(499)
    texts = ["one two three", "a much longer text " * 20, "x"]
    cpu = qe.QwenEmbeddingEncoder(cfg, model, tok, max_length=96,
                                  dtype=torch.float32, device="cpu")
    want = cpu.encode(texts)
    gpu = qe.QwenEmbeddingEncoder(cfg, copy.deepcopy(model), tok,
                                  max_length=96, dtype=torch.float32,
                                  device=cuda_device)
    ak.flash_attention.launches = 0
    got = gpu.encode(texts, batch_size=2)
    assert ak.flash_attention.launches == 2 * cfg.num_layers
    assert abs(got - want).max() < 1e-4
