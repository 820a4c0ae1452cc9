"""The CUDA kernels of cuvs_rag_tpu_torch against their plain versions, on
the card. CUDA kernels have no CPU mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from cuvs_rag_tpu_torch.kernels import build  # noqa: E402
from cuvs_rag_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda


def _k1_launches():
    """(K1's launches, those of its wide route) so far."""
    wide = build.launches["flat_exact_wide_topk"]
    return build.launches["flat_exact_topk"] + wide, wide


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_kernels_match_plain_versions(cuda_device):
    """K1 (3 dtypes x 2 metrics x k in {1, 10, 32} at 16 queries, k = 10 at
    1 and 40), K2 (fp32, bf16, int8 with bf16 queries, int8 x int8) and K3
    (3 dtypes, k = 600 and the few-planes certificate case) on a
    tile-aligned and a ragged corpus with tombstones: scores within rtol
    1e-5 / atol 1e-3, ids equal up to k-th-score ties; K1 and K2 also
    within their rounding bound, K2's int8 x int8 bit for bit."""
    import chip_smoke

    out = chip_smoke.parity_phase(50_000, 40_003, seed=0, device=cuda_device,
                                  k_large=600)
    assert out["cases"] == 100 and out["exact_over_allowed"] <= 1.0
    assert out["sketch_over_allowed"] <= 1.0
    assert out["sketch_int8_bit_equal"] == 4
    assert out["exact_route"] == {"float32": "ring_fp32", "bfloat16": "ring",
                                  "int8": "ring"}
    assert out["sketch_route"] == {"float32": "ring_fp32", "bfloat16": "ring",
                                   "int8": "ring", "int8 x int8": "ring_int8"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [16, 40, 42, 64, 384, 1024])
def test_exact_kernel_routes_match_plain(cuda_device, d, dtype):
    """K1 by every route (tensor cores where a bf16 or int8 row is a whole
    number of 32-byte units, fp32 rows through the ring on the CUDA cores,
    the older CUDA-core kernel elsewhere: d = 42 for every type) on a ragged
    100,003-row corpus with pad rows and 1% tombstones, n_q in {1, 16, 17,
    40} x k in {1, 10, 32}, both metrics: against the plain version (rtol
    1e-5 / atol 1e-3, ids up to ties) and within flat_rounding_bound."""
    import chip_smoke
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n = 100_003
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    ix = flat.build(FlatParams(dtype=dtype, tile_n=2048), x)
    ix = flat.delete(ix, torch.arange(3, n, 100, device=cuda_device))
    storage = min(ix.size, n + 1000)
    before = _k1_launches()[0]
    for n_q in (1, 16, 17, 40):
        q = torch.cat([x[:n_q // 2] + 0.05, torch.randn(
            (n_q - n_q // 2, d), generator=g, device=cuda_device)])
        args = (ix.vectors[:storage], ix.sqnorms[:storage], q, ix.n_valid,
                ix.scales[:storage])
        for metric in ("sqeuclidean", "inner_product"):
            for k in (1, 10, 32):
                got = fk.flat_topk_exact(*args, k=k, metric=metric)
                torch.cuda.synchronize()
                want = fk.flat_topk_exact_plain(*args, k=k, metric=metric)
                compare_topk(*got, *want, **chip_smoke.TOL)
                assert chip_smoke.k1_hold(got, args, metric) <= 1.0
    assert _k1_launches()[0] == before + 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_exact_kernel_tie_order(cuda_device, dtype):
    """Small-integer rows make every score exact in fp32 whatever the order
    of the adds, and a corpus with each row stored three times ties
    heavily: ids and scores must equal a stable descending sort of the
    plain scores (the lower row first), across tiles and splits."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk

    n, d, k = 50_000, 384, 32
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).float()
    x[1000:2000] = x[:1000]
    x[30_000:31_000] = x[:1000]
    q = torch.cat([x[:8], torch.randint(-2, 3, (8, d), generator=g,
                                        device=cuda_device).float()])
    v, sq = x.to(getattr(torch, dtype)), (x * x).sum(1)
    for metric in ("sqeuclidean", "inner_product"):
        got_s, got_i = fk.flat_topk_exact(v, sq, q, n, None, k=k, metric=metric)
        qq, _, scales = fk._prepare(v, sq, q, n, None, metric)
        order = torch.sort(fk._scores_plain(v, sq, qq, n, scales, metric),
                           dim=1, descending=True, stable=True)
        assert torch.equal(got_i, order.indices[:, :k].to(torch.int32))
        assert torch.equal(got_s, order.values[:, :k])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("d", [64, 384, 768])
def test_exact_wide_route_matches_plain(cuda_device, d, dtype):
    """K1's wide kernel (more than 16 queries; bf16 rows and int8 rows
    widened to bf16) on a ragged 100,003-row corpus with pad rows and 1%
    tombstones, n_q in {17, 25, 100, 128, 129} (one pass or two, as D and
    k leave room) x k in {1, 10, 32}, both metrics: against
    the plain version (rtol 1e-5 / atol 1e-3, ids up to ties) and within
    flat_rounding_bound. Every call is one launch of the wide route; a
    one-query call takes the 16-query kernel and leaves the wide count."""
    import chip_smoke
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n = 100_003
    g = torch.Generator(device=cuda_device).manual_seed(d + 1)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    ix = flat.build(FlatParams(dtype=dtype, tile_n=2048), x)
    ix = flat.delete(ix, torch.arange(5, n, 100, device=cuda_device))
    storage = min(ix.size, n + 1000)
    assert storage > ix.n_valid  # pad rows in the scan
    for n_q in (17, 25, 100, 128, 129):
        q = torch.cat([x[:n_q // 2] + 0.05, torch.randn(
            (n_q - n_q // 2, d), generator=g, device=cuda_device)])
        args = (ix.vectors[:storage], ix.sqnorms[:storage], q, ix.n_valid,
                ix.scales[:storage])
        plan = fk.exact_plan(storage, n_q, d, ix.vectors.dtype,
                             build.sm_count(cuda_device), 32)
        assert plan.route == "ring_wide"
        for metric in ("sqeuclidean", "inner_product"):
            for k in (1, 10, 32):
                before = _k1_launches()
                got = fk.flat_topk_exact(*args, k=k, metric=metric)
                torch.cuda.synchronize()
                assert _k1_launches() == (before[0] + 1, before[1] + 1)
                want = fk.flat_topk_exact_plain(*args, k=k, metric=metric)
                compare_topk(*got, *want, **chip_smoke.TOL)
                assert chip_smoke.k1_hold(got, args, metric) <= 1.0
    before = _k1_launches()
    fk.flat_topk_exact(*args[:2], q[:1], *args[3:], k=10, metric="sqeuclidean")
    assert _k1_launches() == (before[0] + 1, before[1])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_exact_wide_kernel_tie_order(cuda_device, dtype):
    """The tie case of test_exact_kernel_tie_order through the wide kernel
    (100 queries, one pass, 132 splits or as many as the card has SMs):
    ids and scores equal a stable descending sort of the plain scores."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk

    n, d, k = 50_000, 384, 32
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).float()
    x[1000:2000] = x[:1000]
    x[30_000:31_000] = x[:1000]
    q = torch.cat([x[:50], torch.randint(-2, 3, (50, d), generator=g,
                                         device=cuda_device).float()])
    v, sq = x.to(getattr(torch, dtype)), (x * x).sum(1)
    for metric in ("sqeuclidean", "inner_product"):
        before = build.launches["flat_exact_wide_topk"]
        got_s, got_i = fk.flat_topk_exact(v, sq, q, n, None, k=k, metric=metric)
        assert build.launches["flat_exact_wide_topk"] == before + 1
        qq, _, scales = fk._prepare(v, sq, q, n, None, metric)
        order = torch.sort(fk._scores_plain(v, sq, qq, n, scales, metric),
                           dim=1, descending=True, stable=True)
        assert torch.equal(got_i, order.indices[:, :k].to(torch.int32))
        assert torch.equal(got_s, order.values[:, :k])


@pytest.mark.parametrize("n", [5, 100])
def test_exact_kernel_on_short_corpora(cuda_device, n):
    """A corpus shorter than k and one shorter than a tile."""
    import chip_smoke
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.compare import compare_topk

    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((n, 384), generator=g, device=cuda_device).bfloat16()
    sq = (x.float() ** 2).sum(1)
    q = torch.randn((3, 384), generator=g, device=cuda_device)
    got = fk.flat_topk_exact(x, sq, q, n, None, k=10, metric="sqeuclidean")
    want = fk.flat_topk_exact_plain(x, sq, q, n, None, k=10,
                                    metric="sqeuclidean")
    compare_topk(*got, *want, **chip_smoke.TOL)
    assert int((got[1] >= 0).sum()) == 3 * min(n, 10)


@pytest.mark.parametrize("dtype,int8c", [("float32", False),
                                         ("bfloat16", False),
                                         ("int8", False), ("int8", True)])
@pytest.mark.parametrize("d", [16, 40, 42, 64, 384, 1024, 1056])
def test_sketch_kernel_routes_match_plain(cuda_device, d, dtype, int8c):
    """K2 by every route (the ring on the tensor cores for bf16 and int8
    rows of whole 32-byte units, int8 x int8 on the int8 product, fp32 rows
    of whole 16-byte pieces on the ring with fp32 FMAs, the older kernel
    elsewhere: d = 42 for every type) on a ragged 50,003-row corpus with
    pad rows and 1% tombstones, W in {100, 128, 2048} (class chunks of 100
    and 128 classes, the last one short) x n_q in {1, 16, 17, 40}, both
    metrics: int8 x int8 bit-equal to the plain version (ties included,
    also past D = 1040 where the plain dot is taken in fp64), the others
    within rtol 1e-5 / atol 1e-3 (ids up to ties) and flat_rounding_bound."""
    import chip_smoke
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n = 50_003
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    ix = flat.build(FlatParams(dtype=dtype, tile_n=2048), x)
    ix = flat.delete(ix, torch.arange(3, n, 100, device=cuda_device))
    storage = min(ix.size, n + 1000)
    before = build.launches["flat_sketch_topk"]
    for n_q in (1, 16, 17, 40):
        q = torch.cat([x[:n_q // 2] + 0.05, torch.randn(
            (n_q - n_q // 2, d), generator=g, device=cuda_device)])
        args = (ix.vectors[:storage], ix.sqnorms[:storage], q, ix.n_valid,
                ix.scales[:storage])
        for w in (100, 128, 2048):
            for metric in ("sqeuclidean", "inner_product"):
                kw = dict(k=10, metric=metric, tile_c=w, int8_compute=int8c)
                got = fk.flat_topk_sketch(*args, **kw)
                torch.cuda.synchronize()
                assert chip_smoke.sketch_hold(got, args, kw)[1] <= 1.0
    assert build.launches["flat_sketch_topk"] == before + 24


@pytest.mark.parametrize("dtype,int8c", [("float32", False),
                                         ("bfloat16", False),
                                         ("int8", False), ("int8", True)])
def test_sketch_kernel_tie_order(cuda_device, dtype, int8c):
    """Small-integer rows make every score exact whatever the order of the
    adds, and rows stored three times tie heavily: by every ring route K2
    must equal its plain version bit for bit (the earliest row of a class,
    the lower class of a tie), across tiles and splits."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk

    n, d = 50_000, 384
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).float()
    x[1000:2000] = x[:1000]
    x[30_000:31_000] = x[:1000]
    q = torch.cat([x[:8], torch.randint(-2, 3, (8, d), generator=g,
                                        device=cuda_device).float()])
    v, sq = x.to(getattr(torch, dtype)), (x * x).sum(1)
    for w in (128, 1000):
        for metric in ("sqeuclidean", "inner_product"):
            kw = dict(k=32, metric=metric, tile_c=w, int8_compute=int8c)
            got = fk.flat_topk_sketch(v, sq, q, n, None, **kw)
            want = fk.flat_topk_sketch_plain(v, sq, q, n, None, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _ivf_windows(dtype, d, g, dev, window=2048):
    """A sorted layout of 10 lists (counts 0, 1, 31, 32, 127, 128, 129,
    2,047, the window and more than the window) starting at arbitrary
    rows, residual int8 rows with scales and coarse terms, and queries
    that probe all 10 lists in their own order: (vectors, sqnorms, scales,
    queries (17, d), offsets (17, 10), counts (17, 10), coarse or None)."""
    from cuvs_rag_tpu_torch.ops import distance as dist_ops

    counts = torch.tensor([0, 1, 31, 32, 127, 128, 129, 2047, window,
                           window + 52], device=dev)
    gaps = torch.randint(0, 40, (10,), generator=g, device=dev)
    starts = torch.cumsum(gaps + torch.cat([counts.new_zeros(1), counts[:-1]]), 0)
    cap = int(starts[-1] + counts[-1]) + 7
    x = torch.randn((cap, d), generator=g, device=dev) / d ** 0.5
    coarse = None
    if dtype == "int8":
        vectors, scales = dist_ops.quantize_rows(0.3 * x)
        sq = ((vectors.float() * scales[:, None]) ** 2).sum(1)
        coarse = 0.3 * torch.randn((17, 10), generator=g, device=dev)
    else:
        vectors = x.to(getattr(torch, dtype))
        scales = torch.ones(cap, device=dev)
        sq = (vectors.float() ** 2).sum(1)
    sq[::97] += 2e30  # tombstones
    order = torch.stack([torch.randperm(10, generator=g, device=dev)
                         for _ in range(17)])
    queries = x[starts[order[:, 7]] + 5] * 3 + 0.01
    return (vectors, sq, scales, queries, starts[order].int(),
            counts[order].int(), coarse)


@pytest.mark.parametrize("piece", [None, 256, 0])
@pytest.mark.parametrize("d", [40, 42, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_kernel_routes_match_plain(cuda_device, dtype, d, piece):
    """K4 by both routes (the ring where rows are whole 16-byte pieces:
    d = 40 for fp32 and bf16, 384 for all; the older kernel at d = 42 and
    for int8 at d = 40) and, on the ring, at the shipped window piece, 256
    rows and the whole window, over windows that start at arbitrary rows
    with counts 0, 1, 31, 32, 127, 128, 129, 2,047, the window and past it,
    1% tombstones, n_q in {1, 16, 17} x k in {1, 10, 32}, both metrics:
    within rtol 1e-5 / atol 1e-3 of the plain version (ids up to ties) and
    within ivf_rounding_bound."""
    import functools
    from unittest import mock

    import chip_smoke
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.compare import compare_topk

    g = torch.Generator(device=cuda_device).manual_seed(d)
    vectors, sq, scales, queries, offs, cnts, coarse = _ivf_windows(
        dtype, d, g, cuda_device)
    before = build.launches["ivf_scan_topk"]
    pieces = ik.k4_pieces if piece is None else functools.partial(
        ik.k4_pieces, piece=piece)
    with mock.patch.object(ik, "k4_pieces", pieces):
        for n_q in (1, 16, 17):
            args = (vectors, sq, scales, queries[:n_q], offs[:n_q], cnts[:n_q])
            for metric in ("sqeuclidean", "inner_product"):
                kw = dict(window=2048, metric=metric,
                          coarse_ip=None if coarse is None else coarse[:n_q])
                for k in (1, 10, 32):
                    got = ik.ivf_scan(*args, k=k, **kw)
                    torch.cuda.synchronize()
                    want = ik.ivf_scan_plain(*args, k=k, **kw)
                    compare_topk(*got, *want, **chip_smoke.TOL)
                    assert chip_smoke.ivf_hold(got, args, kw) <= 1.0
    assert build.launches["ivf_scan_topk"] == before + 18


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("int8", 64), ("bfloat16", 42),
                                     ("float32", 384), ("int8", 384)])
def test_large_kernel_routes_hold(cuda_device, dtype, d):
    """K3 by each route (the ring on the tensor cores for bf16 and int8
    rows, fp32 FMAs for fp32 rows; the older kernel at d = 42) on a ragged
    50,003-row corpus with pad rows past n_valid and 1% tombstones, k in
    {33, 300, 2,000} and the few-planes case (k = 300, 128 classes, R = 3),
    at 1, 16 and 40 queries, both metrics, each by chip_smoke.large_hold:
    certified rows exact, certificate differences only within the
    rounding bound (ring routes) or none (older route), planes equal to
    the plain version's up to ties within the bound."""
    import chip_smoke
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n = 50_003
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device=cuda_device), dim=1)
    ix = flat.build(FlatParams(dtype=dtype, tile_n=2048), x)
    ix = flat.delete(ix, torch.arange(3, n, 100, device=cuda_device))
    storage = min(ix.size, n + 1000)
    want_route = fk.exact_route(ix.vectors.dtype, d)
    before = build.launches["flat_topr"]
    calls = 0
    for n_q in (1, 16, 40):
        q = torch.cat([x[:n_q // 2] + 0.01, torch.nn.functional.normalize(
            torch.randn((n_q - n_q // 2, d), generator=g, device=cuda_device),
            dim=1)])
        args = (ix.vectors[:storage], ix.sqnorms[:storage], q, ix.n_valid,
                ix.scales[:storage])
        for metric in ("sqeuclidean", "inner_product"):
            for kw in (dict(k=33), dict(k=300), dict(k=2000),
                       dict(k=300, tile_c=128, r_planes=3)):
                held = chip_smoke.large_hold("flat_topk_large", args,
                                             dict(kw, metric=metric))
                assert held["route"] == want_route
                calls += 2
    assert build.launches["flat_topr"] == before + calls


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_large_kernel_plans_agree(cuda_device, blocks_per_sm):
    """K3's two ring plans (queries a block by the budget at two blocks an
    SM; all 16 at one block an SM) and 4-byte plane ids (a corpus of more
    than 65,535 tiles: 1,100,000 rows of 16 classes) hold by large_hold,
    and the two plans give the same scores and certificates."""
    import functools
    from unittest import mock

    import chip_smoke
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.nn.functional.normalize(
        torch.randn((1_100_000, 64), generator=g, device=cuda_device), dim=1)
    v, sq = x.to(torch.bfloat16), (x * x).sum(1)
    q = x[:16] + 0.01
    args = (v, sq, q, x.shape[0], None)
    for kw in (dict(k=2000), dict(k=100, tile_c=16)):
        kw = dict(kw, metric="sqeuclidean")
        with mock.patch.object(fk, "topr_plan", functools.partial(
                fk.topr_plan, blocks_per_sm=blocks_per_sm)):
            chip_smoke.large_hold("flat_topk_large", args, kw)
            got = fk.flat_topk_large(*args, **kw)
        want = fk.flat_topk_large(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("d", [40, 42, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_large_kernel_routes_hold(cuda_device, dtype, d):
    """K5 by both routes (the ring where rows are whole 16-byte pieces, the
    older kernel at d = 42 and for int8 at d = 40) over windows that start
    at arbitrary rows with counts 0, 1, 31, 32, 127, 128, 129, 2,047, the
    window and past it, 1% tombstones, n_q in {1, 16, 17}, all ten probes
    and one, k in {33, 2,000}, whole windows and 128-row sub-windows with
    few planes, both metrics, each by chip_smoke.large_hold."""
    import chip_smoke
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik

    g = torch.Generator(device=cuda_device).manual_seed(d)
    vectors, sq, scales, queries, offs, cnts, coarse = _ivf_windows(
        dtype, d, g, cuda_device)
    before = build.launches["ivf_scan_topr"]
    calls = 0
    for n_q in (1, 16, 17):
        for probes in (10, 1):
            args = (vectors, sq, scales, queries[:n_q], offs[:n_q, :probes],
                    cnts[:n_q, :probes])
            for metric in ("sqeuclidean", "inner_product"):
                kw = dict(window=2048, metric=metric, coarse_ip=None
                          if coarse is None else coarse[:n_q, :probes])
                for kw5 in (dict(k=33), dict(k=2000),
                            dict(k=300, n_sub=16, r_planes=3)):
                    held = chip_smoke.large_hold("ivf_scan_large", args,
                                                 dict(kw5, **kw))
                    assert held["route"] == ik.ivf_route(vectors.dtype, d)
                    calls += 2
    assert build.launches["ivf_scan_topr"] == before + calls


def test_ivf_large_kernel_on_ragged_index(cuda_device):
    """K5 on chip_smoke.ragged_ivf_index (250 empty lists, lists of 1 to
    1,500 rows) at every split the plan may choose, by large_hold."""
    from unittest import mock

    import chip_smoke
    from cuvs_rag_tpu_torch.index import ivf_flat

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((30_000, chip_smoke.D), generator=g, device=cuda_device)
    ix, q = chip_smoke.ragged_ivf_index(x, g, cuda_device)
    for n_probe in (1, 4, 20):
        probes, coarse = ivf_flat.probe(ix, q, n_probe, "sqeuclidean")
        p = probes.long()
        args = (ix.vectors, ix.sqnorms, ix.scales, q, ix.list_offsets[p],
                ix.list_counts[p])
        kw = dict(k=200, window=ix.max_list_size, metric="sqeuclidean")
        for sms in (132, 1, 100_000):  # splits from one to every probe
            with mock.patch.object(build, "sm_count", lambda dev, n=sms: n):
                chip_smoke.large_hold("ivf_scan_large", args, kw)


def test_ivf_kernels_match_plain_versions(cuda_device):
    """K4 (k in {1, 10, 32}) and K5 (k = 600, and the few-planes
    certificate case) on fp32, bf16 and int8 IVF-Flat indexes of a
    clustered corpus with deletions, and on an index with empty and short
    lists, both metrics: scores within rtol 1e-5 / atol 1e-3, ids equal up
    to k-th-score ties, certificate flags equal to the plain K5's; K4 also
    within ivf_rounding_bound."""
    import chip_smoke

    out = chip_smoke.ivf_parity_phase(60_000, seed=0, device=cuda_device,
                                      k_large=600)
    assert out["cases"] == 40 and out["k4_over_allowed"] <= 1.0
    assert set(out["k4_route"].values()) == {"ring"}


def test_search_launches_each_kernel(cuda_device):
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.utils.config import FlatParams, FlatSearchParams

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((flat._DENSE_THRESHOLD + 5, 64), generator=g,
                    device=cuda_device)
    ix = flat.build(FlatParams(dtype="bfloat16"), x)
    before = [_k1_launches()[0], build.launches["flat_sketch_topk"],
              build.launches["flat_topr"]]
    profiling.clear()
    profiling.record_spans(True)
    try:
        for k, sp in ((5, None), (5, FlatSearchParams(approx=True)),
                      (100, None)):
            _, i = flat.search(sp, ix, x[:4], k)
            assert i[:, 0].tolist() == [0, 1, 2, 3]
    finally:
        profiling.record_spans(False)
    after = [_k1_launches()[0], build.launches["flat_sketch_topk"],
             build.launches["flat_topr"]]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    # each kernel's launch call is the span kernel.launch, under its label
    _hold_launch_spans(profiling.spans(), "flat.search", ["K1", "K2", "K3"],
                       x.device.index)

    # 100 queries take the wide kernel: still one kernel.launch span and
    # one exact_scan* kernel a call (what k1_roofline counts), and its merge
    q = x[:100]
    wide = build.launches["flat_exact_wide_topk"]
    profiling.clear()
    profiling.record_spans(True)
    try:
        _, i = flat.search(None, ix, q, 5)
    finally:
        profiling.record_spans(False)
    assert i[:, 0].tolist() == list(range(100))
    assert build.launches["flat_exact_wide_topk"] == wide + 1
    _hold_launch_spans(profiling.spans(), "flat.search", ["K1"],
                       x.device.index)
    calls = 5
    counts = _kernel_counts(lambda: flat.search(None, ix, q, 5), calls,
                            ("exact_scan", "merge_partials"))
    assert counts["exact_scan"] == {"exact_scan_wide_kernel": calls}
    assert sum(counts["merge_partials"].values()) == calls


def _kernel_counts(fn, calls, names, attempts=3):
    """{name: {kernel: launches}} of the CUDA kernels whose names contain
    each of `names`, over `calls` fn() under torch.profiler. The profiler
    has been seen to drop kernel records (eval/roofline.device_ms), so a
    window that records fewer than `calls` launches of a name is taken
    again, up to `attempts` windows."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {name: {} for name in names}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for name in names:
                if name in e.key:
                    kernel = re.search(r"(\w*%s\w*)" % name, e.key).group(1)
                    out[name][kernel] = out[name].get(kernel, 0) + e.count
        if all(sum(v.values()) >= calls for v in out.values()):
            return out
    return out


def test_ivf_search_launches_each_kernel(cuda_device):
    """IVF-Flat search runs K4 at k <= 32 and K5 above it."""
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((20_000, 64), generator=g, device=cuda_device)
    ix = ivf_flat.build(IVFFlatParams(n_lists=40, dtype="bfloat16"), x)
    before = [build.launches["ivf_scan_topk"], build.launches["ivf_scan_topr"]]
    profiling.clear()
    profiling.record_spans(True)
    try:
        for k in (5, 100):
            _, i = ivf_flat.search(None, ix, x[:4], k)
            assert i[:, 0].tolist() == [0, 1, 2, 3]
    finally:
        profiling.record_spans(False)
    after = [build.launches["ivf_scan_topk"], build.launches["ivf_scan_topr"]]
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    # each kernel's launch call is the span kernel.launch, under its label
    _hold_launch_spans(profiling.spans(), "ivf_flat.search", ["K4", "K5"],
                       x.device.index)


def _hold_launch_spans(spans, family_span, kernels, device):
    """One kernel.launch span a family search, (kernel, device) of
    `kernels` in the searches' order, each inside its search; every span
    inside its parent, in its request."""
    by_id = {s["id"]: s for s in spans}
    launches = sorted((s for s in spans if s["name"] == "kernel.launch"),
                      key=lambda s: s["start_ns"])
    assert [s["attrs"] for s in launches] == [
        {"kernel": kernel, "device": device} for kernel in kernels]
    tops = sorted((s for s in spans if s["name"] == family_span),
                  key=lambda s: s["start_ns"])
    assert len(tops) == len(kernels)
    for launch, top in zip(launches, tops):
        up = by_id[launch["parent"]]
        while up["name"] != family_span:
            up = by_id[up["parent"]]
        assert up is top
    for s in spans:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            assert s["request"] == p["request"]


def _hold_k6(args, window, positions):
    """Run K6 and its plain version on `args`; hold ids and the -inf
    pattern equal and live scores within rtol 1e-5 / atol 1e-4, and the
    blocks the kernel counted by copy route equal to what adc_route_blocks
    says of these offsets. Returns the route counts of the call."""
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk

    counts = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    before = build.launches["pq_adc_scores"]
    s, i = pk.pq_adc_scores(*args, window=window, positions=positions,
                            route_counts=counts)
    torch.cuda.synchronize()
    assert build.launches["pq_adc_scores"] == before + 1
    routes = dict(zip(pk.ROUTES, counts.tolist()))
    assert routes == pk.adc_route_blocks(args[0], args[4], args[5],
                                         window=window)
    ps, pi = pk.pq_adc_scores_plain(*args, window=window, positions=positions)
    assert torch.equal(i, pi)
    assert torch.equal(torch.isinf(s), torch.isinf(ps))
    live = ~torch.isinf(ps)
    assert live.any() and (~live).any()
    torch.testing.assert_close(s[live], ps[live], rtol=1e-5, atol=1e-4)
    return routes


@pytest.mark.parametrize("mb,window,cap", [(48, 1280, 9000), (5, 333, 1001),
                                           (400, 130, 700), (96, 1280, 9216),
                                           (48, 1280, 9216)])
@pytest.mark.parametrize("use_corr", [True, False])
def test_pq_adc_kernel_matches_plain(cuda_device, mb, window, cap, use_corr):
    """K6 on random packed codes and tables, with row ids and with layout
    positions as ids: any mb (400 streams need more than 48 KB of shared
    memory; 96 is the CLI's pq_dim), a window and a cap that no tile
    divides, empty, full and straddling lists, windows that run past the
    layout's end, and tombstoned slots. A cap that is a multiple of 16 gets
    windows at multiples of 128, as an index's layout has them, and every
    block takes the words route; an odd cap takes the bytes route, other
    caps both. Ids and the -inf pattern equal the plain version's exactly;
    scores within rtol 1e-5 / atol 1e-4 (another summation order)."""
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
    aligned = cap % 16 == 0
    if aligned:
        offs = offs // 128 * 128
        offs[2, 0] = cap - 128
    coarse = torch.randn((q_n, p_n), **kw)
    args = (codes, row_ids, corr, luts, offs, cnts, coarse)
    for positions in (False, True):
        routes = _hold_k6(args, window, positions)
        if aligned:
            assert routes["words"] > 0 and routes["bytes"] == 0
        elif cap % 4:
            assert routes["words"] == 0 and routes["bytes"] > 0


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("cap,window", [(9000, 1280), (9001, 1280),
                                        (9000, 1001), (4099, 37),
                                        (9008, 1280)])
def test_pq_adc_kernel_alignment(cuda_device, shift, cap, window):
    """K6 where its routes must care: window starts at every offset mod 4
    (at shift 0 the words route where cap is a multiple of 4, the bytes
    route beside it for the window at cap - 3), an odd cap (stream starts
    are not 4-byte aligned), windows that are no multiple of 4,
    lists of 0 rows and of more rows than the window, with and without the
    correction, 48 and 96 streams, row ids and positions: ids and the -inf
    pattern equal the plain version's, scores within rtol 1e-5 / atol 1e-4,
    each block's route as adc_route_blocks predicts."""
    g = torch.Generator(device=cuda_device).manual_seed(cap + window + shift)
    q_n, p_n = 5, 7
    kw = dict(generator=g, device=cuda_device)
    row_ids = torch.randint(0, 1 << 20, (cap,), dtype=torch.int32, **kw)
    row_ids[torch.rand(cap, **kw) < 0.05] = -1
    offs = (torch.randint(0, cap - window // 2, (q_n, p_n), **kw) // 4 * 4
            + shift).to(torch.int32)
    cnts = torch.randint(0, window + 200, (q_n, p_n), **kw).to(torch.int32)
    cnts[0, 0] = 0
    offs[0, -1], cnts[0, -1] = cap - 3, window
    coarse = torch.randn((q_n, p_n), **kw)
    routes = {"words": 0, "bytes": 0}
    for mb in (48, 96):
        codes = torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw)
        luts = torch.randn((q_n, p_n, 2 * mb, 16), **kw)
        for corr in (torch.randn(cap, **kw), None):
            args = (codes, row_ids, corr, luts, offs, cnts, coarse)
            for positions in (False, True):
                for k, v in _hold_k6(args, window, positions).items():
                    routes[k] += v
    assert routes["bytes"] > 0
    assert (routes["words"] > 0) == (cap % 4 == 0 and shift == 0)


def test_pq_adc_wrapper_adds_no_sync(cuda_device):
    """The K6 wrapper never waits for the card: under
    torch.cuda.set_sync_debug_mode("error") a call in either id mode, with
    a table that is a misaligned view (copied on the card), raises
    nothing."""
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk

    g = torch.Generator(device=cuda_device).manual_seed(11)
    kw = dict(generator=g, device=cuda_device)
    mb, cap, window, q_n, p_n = 48, 40_960, 1280, 16, 20
    codes = torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw)
    row_ids = torch.arange(cap, dtype=torch.int32, device=cuda_device)
    luts = torch.randn((q_n, p_n, 2 * mb, 16), **kw)
    offs = (torch.randint(0, (cap - window) // 128, (q_n, p_n), **kw)
            * 128).to(torch.int32)
    cnts = torch.randint(400, window + 1, (q_n, p_n), **kw).to(torch.int32)
    coarse = torch.randn((q_n, p_n), **kw)
    flat = torch.randn(luts.numel() + 1, **kw)
    odd = flat[1:].view(luts.shape)  # starts 4 bytes into an allocation
    odd.copy_(luts)
    args = (codes, row_ids, torch.randn(cap, **kw), luts, offs, cnts, coarse)
    want = pk.pq_adc_scores(*args, window=window)  # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [pk.pq_adc_scores(*a, window=window, positions=p)
               for a in (args, args[:3] + (odd,) + args[4:])
               for p in (False, True)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for s, i in got:
        assert torch.equal(s, want[0])
    assert torch.equal(got[0][1], want[1]) and torch.equal(got[2][1], want[1])
    assert torch.equal(got[1][1], got[3][1]) and (got[1][1] >= 0).any()


def test_pq_kernel_matches_plain_on_indexes(cuda_device):
    """K6 on real IVF-PQ layouts (two-level with the correction, 4-bit
    without, 1% deleted, and the ragged index with empty lists and a list
    of one row, also cut to a cap that is no multiple of 4 and with its
    windows shifted by 3), 16 queries and one, row ids and positions: ids
    and -inf pattern equal, scores within rtol 1e-5 / atol 1e-4, both of
    the kernel's routes taken."""
    import chip_smoke

    out = chip_smoke.pq_parity_phase(60_000, seed=0, device=cuda_device)
    assert out["cases"] == 10 and out["k6"] <= 1e-3
    assert min(out["routes"].values()) > 0


def test_ivf_pq_search_launches_the_kernel(cuda_device):
    """ivf_pq.search scans packed codes through K6 (and finds each row
    first with refine); unpacked one-byte codes never reach it."""
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((20_000, 64), generator=g, device=cuda_device)
    sp = IVFPQSearchParams(n_probes=8, refine_ratio=8)
    for kw, launched in ((dict(), 1), (dict(pq_bits=4), 1),
                         (dict(two_level=False), 0)):
        ix = ivf_pq.build(IVFPQParams(n_lists=40, **kw), x)
        before = build.launches["pq_adc_scores"]
        d, i = ivf_pq.search(sp, ix, x[:32], 5)
        torch.cuda.synchronize()
        assert build.launches["pq_adc_scores"] == before + launched
        assert i[:, 0].tolist() == list(range(32))


def test_flash_attention_matches_plain(cuda_device):
    """K7 on the whole output for bf16 and fp32, head_dim 128 and 64, GQA
    and MHA, S no multiple of the 128-key tiles, right, left and two-sided
    padding down to a one-token row, q = 0 and sharpened scores: fp32
    within rtol 1e-4 / atol 1e-5 of the plain version, bf16 within
    `attention_rounding_bound` of the plain version on the same values in
    fp32 (q = 0: rtol 2^-8 / atol 2e-5, the output's one rounding), no NaN."""
    import chip_smoke

    out = chip_smoke.attn_parity_phase(0, device=cuda_device, s_long=1100,
                                       s_batch=130)
    assert out["cases"] == 10
    assert max(out["max_err_over_allowed"].values()) <= 1.0


@pytest.mark.parametrize("nh,nkv,hd", [
    (8, 2, 128),   # four heads of a kv group share a block, 32 rows each
    (6, 2, 64),    # a group of three: one head a block, 128 rows
    (4, 1, 64), (2, 2, 128), (16, 8, 64),
])
@pytest.mark.parametrize("padding", ["left", "mixed"])
def test_flash_attention_head_groupings(cuda_device, nh, nkv, hd, padding):
    """bf16 K7 at every way the query heads of a kv group fill a block's 128
    rows, S no multiple of the 128-key tile nor of any row tile, ragged
    padding: within `attention_rounding_bound`; with q = 0 (the output is
    the mean of the allowed v rows: head mapping and masks) within the
    output's one rounding."""
    import chip_smoke
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    g = torch.Generator(device=cuda_device).manual_seed(nh * hd)
    b, s = 3, 333
    q, k, v = chip_smoke.attn_inputs(b, s, nh, nkv, hd, torch.bfloat16, g,
                                     cuda_device)
    mask = chip_smoke.pad_mask(padding, b, s, cuda_device)
    for exact_p in (False, True):
        if exact_p:
            q = torch.zeros_like(q)
        got = ak.flash_attention(q, k, v, mask, hd ** -0.5)
        torch.cuda.synchronize()
        _, ratio, _ = chip_smoke.attn_hold(got, q, k, v, mask, hd ** -0.5,
                                           exact_p=exact_p)
        assert ratio <= 1.0


@pytest.mark.parametrize("bad", ["head_dim", "dtype"])
def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda_device,
                                                                  bad):
    """No fallback to the plain version on a CUDA tensor."""
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    hd, dtype = (32, torch.bfloat16) if bad == "head_dim" \
        else (64, torch.float16)
    q = torch.zeros((1, 8, 2, hd), dtype=dtype, device=cuda_device)
    mask = torch.ones((1, 8), dtype=torch.int32, device=cuda_device)
    before = build.launches["flash_attention"]
    with pytest.raises(ValueError, match="the kernel takes"):
        ak.flash_attention(q, q, q, mask, 1.0)
    assert build.launches["flash_attention"] == before


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


@pytest.mark.parametrize("row_bytes", [16, 96, 768, 1536, 4096])
@pytest.mark.parametrize("m,span", [(1, 1), (1000, 1), (37, 32), (1, 32)])
def test_gather_rows_on_ragged_chunk_counts(cuda_device, row_bytes, m, span):
    """M2 / M4 bit-equal to the plain version where a row's 16-byte chunks
    fill no whole number of lane groups (1, 6, 48, 96 and 256 chunks a row;
    32-row spans), on one segment and on many, with duplicate ids."""
    from cuvs_rag_tpu_torch.ops import stream_kernels as sk

    g = torch.Generator(device=cuda_device).manual_seed(row_bytes + m)
    x = torch.randint(-128, 128, (5000, row_bytes), generator=g,
                      device=cuda_device).to(torch.int8)
    ids = torch.randint(0, 5000 - span + 1, (m,), generator=g,
                        device=cuda_device)
    ids[: m // 3] = ids[0]
    got = sk.gather_rows(x, ids, span)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.gather_rows_plain(x, ids, span))


def test_stream_kernels_count_launches_and_check_ids(cuda_device):
    from cuvs_rag_tpu_torch.ops import stream_kernels as sk

    x = torch.zeros((64, 128), dtype=torch.bfloat16, device=cuda_device)
    ids = torch.tensor([0, 63], device=cuda_device)
    entries = ("read_all", "gather_rows", "gather_reduce")
    before = [build.launches[e] for e in entries]
    sk.read_all(x, True)
    sk.gather_rows(x, ids)
    sk.gather_reduce(x, ids)
    torch.cuda.synchronize()
    after = [build.launches[e] for e in entries]
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
    before = build.launches["flash_attention"]
    got = gpu.encode(texts, batch_size=2)
    assert build.launches["flash_attention"] == before + 2 * cfg.num_layers
    assert abs(got - want).max() < 1e-4
