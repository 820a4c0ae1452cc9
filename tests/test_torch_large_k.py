"""The certified large-k kernels' host side, on the CPU: the plain version
of the split-then-merge that K3 and K5 run on the card (`topr_merge_plain`,
`topr_planes_plain`), the rules that choose their routes and splits
(`topr_plan`, `k5_plan`), what `large_k_config` admits, and the rule their
planes are held to (`utils/compare.compare_planes`).

Tolerances: the split emulation must give the unsplit planes' scores and
rej exactly and the same certificate (it only regroups the same fp32
values); ids may differ only among scores tied with the R-th plane.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import flat_kernels as fk
from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
from cuvs_rag_tpu_torch.utils.compare import compare_planes

torch.set_num_threads(1)


def _same_planes(a, b):
    """Planes (scores (Q, R, W), ids (Q, R, W), rej (Q, W)) `a` equal `b`:
    scores and rej exactly, ids as sets per class above the R-th plane's
    value and as counts at it (ties there may resolve either way)."""
    (sa, ia, ra), (sb, ib, rb) = a, b
    assert torch.equal(sa, sb) and torch.equal(ra, rb)
    q, r, w = sa.shape
    for qq in range(q):
        for c in range(w):
            edge = sa[qq, -1, c]
            above_a = sa[qq, :, c] > edge
            above_b = sb[qq, :, c] > edge
            assert sorted(ia[qq, above_a, c].tolist()) \
                == sorted(ib[qq, above_b, c].tolist())
            assert int((sa[qq, :, c] == edge).sum()) \
                == int((sb[qq, :, c] == edge).sum())


def _tied_corpus(n, d, seed):
    """Small-integer rows, a third of them repeated: exact, heavily tied
    scores whatever the order of the adds."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    x[n // 3: 2 * n // 3] = x[: 2 * n // 3 - n // 3]
    q = rng.integers(-2, 3, (5, d)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(q)


@pytest.mark.parametrize("n_splits", [1, 2, 7])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_flat_split_then_merge_equals_unsplit(n_splits, metric):
    """K3's tiles cut into S runs, each selected alone and merged, give the
    unsplit planes, rej and certificate, with ties planted."""
    x, q = _tied_corpus(3000, 16, 1)
    args = (x, (x * x).sum(1), q, 3000)
    for kw in (dict(k=100, tile_c=128), dict(k=60, tile_c=32, r_planes=2)):
        kw = dict(kw, metric=metric)
        one = fk.flat_topk_large_plain(*args, **kw, planes=True)
        split = fk.flat_topk_large_plain(*args, **kw, planes=True,
                                         n_splits=n_splits)
        _same_planes(split, one)
        k = kw["k"]
        assert torch.equal(fk.finish_large(*split, k)[2],
                           fk.finish_large(*one, k)[2])
        assert torch.equal(
            fk.flat_topk_large_plain(*args, **kw, n_splits=n_splits)[0],
            fk.flat_topk_large_plain(*args, **kw)[0])


def _ragged_windows(seed, d=16, window=256):
    """A sorted layout of small-integer rows with lists of 0 to window + 40
    rows, and 6 queries probing 5 lists each."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 1, 31, 128, 129, 200, window, window + 40])
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]]) + 3
    cap = int(offs[-1] + counts[-1] + 5)
    x = torch.from_numpy(rng.integers(-2, 3, (cap, d)).astype(np.float32))
    x[100:200] = x[:100]
    probes = np.stack([rng.permutation(len(counts))[:5] for _ in range(6)])
    q = torch.from_numpy(rng.integers(-2, 3, (6, d)).astype(np.float32))
    return (x, (x * x).sum(1), torch.ones(cap), q,
            torch.from_numpy(offs[probes].astype(np.int32)),
            torch.from_numpy(counts[probes].astype(np.int32)), window)


@pytest.mark.parametrize("n_splits", [1, 2, 7])
@pytest.mark.parametrize("n_sub", [1, 4])
def test_ivf_split_then_merge_equals_unsplit(n_splits, n_sub):
    """K5's (probe, sub-window) tiles cut into S runs and merged give the
    unsplit planes, rej and certificate: empty lists, counts past the
    window, ties planted."""
    *args, window = _ragged_windows(2)
    for k, r in ((40, 0), (50, 2)):
        kw = dict(k=k, window=window, metric="sqeuclidean", n_sub=n_sub,
                  r_planes=r)
        one = ik.ivf_scan_large_plain(*args, **kw, planes=True)
        split = ik.ivf_scan_large_plain(*args, **kw, planes=True,
                                        n_splits=n_splits)
        _same_planes(split, one)
        assert torch.equal(fk.finish_large(*split, k)[2],
                           fk.finish_large(*one, k)[2])


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3), st.integers(1, 12), st.integers(1, 5),
       st.integers(1, 4), st.integers(1, 9), st.integers(0, 2 ** 31 - 1))
def test_merge_of_any_split_keeps_the_certificate(q, nt, w, r, s, seed):
    """For any (Q, T, W) scores drawn from a few values (ties everywhere,
    -inf slots included) and any split count, the merged planes and rej
    equal the unsplit ones (ids up to ties at the R-th plane)."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.choice(
        np.array([-np.inf, -1.0, 0.0, 0.5, 2.0], np.float32), (q, nt, w)))
    ids = torch.arange(q * nt * w, dtype=torch.int32).view(q, nt, w)
    _same_planes(fk.topr_planes_plain(vals, ids, r, s),
                 fk.topr_planes_plain(vals, ids, r, 1))


def test_merge_folds_displaced_values_into_rej():
    """Two splits whose best values together overflow R planes: the merge
    keeps the R best and rej becomes the best value it displaced, above
    either split's own rej."""
    part_s = torch.tensor([[[[9.0], [5.0]]], [[[8.0], [7.0]]]])  # (2, 1, 2, 1)
    part_i = torch.tensor([[[[1], [2]]], [[[3], [4]]]], dtype=torch.int32)
    part_rej = torch.tensor([[[1.0]], [[6.0]]])
    s, i, rej = fk.topr_merge_plain(part_s, part_i, part_rej)
    assert s.flatten().tolist() == [9.0, 8.0]
    assert i.flatten().tolist() == [1, 3]
    assert rej.flatten().tolist() == [7.0]


# ------------------------------------------------------------ K3's plan ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [16, 42, 64, 384, 1024, 2048, 4096])
@pytest.mark.parametrize("n_q", [1, 3, 16, 17, 40])
@pytest.mark.parametrize("k,tile_c", [(33, 1024), (300, 128), (2000, 1024),
                                      (8192, 1024), (33, 16), (8192, 128),
                                      (33, 8192)])
def test_topr_plan_takes_every_call_and_fits(dtype, d, n_q, k, tile_c):
    """Every (k, tile_c, dtype, d) the wrapper accepts gets a plan; the
    ring takes exactly K1's ring depths whose planes fit beside it; a
    plan's planes fit the block's share of the SM, as many queries a block
    as fit (at most 16) and the fewest passes over the corpus, two blocks
    an SM on a tie."""
    try:
        r = fk._large_args(k, tile_c, 0)
    except ValueError:
        return  # not accepted today either
    n_tiles = -(-1_000_000 // tile_c)
    route, qpb, id_bytes, bps = fk.topr_plan(n_q, r, d, dtype, n_tiles)
    assert 1 <= qpb <= min(16, n_q)
    if route == "cores":
        assert (id_bytes, bps) == (4, fk._BLOCKS_PER_SM)
        assert qpb == min(16, n_q, fk._PLANE_SMEM // (r * 128 * 8))
        if fk.exact_route(dtype, d) != "cores":  # planes fit no ring block
            room = build.MAX_SMEM - fk._ring_bytes(dtype, d)
            assert room < r * 128 * (4 + (2 if n_tiles <= 65535 else 4))
        return
    assert route == fk.exact_route(dtype, d)
    assert id_bytes == (2 if n_tiles <= 65535 else 4)
    entry = r * 128 * (4 + id_bytes)

    def fit(blocks):
        budget = min(build.MAX_SMEM,
                     build.SM_SMEM // blocks - build.BLOCK_RESERVED)
        return min(16, n_q, (budget - fk._ring_bytes(dtype, d)) // entry)

    assert qpb == fit(bps)
    assert fk._ring_bytes(dtype, d) + qpb * entry <= min(
        build.MAX_SMEM, build.SM_SMEM // bps - build.BLOCK_RESERVED)
    passes = {b: math.ceil(n_q / fit(b)) if fit(b) >= 1 else math.inf
              for b in (1, 2)}
    assert passes[bps] == min(passes.values())
    if passes[2] == passes[1]:
        assert bps == 2


def test_topr_plan_at_the_main_path():
    """At 6.29M x 384 bf16, k = 2,000 (R = 12, 6,143 tiles of 1,024): one
    query takes two blocks an SM with 2-byte ids; 16 queries take one
    block an SM with all 16 (144 KB of planes), where two blocks an SM
    would hold 4 and read the corpus four times."""
    r = fk.default_r_planes(2000, 1024)
    assert r == 12
    tiles = -(-6_290_000 // 1024)
    bf16 = torch.bfloat16
    assert fk.topr_plan(1, r, 384, bf16, tiles) == ("ring", 1, 2, 2)
    assert fk.topr_plan(16, r, 384, bf16, tiles) == ("ring", 16, 2, 1)
    assert fk.topr_plan(16, r, 384, bf16, tiles, 2) == ("ring", 4, 2, 2)
    assert fk.topr_plan(1, r, 384, bf16, tiles, 1) == ("ring", 1, 2, 1)
    assert fk.topr_plan(16, r, 384, bf16, 70_000)[2] == 4
    assert fk.topr_plan(16, r, 42, bf16, tiles)[0] == "cores"


@pytest.mark.parametrize("qpb", [1, 4, 16])
@pytest.mark.parametrize("n_q", [1, 16, 40])
def test_class_splits_with_query_blocks_stay_in_one_wave(n_q, qpb):
    for bps in (1, 2):
        per, n_splits = fk._class_splits(6_290_000, n_q, 1024, 132, bps, qpb)
        blocks = -(-n_q // qpb) * 8
        assert n_splits == 1 or n_splits * blocks <= bps * 132
        assert (n_splits - 1) * per < 6143 <= n_splits * per


# ------------------------------------------------------------ K5's plan ---


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("n_q", [1, 2, 16, 17])
@pytest.mark.parametrize("window,n_sub", [(100, 1), (128, 1), (2048, 1),
                                          (2048, 16), (1280, 10)])
@pytest.mark.parametrize("n_probe", [1, 20, 64])
def test_k5_plan_covers_each_tile_once_in_one_wave(sm_count, n_q, window,
                                                   n_sub, n_probe):
    r = 10
    route, per, n_splits = ik.k5_plan(n_q, window, n_sub, n_probe, r, 384,
                                      torch.bfloat16, sm_count)
    tiles = n_probe * n_sub
    assert route == "ring" and per >= 1
    assert (n_splits - 1) * per < tiles <= n_splits * per
    blocks = n_q * -(-(window // n_sub) // 128)
    assert n_splits == 1 or n_splits * blocks <= ik._K5_BLOCKS_PER_SM * sm_count


def test_k5_plan_at_the_main_path():
    """Window 2,048, 20 probes, R = 10: one query runs 16 chunks x 10
    splits of 2 probes (160 blocks); 16 queries 256 blocks of all 20;
    depths the ring does not take keep the older kernel, one split."""
    assert ik.k5_plan(1, 2048, 1, 20, 10, 384, torch.bfloat16) == ("ring", 2, 10)
    assert ik.k5_plan(16, 2048, 1, 20, 10, 384, torch.bfloat16) == ("ring", 20, 1)
    assert ik.k5_plan(1, 2048, 1, 20, 10, 42, torch.bfloat16) == ("cores", 20, 1)
    assert ik.k5_plan(1, 2048, 1, 20, 10, 40, torch.int8) == ("cores", 20, 1)


def _old_large_k_config(window, dim, k):
    """large_k_config as it stood before the ring: 96 KB of query and
    planes."""
    if not 32 < k <= 8192 or window < 1:
        return None
    r = fk.default_r_planes(k, window)
    if k > r * window or r > 64:
        return None
    if dim * 4 + r * 128 * 8 > 96 * 1024:
        return None
    return 1, r


@pytest.mark.parametrize("dim", [8, 64, 128, 384, 768, 1024, 2048, 4096,
                                 8192, 16384])
def test_large_k_config_admits_what_it_admitted(dim):
    """Every (window, dim, k) admitted before the ring is admitted with the
    same (n_sub, R), and every admitted block fits the card."""
    for window in (1, 100, 128, 512, 1280, 2048, 4096, 8192):
        for k in (1, 32, 33, 100, 300, 1000, 2000, 4000, 8192, 8193):
            old = _old_large_k_config(window, dim, k)
            new = ik.large_k_config(window, dim, k)
            if old is not None:
                assert new == old
            if new is not None:
                assert ik._k5_smem(dim, new[1]) <= 227 * 1024


# ------------------------------------------------------- the planes hold ---


def _planes_case():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4000, 32)).astype(np.float32))
    args = (x, (x * x).sum(1), x[:3] + 0.1, 4000)
    kw = dict(k=200, metric="sqeuclidean", tile_c=128)

    def bound_fn(rows):
        return fk.flat_rounding_bound(*args, metric="sqeuclidean", rows=rows)

    return fk.flat_topk_large_plain(*args, **kw, planes=True), bound_fn


def test_compare_planes_passes_the_plain_planes():
    pp, bound_fn = _planes_case()
    worst, slack = compare_planes(pp, pp, bound_fn)
    assert worst == 0.0 and slack.shape == pp[2].shape and (slack > 0).all()


@pytest.mark.parametrize("fault", ["score", "id", "duplicate", "rej", "empty"])
def test_compare_planes_catches_planted_faults(fault):
    """A hold must hold something: a score off by 1e-3, a row swapped for
    another of its class, a row held twice, a rej off by 1e-3, and a slot
    emptied each fail."""
    pp, bound_fn = _planes_case()
    ks, ki, kr = (t.clone() for t in pp)
    if fault == "score":
        ks[0, 0, 5] += 1e-3
    elif fault == "id":
        ki[0, 0, 5] = ki[0, -1, 5]
        ki[0, -1, 5] = ki[0, 0, 5] + 128 * 3
    elif fault == "duplicate":
        ki[1, 1, 7] = ki[1, 0, 7]
        ks[1, 1, 7] = ks[1, 0, 7]
    elif fault == "rej":
        kr[2, 9] += 1e-3
    else:
        ks[0, 0, 5] = -float("inf")
    with pytest.raises(AssertionError):
        compare_planes((ks, ki, kr), pp, bound_fn)
