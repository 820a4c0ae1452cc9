"""The plain versions of the port's flat-search kernels (K1 exact, K2
sketch, K3 certified large-k) against the JAX package's Pallas kernels run
in interpret mode, on the same seeded numpy inputs. On a CPU tensor each
wrapper runs its plain version, so these calls are the wrappers' CPU path.

Tolerances:
  * K1 scores rtol/atol 1e-3: the Pallas exact kernel's fused selection
    truncates 11 mantissa bits of each score (<= 2^-12 relative); the port
    keeps exact fp32. Ids agree up to swaps among scores tied within it.
  * K2 and K3 keep exact fp32 scores on both sides: rtol/atol 1e-5
    (fp32 sums in another order).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.ops import pallas_flat
from cuvs_rag_tpu.utils.config import FlatParams
from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import flat_kernels as fk
from torch_parity import compare_topk, to_torch

torch.set_num_threads(1)

N, D, Q = 2048, 64, 10
TILE = 1024


def _data(seed, n=N, d=D, q=Q):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((q, d)).astype(np.float32))


def _index(corpus, dtype, tile_n=TILE):
    """A JAX-built index, and its arrays as torch tensors."""
    ix = jflat.build(FlatParams(dtype=dtype, tile_n=tile_n), jnp.asarray(corpus))
    return ix, (to_torch(ix.vectors), to_torch(ix.sqnorms),
                int(ix.n_valid), to_torch(ix.scales))


def _both_exact(ix, targs, queries, k, metric):
    ref = pallas_flat.flat_topk_pallas(
        ix.vectors, ix.sqnorms, jnp.asarray(queries), ix.n_valid, ix.scales,
        k=k, metric=metric, tile_q=8, tile_c=TILE, interpret=True,
    )
    v, sq, nv, sc = targs
    got = fk.flat_topk_exact(v, sq, torch.from_numpy(queries), nv, sc,
                             k=k, metric=metric)
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_exact_matches_pallas(dtype, metric):
    corpus, queries = _data(1)
    ix, targs = _index(corpus, dtype)
    (s, i), (rs, ri) = _both_exact(ix, targs, queries, 5, metric)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    compare_topk(s, i, rs, ri, rtol=1e-3, atol=1e-3)


def test_exact_respects_n_valid_and_pads_k():
    corpus, _ = _data(2, d=32)
    queries = corpus[:2].copy()
    corpus[1200:] = queries[0]  # rows >= n_valid duplicate the query
    cj = jnp.asarray(corpus)
    sq = jnp.sum(cj * cj, axis=1)
    for nv, k in ((1200, 3), (4, 8)):  # k > live rows: surplus slots -1
        ref = pallas_flat.flat_topk_pallas(
            cj, sq, jnp.asarray(queries), jnp.int32(nv), k=k,
            metric="sqeuclidean", tile_q=8, tile_c=TILE, interpret=True,
        )
        got = fk.flat_topk_exact(torch.from_numpy(corpus), to_torch(sq),
                                 torch.from_numpy(queries), nv, k=k,
                                 metric="sqeuclidean")
        assert got[1].max() < nv
        compare_topk(*got, *ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_exact_skips_tombstoned_rows(metric):
    corpus, queries = _data(3)
    ix, _ = _index(corpus, "float32")
    ix = jflat.delete(ix, np.arange(0, N, 3))
    targs = (to_torch(ix.vectors), to_torch(ix.sqnorms), int(ix.n_valid),
             to_torch(ix.scales))
    (s, i), (rs, ri) = _both_exact(ix, targs, queries, 8, metric)
    assert not np.isin(i.numpy(), np.arange(0, N, 3)).any()
    compare_topk(s, i, rs, ri, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,int8_compute", [
    ("float32", False), ("bfloat16", False), ("int8", True),
])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_sketch_matches_pallas(dtype, int8_compute, metric):
    """Same column classes (row mod tile_c), same earliest-row tie rule, so
    the ids equal the Pallas sketch's, not just the exact top-k's."""
    corpus, queries = _data(4, n=4096, q=16)
    ix, (v, sq, nv, sc) = _index(corpus, dtype)
    rs, ri = pallas_flat.flat_topk_pallas(
        ix.vectors, ix.sqnorms, jnp.asarray(queries), ix.n_valid, ix.scales,
        k=5, metric=metric, tile_q=8, tile_c=TILE, mode="sketch",
        int8_compute=int8_compute, interpret=True,
    )
    s, i = fk.flat_topk_sketch(v, sq, torch.from_numpy(queries), nv, sc, k=5,
                               metric=metric, tile_c=TILE,
                               int8_compute=int8_compute)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)


def test_sketch_respects_n_valid():
    corpus, _ = _data(5, d=32)
    queries = corpus[:2].copy()
    corpus[1200:] = queries[0]
    s, i = fk.flat_topk_sketch(
        torch.from_numpy(corpus), (torch.from_numpy(corpus) ** 2).sum(1),
        torch.from_numpy(queries), 1200, k=3, metric="sqeuclidean",
        tile_c=TILE,
    )
    assert i.max() < 1200


def _large_ref(corpus, queries, k, metric, tile_c=TILE, n_valid=None,
               sqnorms=None, scales=None):
    cj = jnp.asarray(corpus)
    sq = jnp.sum(cj * cj, axis=1) if sqnorms is None else sqnorms
    nv = len(corpus) if n_valid is None else n_valid
    return pallas_flat.flat_topk_large(
        cj, sq, jnp.asarray(queries), jnp.asarray(nv, jnp.int32), scales,
        k=k, metric=metric, tile_c=tile_c, interpret=True,
    )


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("k", [100, 600])
def test_large_matches_pallas(metric, k):
    corpus, queries = _data(17, n=4096, q=12)
    rs, ri, rc = _large_ref(corpus, queries, k, metric)
    s, i, c = fk.flat_topk_large(
        torch.from_numpy(corpus), (torch.from_numpy(corpus) ** 2).sum(1),
        torch.from_numpy(queries), 4096, k=k, metric=metric,
    )
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    assert bool(c.all()), "random data must certify at the default R"
    compare_topk(s, i, rs, ri, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_large_split_emulation_matches_pallas(metric):
    """The card's structure, K3's tiles in 7 splits each selected alone and
    merged (`topr_planes_plain`), against the Pallas kernel that walks
    them in one pass: the same certificate and top-k."""
    corpus, queries = _data(17, n=7 * TILE, q=12)
    rs, ri, rc = _large_ref(corpus, queries, 600, metric)
    s, i, c = fk.flat_topk_large_plain(
        torch.from_numpy(corpus), (torch.from_numpy(corpus) ** 2).sum(1),
        torch.from_numpy(queries), 7 * TILE, k=600, metric=metric,
        tile_c=TILE, n_splits=7)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    compare_topk(s, i, rs, ri, rtol=1e-5, atol=1e-5)


def test_large_certificate_fails_on_class_stuffed_corpus():
    """All true top-k in ONE residue class (> R members): neither the
    reference nor the port can be exact there, and both must say so."""
    _, queries = _data(17, n=8, q=1)
    k = 64
    r = fk.default_r_planes(k, TILE)
    assert r == pallas_flat.default_r_planes(k, TILE)
    n_adv = (k + r + 8) * TILE
    corpus = np.random.default_rng(3).standard_normal((n_adv, D)).astype(np.float32)
    for m in range(k + r + 4):
        corpus[7 + m * TILE] = queries[0] + 1e-3 * m
    _, _, rc = _large_ref(corpus, queries, k, "sqeuclidean")
    _, _, c = fk.flat_topk_large(
        torch.from_numpy(corpus), (torch.from_numpy(corpus) ** 2).sum(1),
        torch.from_numpy(queries), n_adv, k=k, metric="sqeuclidean",
    )
    assert not bool(rc[0]) and not bool(c[0])


def test_large_skips_deleted_and_pad_rows():
    corpus, queries = _data(17, n=4000, q=12)
    ix = jflat.build(FlatParams(dtype="float32", tile_n=1024), jnp.asarray(corpus))
    gone = np.arange(0, 4000, 5)
    ix = jflat.delete(ix, gone)
    assert ix.size == 4096 and int(ix.n_valid) == 4000  # 96 pad rows
    rs, ri, rc = pallas_flat.flat_topk_large(
        ix.vectors, ix.sqnorms, jnp.asarray(queries), ix.n_valid, ix.scales,
        k=150, metric="sqeuclidean", interpret=True,
    )
    s, i, c = fk.flat_topk_large(
        to_torch(ix.vectors), to_torch(ix.sqnorms), torch.from_numpy(queries),
        4000, to_torch(ix.scales), k=150, metric="sqeuclidean",
    )
    assert bool(c.all()) and bool(np.all(rc))
    assert not np.isin(i.numpy(), gone).any()
    compare_topk(s, i, rs, ri, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    corpus, queries = _data(6, n=64, q=2)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    sq = (c ** 2).sum(1)
    with pytest.raises(ValueError):
        fk.flat_topk_exact(c, sq, q, 64, k=33, metric="sqeuclidean")
    with pytest.raises(ValueError):
        fk.flat_topk_exact(c, sq, q[:, :8], 64, k=3, metric="sqeuclidean")
    with pytest.raises(ValueError):
        fk.flat_topk_sketch(c, sq, q, 64, k=3, metric="sqeuclidean",
                            tile_c=64, int8_compute=True)  # needs int8 rows
    with pytest.raises(ValueError):
        fk.flat_topk_exact(c, sq, q, 65, k=3, metric="sqeuclidean")
    # the CPU path launches nothing
    assert build.launches["flat_exact_topk"] == 0
    assert build.launches["flat_exact_wide_topk"] == 0


# ------------------------------------------- K1's rounding bound ----------
# The card's K1 multiplies 16-deep steps on the tensor cores into a running
# fp32 sum whose adds truncate. The CPU cannot run that kernel, so what is
# held here is the bound the card run holds it to: it equals its fp64
# definition, a numpy emulation of the kernel's order of operations stays
# inside it, and faults a kernel could have fall far outside it.


def _stored(dtype, seed, n=300, d=96, q=5):
    """(storage tensor, sqnorms, queries fp32, scales or None) of unit rows
    with noisy copies of the first rows as queries."""
    from cuvs_rag_tpu_torch.ops import distance as dist_ops

    corpus, queries = _data(seed, n=n, d=d, q=q)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:q] + 0.05 * queries
    x = torch.from_numpy(corpus)
    if dtype == "int8":
        x, scales = dist_ops.quantize_rows(x)
        sq = ((x.float() * scales[:, None]) ** 2).sum(1)
    else:
        x, scales = x.to(getattr(torch, dtype)), None
        sq = (x.float() ** 2).sum(1)
    return x, sq, torch.from_numpy(queries), scales


def _values(x, queries, scales):
    """fp64 numpy values of what the kernel multiplies: the stored rows,
    the queries cast to the scoring dtype, the scales."""
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    qv = queries.to(topk_ops.query_dtype(x.dtype)).double().numpy()
    sv = np.ones(x.shape[0]) if scales is None else scales.double().numpy()
    return x.double().numpy(), qv, sv


def _truncate_to_fp32(v):
    """fp64 -> fp32 rounding toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _emulate_tile(xv, qv, sv, sq, metric, *, drop_step=None, scale=True):
    """K1's tensor-core route in numpy: 16-deep steps of exact products
    summed into an fp32 accumulator with truncating adds, then the fp32
    epilogue mult * (acc * scale) - csq (no pad rows, no tombstones)."""
    acc = np.zeros((qv.shape[0], xv.shape[0]), np.float32)
    for step, k0 in enumerate(range(0, xv.shape[1], 16)):
        if step == drop_step:
            continue
        part = qv[:, k0:k0 + 16] @ xv[:, k0:k0 + 16].T
        acc = _truncate_to_fp32(acc.astype(np.float64) + part)
    mult = np.float32(2.0 if metric == "sqeuclidean" else 1.0)
    s32 = sv.astype(np.float32) if scale else np.ones_like(sv, np.float32)
    csq = sq.numpy() if metric == "sqeuclidean" else np.float32(0)
    return mult * (acc * s32[None, :]) - csq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_rounding_bound_matches_fp64_reference(dtype, metric):
    x, sq, queries, scales = _stored(dtype, 11)
    n, d = x.shape
    want, allowed = fk.flat_rounding_bound(x, sq, queries, n, scales,
                                           metric=metric)
    xv, qv, sv = _values(x, queries, scales)
    mult = 2.0 if metric == "sqeuclidean" else 1.0
    term = mult * sv[None, :] * (qv @ xv.T)
    ref = term - (sq.double().numpy()[None, :] if metric == "sqeuclidean" else 0)
    ref_allowed = (mult * np.abs(sv)[None, :] * 2 * d * 2.0 ** -24
                   * (np.abs(qv) @ np.abs(xv).T)
                   + 2.0 ** -24 * np.abs(term) + 2.0 ** -24 * np.abs(ref))
    np.testing.assert_allclose(want.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(allowed.numpy(), ref_allowed, rtol=1e-12)
    assert want.dtype == torch.float64 and allowed.shape == (5, n)
    # tight enough to hold something: far below the outer atol of 1e-3
    assert float(allowed.max()) < 1e-4
    # the same numbers at chosen rows only; ids < 0 are the caller's to skip
    rows = torch.tensor([[3, 0, n - 1], [7, 7, -1], [1, 2, 3], [9, 8, 7],
                         [0, -1, -1]], dtype=torch.int32)
    w, a = fk.flat_rounding_bound(x, sq, queries, n, scales, metric=metric,
                                  rows=rows)
    pick = rows.long().clamp(min=0)
    assert torch.equal(w, torch.gather(want, 1, pick))
    assert torch.equal(a, torch.gather(allowed, 1, pick))
    # the plain version is inside its own bound
    s, i = fk.flat_topk_exact(x, sq, queries, n, scales, k=10, metric=metric)
    w, a = fk.flat_rounding_bound(x, sq, queries, n, scales, metric=metric,
                                  rows=i)
    assert bool(((s.double() - w).abs() <= a).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_tile_order_emulation_stays_within_bound(dtype, metric):
    x, sq, queries, scales = _stored(dtype, 12)
    want, allowed = fk.flat_rounding_bound(x, sq, queries, x.shape[0], scales,
                                           metric=metric)
    got = _emulate_tile(*_values(x, queries, scales), sq, metric)
    ratio = np.abs(got - want.numpy()) / allowed.numpy()
    assert ratio.max() <= 1.0
    # truncation biases the sum, so the emulation really uses the bound
    assert ratio.max() > 1e-3


@pytest.mark.parametrize("fault", ["dropped_step", "swapped_query",
                                   "missing_scale"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_planted_faults_break_the_bound(fault, metric):
    """Each would pass the outer gate's atol of 1e-3 on some slots or all;
    none passes the rounding bound."""
    x, sq, queries, scales = _stored("int8", 13)
    want, allowed = fk.flat_rounding_bound(x, sq, queries, x.shape[0], scales,
                                           metric=metric)
    xv, qv, sv = _values(x, queries, scales)
    if fault == "dropped_step":
        got = _emulate_tile(xv, qv, sv, sq, metric, drop_step=3)
    elif fault == "swapped_query":
        got = _emulate_tile(xv, qv[[1, 0, 2, 3, 4]], sv, sq, metric)
    else:
        got = _emulate_tile(xv, qv, sv, sq, metric, scale=False)
    ratio = np.abs(got - want.numpy()) / allowed.numpy()
    assert ratio.max() > 10.0
    if fault == "swapped_query":  # only the two swapped rows are off
        assert ratio[2:].max() <= 1.0


# ---------------------------------------------- K1's routes and splits ----


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("n_q", [1, 16, 17, 25, 40, 100, 128, 129])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1_000_003, 6_290_000])
def test_exact_splits_cover_every_row_once(n, n_q, sm_count):
    for blocks_per_sm in (fk._RING_BLOCKS_PER_SM, fk._BLOCKS_PER_SM):
        per, n_splits = fk._exact_splits(n, n_q, sm_count, blocks_per_sm)
        assert per % fk._TC == 0 and per > 0 and n_splits >= 1
        # split s covers [s * per, min(n, (s + 1) * per)): all rows, once,
        # and no split is empty
        assert (n_splits - 1) * per < n <= n_splits * per
        q_tiles = -(-n_q // fk._TQ)
        want = -(-blocks_per_sm * sm_count // q_tiles)
        assert n_splits <= max(1, want)
        # one wave: never more blocks than the card holds at once (+ the
        # rounding of one query tile)
        assert n_splits * q_tiles < blocks_per_sm * sm_count + q_tiles
        # as even as whole tiles allow
        assert per - fk._TC < -(-n // max(1, min(want, -(-n // fk._TC))))


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 100, 102, 384, 400,
                               1024, 2048, 2064, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_exact_route_table(dtype, d):
    """bf16 and int8 rows take the tensor cores when a row is a whole number
    of 32-byte units; fp32 rows keep fp32 math, through the ring when a row
    is a whole number of 16-byte pieces; the query tile must fit."""
    row_bytes = d * {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    if d > 2048:
        want = "cores"
    elif dtype == torch.float32:
        want = "ring_fp32" if row_bytes % 16 == 0 else "cores"
    else:
        want = "ring" if row_bytes % 32 == 0 else "cores"
    assert fk.exact_route(dtype, d) == want
    assert fk.exact_route(dtype, d) == fk.exact_route(dtype, d)
    if dtype == torch.int8:
        with pytest.raises(ValueError):
            fk.exact_route(torch.float16, d)


_RING_DTYPES = [torch.bfloat16, torch.int8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [16, 32, 42, 384, 768, 2048, 4096])
@pytest.mark.parametrize("n_q", [1, 16, 17, 25, 100, 128, 129, 1000])
def test_exact_plan_covers_every_query_and_row_once(n_q, d, dtype):
    """K1's plan: passes x width cover the queries, none of the passes
    empty; splits of whole 128-row tiles cover the rows, none empty; the
    wide kernel exactly where the tensor-core ring takes the rows and the
    call has more than the crossover's queries, and then never more
    blocks than SMs unless a pass needs a block of its own."""
    for n, sm_count, k in itertools.product((1, 129, 1_000_003, 6_290_000),
                                            (1, 132), (1, 10, 32)):
        plan = fk.exact_plan(n, n_q, d, dtype, sm_count, k)
        assert plan == fk.exact_plan(n, n_q, d, dtype, sm_count, k)
        wide = (fk.exact_route(dtype, d) == "ring"
                and n_q > fk._NARROW_MAX_Q)
        assert (plan.route == "ring_wide") == wide
        if not wide:
            assert plan.route == fk.exact_route(dtype, d)
            assert (plan.width, plan.passes) == (fk._TQ, -(-n_q // fk._TQ))
        else:
            assert plan.width % 16 == 0
            assert plan.width <= fk._wide_width(d, dtype, k)
            assert plan.n_splits * plan.passes <= max(sm_count,
                                                      plan.passes)
        assert (plan.passes - 1) * plan.width < n_q
        assert n_q <= plan.passes * plan.width
        per, n_splits = plan.rows_per_split, plan.n_splits
        assert per % fk._TC == 0 and per > 0 and n_splits >= 1
        assert (n_splits - 1) * per < n <= n_splits * per


@pytest.mark.parametrize("dtype", _RING_DTYPES)
@pytest.mark.parametrize("n_q", [17, 25, 100, 128])
def test_exact_plan_reads_the_corpus_once_up_to_128_queries(n_q, dtype):
    """At D = 384 and k = 10 a call of 17 to 128 queries is one pass of the
    wide kernel, every SM a split: the corpus is read once."""
    plan = fk.exact_plan(6_286_775, n_q, 384, dtype, 132, 10)
    assert plan.route == "ring_wide" and plan.passes == 1
    assert plan.width == -(-n_q // 16) * 16 and plan.n_splits == 132


@pytest.mark.parametrize("dtype", _RING_DTYPES)
@pytest.mark.parametrize("n_q", [1, 2, 8, 15, 16])
def test_exact_plan_keeps_the_16_query_kernel_to_the_crossover(n_q, dtype):
    assert n_q <= fk._NARROW_MAX_Q
    plan = fk.exact_plan(6_286_775, n_q, 384, dtype, 132, 10)
    assert plan.route == "ring" and plan.width == fk._TQ


@pytest.mark.parametrize("dtype", _RING_DTYPES)
def test_wide_kernel_fits_shared_memory_at_every_depth(dtype):
    """At every depth the wide route takes and every k, the widest pass
    fits a block's shared memory, one wider would not (or is the most the
    kernel takes), and at least 16 queries fit; the CLI's 100 x 768 is two
    passes."""
    step = 16 if dtype == torch.bfloat16 else 32
    for d, k in itertools.product(range(step, fk.RING_MAX_DIM + 1, step),
                                  (1, 10, 32)):
        assert fk.exact_route(dtype, d) == "ring"
        width = fk._wide_width(d, dtype, k)
        assert 16 <= width <= fk._WIDE_MAX_N and width % 16 == 0
        assert fk._wide_smem(width, d, dtype, k) <= build.MAX_SMEM
        assert (width == fk._WIDE_MAX_N
                or fk._wide_smem(width + 16, d, dtype, k) > build.MAX_SMEM)
    assert fk.exact_plan(2_000_000, 100, 768, torch.bfloat16, 132,
                         10).passes == 2


def test_wide_plan_mirrors_the_kernel_source():
    """The planner's copy of the wide kernel's sizes is the source's:
    csrc/flat_topk.cu's constants, and the shared memory its
    wide_smem_bytes adds up, term by term."""
    from cuvs_rag_tpu_torch.kernels import build

    source = (build.CSRC / "flat_topk.cu").read_text()
    for name, value in (("WIDE_MAX_N", fk._WIDE_MAX_N),
                        ("WIDE_ROWS", fk._WIDE_ROWS),
                        ("WIDE_STAGES", fk._WIDE_STAGES),
                        ("WIDE_CHUNK", fk._WIDE_CHUNK),
                        ("WIDE_SCORE_PITCH", fk._WIDE_SCORE_PITCH),
                        ("WIDE_ALIGN", fk._WIDE_ALIGN)):
        assert f"constexpr int {name} = {value};" in source
    assert ("return WIDE_ALIGN + panels * n * 128 + WIDE_STAGES * "
            "WIDE_STAGE_BYTES +\n         n * (WIDE_SCORE_PITCH + 3) * 4 + "
            "WIDE_STAGES * 2 * 8 + n * k * 8;") in source
    # the two halves of a pass are each a product's N: multiples of 8
    assert "const int n = (width + 15) / 16 * 16;" in source


# ---------------------------------------------- K2's routes and splits ----


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 42, 64, 96, 384, 1024,
                               1056, 2048, 2080])
@pytest.mark.parametrize("dtype,int8_compute", [
    (torch.float32, False), (torch.bfloat16, False), (torch.int8, False),
    (torch.int8, True)])
def test_sketch_route_table(dtype, int8_compute, d):
    """K2 takes K1's ring where K1 does (tensor cores for bf16 and int8 rows
    of whole 32-byte units, fp32 FMAs for fp32 rows of whole 16-byte
    pieces, a query tile that fits), int8 x int8 under the same rule on
    the int8 product; every other depth keeps the older kernel."""
    row_bytes = d * {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    if d > 2048:
        want = "cores"
    elif dtype == torch.float32:
        want = "ring_fp32" if row_bytes % 16 == 0 else "cores"
    elif row_bytes % 32:
        want = "cores"
    else:
        want = "ring_int8" if int8_compute else "ring"
    assert fk.sketch_route(dtype, d, int8_compute) == want
    with pytest.raises(ValueError):
        fk.sketch_route(torch.bfloat16, d, True)  # int8 queries need int8 rows


def _sketch_walk(n, w, per, n_splits):
    """sketch_ring_kernel's row walk, as its index arithmetic forms it:
    {(class chunk c0, split): [(first row, live rows) of each tile, in the
    order the block streams them]}."""
    out = {}
    for c0 in range(0, w, fk._TC):
        n_class = min(fk._TC, w - c0)
        tiles_all = -(-(n - c0) // w) if n > c0 else 0
        for s in range(n_splits):
            j0 = s * per
            tiles = range(j0, max(j0, min(tiles_all, j0 + per)))
            out[(c0, s)] = [(j * w + c0, min(n_class, n - (j * w + c0)))
                            for j in tiles]
    return out


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("n_q", [1, 16, 40])
@pytest.mark.parametrize("w", [1, 100, 128, 130, 2048])
@pytest.mark.parametrize("n", [1, 127, 2049, 100_003, 6_290_000])
def test_class_splits_cover_every_class_tile_once(n, w, n_q, sm_count):
    """K2's split plan, by both routes: every row of the corpus is streamed
    by exactly one block of each query tile, each block walks its tiles in
    ascending row order (the strict > of its running best then keeps the
    earliest row of a tie), the splits of a class chunk follow each other
    in row order (the merge reads them so), and the ring routes run in one
    wave of two blocks an SM."""
    for blocks_per_sm in (fk._RING_BLOCKS_PER_SM, fk._BLOCKS_PER_SM):
        per, n_splits = fk._class_splits(n, n_q, w, sm_count, blocks_per_sm)
        n_tiles = -(-n // w)
        assert per >= 1 and (n_splits - 1) * per < n_tiles <= n_splits * per
        blocks = -(-n_q // fk._TQ) * -(-w // fk._TC)
        assert n_splits == 1 or n_splits * blocks <= blocks_per_sm * sm_count
        if n > 200_000:
            continue  # the walk below is for corpora small enough to list
        walk = _sketch_walk(n, w, per, n_splits)
        rows = []
        for c0 in range(0, w, fk._TC):
            last = -1
            for s in range(n_splits):
                for row0, live in walk[(c0, s)]:
                    assert row0 > last and live >= 1  # ascending, never empty
                    last = row0
                    rows.append(np.arange(row0, row0 + live))
        rows = np.concatenate(rows)
        assert rows.size == n
        assert np.array_equal(np.sort(rows), np.arange(n))
