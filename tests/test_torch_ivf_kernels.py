"""The plain versions of the port's IVF scan kernels (K4 probed top-k, K5
certified large-k) against the JAX package's Pallas kernels run in
interpret mode, on JAX-built IVF-Flat indexes loaded through the port's
index/io.py, and on a hand-made layout with empty and short lists. On a
CPU tensor each wrapper runs its plain version, so these calls are the
wrappers' CPU path.

Tolerance: both sides keep exact fp32 scores (the Pallas K4/K5 select with
full-precision keys) and sum exact products of the same operands in
another order, so scores agree to rtol 1e-5 / atol 1e-4 (scores reach
~1e2 here); positions agree up to swaps among scores tied with the k-th.
Certificate flags must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf_flat
from cuvs_rag_tpu.ops import ivf as jivf
from cuvs_rag_tpu.ops import pallas_ivf
from cuvs_rag_tpu.utils.config import IVFFlatParams
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
from torch_parity import compare_topk, to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
NPROBE = 6


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """JAX-built indexes (16 lists over 3,000 x 128 blobs, every 37th row
    deleted) per storage dtype, each with the port's load of its npz."""
    rng = np.random.default_rng(21)
    cent = rng.standard_normal((24, 128)).astype(np.float32)
    corpus = (cent[rng.integers(0, 24, 3000)]
              + 0.5 * rng.standard_normal((3000, 128))).astype(np.float32)
    queries = corpus[:9] + 0.1 * rng.standard_normal((9, 128)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        ix = jivf_flat.build(IVFFlatParams(n_lists=16, dtype=dtype),
                             jnp.asarray(corpus))
        ix = jivf_flat.delete(ix, np.arange(0, 3000, 37))
        path = str(tmp_path_factory.mktemp("ivf") / f"{dtype}.npz")
        jio.save_index(path, ix)
        out[dtype] = (ix, tio.load_index(path, device="cpu"))
    return out, queries


def _probe_args(jix, queries, metric, nprobe=NPROBE):
    """Probes, offsets, counts and coarse_ip (int8) as JAX arrays."""
    cs, probes = jivf.probe_lists(jnp.asarray(queries), jix.centroids,
                                  jix.centroid_sqnorms, nprobe, metric)
    coarse = None
    if jix.vectors.dtype == jnp.int8:
        coarse = cs + jix.centroid_sqnorms[probes] \
            if metric == "sqeuclidean" else cs
    return (jix.list_offsets[probes], jix.list_counts[probes], coarse)


def _layout_args(tix):
    return tix.vectors, tix.sqnorms, tix.scales


def _both_k4(jlay, tlay, queries, offs, cnts, coarse, window, k, metric,
             n_sub=1):
    ref = pallas_ivf.ivf_scan_pallas(
        *jlay, jnp.asarray(queries), offs, cnts, k=k, nprobe=offs.shape[1],
        window=window, metric=metric, coarse_ip=coarse, n_sub=n_sub,
        interpret=True)
    got = ik.ivf_scan(*tlay, torch.from_numpy(queries), to_torch(offs),
                      to_torch(cnts), k=k, window=window, metric=metric,
                      coarse_ip=None if coarse is None else to_torch(coarse))
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_k4_plain_matches_pallas(indexes, dtype, metric):
    ixs, queries = indexes
    jix, tix = ixs[dtype]
    offs, cnts, coarse = _probe_args(jix, queries, metric)
    (s, pos), (rs, rpos) = _both_k4(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, 10, metric)
    assert s.dtype == torch.float32 and pos.dtype == torch.int32
    compare_topk(s, pos, rs, rpos, **TOL)
    # no deleted row comes back
    rid = tix.row_ids[pos.clamp(min=0).long()]
    assert (rid[pos >= 0] >= 0).all()


def test_k4_equals_pallas_sub_windows(indexes):
    """The TPU's n_sub split reads the same rows: K4 (which has no split)
    matches the Pallas kernel with 128-row sub-windows as well."""
    ixs, queries = indexes
    jix, tix = ixs["bfloat16"]
    n_sub = jix.max_list_size // 128
    assert n_sub > 1
    offs, cnts, coarse = _probe_args(jix, queries, "sqeuclidean")
    got, ref = _both_k4((jix.vectors, jix.sqnorms, jix.scales),
                        _layout_args(tix), queries, offs, cnts, coarse,
                        jix.max_list_size, 32, "sqeuclidean", n_sub=n_sub)
    compare_topk(*got, *ref, **TOL)


def _both_k5(jlay, tlay, queries, offs, cnts, coarse, window, metric, **kw):
    ref = pallas_ivf.ivf_scan_pallas_large(
        *jlay, jnp.asarray(queries), offs, cnts, nprobe=offs.shape[1],
        window=window, metric=metric, coarse_ip=coarse, interpret=True, **kw)
    got = ik.ivf_scan_large(
        *tlay, torch.from_numpy(queries), to_torch(offs), to_torch(cnts),
        window=window, metric=metric,
        coarse_ip=None if coarse is None else to_torch(coarse), **kw)
    return got, ref


@pytest.mark.parametrize("dtype,metric,n_sub", [
    ("float32", "sqeuclidean", 1), ("bfloat16", "inner_product", 1),
    ("int8", "sqeuclidean", 1), ("int8", "inner_product", 3),
])
def test_k5_plain_matches_pallas(indexes, dtype, metric, n_sub):
    ixs, queries = indexes
    jix, tix = ixs[dtype]
    offs, cnts, coarse = _probe_args(jix, queries, metric)
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, metric, k=64, n_sub=n_sub)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    assert bool(cert.all())
    compare_topk(s, pos, rs, rpos, **TOL)
    # and certified rows are the exact top-k of the probed lists
    es, epos = ik.ivf_scan_plain(
        *_layout_args(tix), torch.from_numpy(queries), to_torch(offs),
        to_torch(cnts), k=64, window=jix.max_list_size, metric=metric,
        coarse_ip=None if coarse is None else to_torch(coarse))
    compare_topk(s, pos, es, epos, **TOL)


@pytest.mark.parametrize("n_splits", [2, 7])
def test_k5_split_emulation_matches_pallas(indexes, n_splits):
    """The card's structure, the probes in splits each selected alone and
    merged (`flat_kernels.topr_planes_plain`), against the Pallas kernel
    that walks every probe in one block: the same certificate and top-k,
    at the default planes and at two planes of 128-row sub-windows."""
    ixs, queries = indexes
    jix, tix = ixs["bfloat16"]
    offs, cnts, coarse = _probe_args(jix, queries, "sqeuclidean")
    for kw in (dict(k=64), dict(k=200, n_sub=jix.max_list_size // 128,
                                r_planes=2)):
        ref = pallas_ivf.ivf_scan_pallas_large(
            jix.vectors, jix.sqnorms, jix.scales, jnp.asarray(queries), offs,
            cnts, nprobe=offs.shape[1], window=jix.max_list_size,
            metric="sqeuclidean", coarse_ip=coarse, interpret=True, **kw)
        s, pos, cert = ik.ivf_scan_large_plain(
            *_layout_args(tix), torch.from_numpy(queries), to_torch(offs),
            to_torch(cnts), window=jix.max_list_size, metric="sqeuclidean",
            n_splits=n_splits, **kw)
        np.testing.assert_array_equal(cert.numpy(), np.asarray(ref[2]))
        compare_topk(s, pos, ref[0], ref[1], **TOL)


def test_k5_under_provisioned_certificate_matches(indexes):
    """Two planes of 128-row classes cannot hold k = 200 well: rows fail
    the certificate, and the flags and candidates equal the Pallas kernel's."""
    ixs, queries = indexes
    jix, tix = ixs["float32"]
    offs, cnts, coarse = _probe_args(jix, queries, "sqeuclidean")
    kw = dict(k=200, n_sub=jix.max_list_size // 128, r_planes=2)
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        (jix.vectors, jix.sqnorms, jix.scales), _layout_args(tix), queries,
        offs, cnts, coarse, jix.max_list_size, "sqeuclidean", **kw)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    assert not bool(cert.all())
    compare_topk(s, pos, rs, rpos, **TOL)


@pytest.fixture(scope="module")
def ragged_layout():
    """A layout with empty, one-row and short lists (hand-made labels)."""
    rng = np.random.default_rng(22)
    sizes = [0, 3, 130, 0, 257, 40, 1, 300]
    labels = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    n = labels.shape[0]
    x = rng.standard_normal((n, 128)).astype(np.float32)
    cap = jivf.capacity_for(n, len(sizes), 384)
    lay = jivf.build_layout(jnp.asarray(x), jnp.asarray(labels),
                            jnp.ones(n, bool), n_lists=len(sizes),
                            capacity=cap, max_list_size=384)
    probes = np.stack([rng.permutation(len(sizes))[:4] for _ in range(9)])
    probes[0] = [0, 1, 3, 6]  # two empty lists and four rows in all
    queries = x[rng.integers(0, n, 9)] + 0.1 * rng.standard_normal((9, 128))
    jlay = (lay.sorted_vectors, lay.sorted_sqnorms, lay.sorted_scales)
    return (jlay, tuple(to_torch(a) for a in jlay), queries.astype(np.float32),
            lay.list_offsets[probes], lay.list_counts[probes])


def test_k4_empty_and_short_lists(ragged_layout):
    jlay, tlay, queries, offs, cnts = ragged_layout
    got, ref = _both_k4(jlay, tlay, queries, offs, cnts, None, 384, 32,
                        "sqeuclidean")
    compare_topk(*got, *ref, **TOL)
    assert (got[1] == -1).any()  # some queries probe fewer than 32 rows


def test_k5_empty_and_short_lists(ragged_layout):
    jlay, tlay, queries, offs, cnts = ragged_layout
    (s, pos, cert), (rs, rpos, rcert) = _both_k5(
        jlay, tlay, queries, offs, cnts, None, 384, "inner_product", k=40,
        n_sub=3)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(rcert))
    compare_topk(s, pos, rs, rpos, **TOL)


def test_large_k_config_on_the_card():
    """The card's config: the class width is the whole window; at the main
    path's window 2,048 and k = 2,000 that is R = 10 planes."""
    assert ik.large_k_config(2048, 384, 2000) == (1, 10)
    assert ik.large_k_config(2048, 384, 32) is None  # K4's range
    assert ik.large_k_config(128, 384, 8192) is None  # R > 64
    r = ik.large_k_config(512, 768, 300)[1]
    assert r == pallas_ivf.default_r_planes(300, 512)


def test_wrappers_reject_bad_inputs(ragged_layout):
    _, tlay, queries, offs, cnts = ragged_layout
    q = torch.from_numpy(queries)
    o, c = to_torch(offs), to_torch(cnts)
    with pytest.raises(ValueError):
        ik.ivf_scan(*tlay, q, o, c, k=33, window=384, metric="sqeuclidean")
    with pytest.raises(ValueError):
        ik.ivf_scan(*tlay, q[:, :8], o, c, k=3, window=384,
                    metric="sqeuclidean")
    with pytest.raises(ValueError):
        ik.ivf_scan_large(*tlay, q, o, c, k=100, window=384,
                          metric="sqeuclidean", n_sub=5)
    with pytest.raises(ValueError):
        ik.ivf_scan_large(*tlay, q, o, c, k=2000, window=384,
                          metric="sqeuclidean", n_sub=3, r_planes=2)
    assert ik.ivf_scan.launches == 0 and ik.ivf_scan_large.launches == 0


# ------------------------------------------ K4's route and piece plan ----


@pytest.mark.parametrize("d", [4, 8, 12, 16, 40, 42, 64, 100, 384, 2048, 2064])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_ivf_route_table(dtype, d):
    """K4 streams windows through the ring where every window start is a
    16-byte boundary of the layout (rows of a multiple of 16 bytes) and the
    query fits beside the ring; other depths keep the older kernel."""
    row_bytes = d * {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    want = "ring" if row_bytes % 16 == 0 and d <= 2048 else "cores"
    assert ik.ivf_route(dtype, d) == want
    with pytest.raises(ValueError):
        ik.ivf_route(torch.float16, d)


def _piece_rows(count, window, per, c):
    """Window rows [start, stop) that block c of a probe scans, as the
    kernels bound them; start == stop where it reads nothing."""
    live = min(count, window)
    start = min(c * per, live)
    return start, min(live, start + per) if c * per < live else start


@pytest.mark.parametrize("pairs", [1, 20, 320, 5000])
@pytest.mark.parametrize("window", [1, 100, 128, 129, 1024, 2048, 2049])
@pytest.mark.parametrize("route,piece", [
    ("cores", None), ("ring", None), ("ring", 256), ("ring", 512),
    ("ring", 1024), ("ring", 0)])
def test_k4_pieces_cover_each_window_once(window, route, piece, pairs):
    """Every (query, probe) scans window rows [0, min(count, window)) once
    over its blocks, counts 0 and past the window included; blocks past the
    count read nothing; the ring's pieces are whole 128-row tiles."""
    per, n_pieces = ik.k4_pieces(window, route, pairs, 132, piece)
    assert n_pieces * per >= window > (n_pieces - 1) * per
    if route == "ring":
        assert per % 128 == 0
    for count in (0, 1, 31, 32, 127, 128, 129, 2047, window - 1, window,
                  window + 1, 5000):
        count = max(count, 0)
        seen = np.zeros(window, np.int64)
        for c in range(n_pieces):
            start, stop = _piece_rows(count, window, per, c)
            assert start <= stop
            if c * per >= min(count, window):
                assert start == stop  # a block past the count reads nothing
            seen[start:stop] += 1
        live = min(count, window)
        assert (seen[:live] == 1).all() and (seen[live:] == 0).all()


def test_k4_piece_rule():
    """The ring's piece: the largest that still gives 4 blocks an SM over
    the call's pairs, the smallest where none does; the main path's 16
    queries x 20 probes over a 2,048-row window take 1,024 rows, one query
    256."""
    assert ik.k4_pieces(2048, "ring", 320, 132) == (1024, 2)
    assert ik.k4_pieces(2048, "ring", 20, 132) == (256, 8)
    assert ik.k4_pieces(2048, "ring", 80, 132) == (256, 8)
    assert ik.k4_pieces(2048, "ring", 150, 132) == (512, 4)
    assert ik.k4_pieces(2048, "ring", 5000, 132) == (1024, 2)
    assert ik.k4_pieces(100, "ring", 5000, 132) == (1024, 1)
    for pairs in (1, 20, 320, 5000):
        per, n = ik.k4_pieces(2048, "ring", pairs, 132)
        assert per in ik._K4_PIECES
        bigger = [p for p in ik._K4_PIECES if p > per]
        assert all(pairs * -(-2048 // p) < 4 * 132 for p in bigger)
    assert ik.k4_pieces(2048, "cores", 320, 132) == (256, 8)


# ------------------------------------------- K4's rounding bound ----------
# The card's K4 ring route sums each row's products in fp32 with FMAs, two
# threads a row taking the first and the second half of every 128-byte
# chunk's 16-byte pieces, and adds the halves at the end; then the
# epilogue of `_window_scores_plain`. The CPU cannot run it, so what is held
# here is the bound the card holds it to (`ivf_rounding_bound`).


def _layout(dtype, seed, d=96, q_n=5, p_n=4, window=160):
    """A synthetic sorted layout of unit-scale rows (int8: residuals with
    row scales and coarse terms), queries, and disjoint probe windows
    starting at any row, with counts 0, short, full and past the window."""
    rng = np.random.default_rng(seed)
    lists = p_n + 3
    cap = lists * (window + 60)
    x = rng.standard_normal((cap, d)).astype(np.float32) / np.sqrt(d)
    queries = rng.standard_normal((q_n, d)).astype(np.float32) / np.sqrt(d)
    if dtype == "int8":
        from cuvs_rag_tpu_torch.ops import distance as dist_ops

        v, scales = dist_ops.quantize_rows(torch.from_numpy(0.3 * x))
        sq = ((v.float() * scales[:, None]) ** 2).sum(1)
        coarse = torch.from_numpy(
            0.3 * rng.standard_normal((q_n, p_n)).astype(np.float32))
    else:
        v = torch.from_numpy(x).to(getattr(torch, dtype))
        scales, coarse = torch.ones(cap), None
        sq = (v.float() ** 2).sum(1)
    offs = np.stack([rng.permutation(lists)[:p_n] for _ in range(q_n)])
    offs = (offs * (window + 60) + rng.integers(0, 50, (q_n, p_n))).astype(
        np.int32)
    cnts = rng.integers(1, window, (q_n, p_n)).astype(np.int32)
    cnts[0, 0], cnts[1, 1], cnts[2, 2] = 0, window, window + 50
    return (v, sq, scales, torch.from_numpy(queries), torch.from_numpy(offs),
            torch.from_numpy(cnts), coarse, window)


def _fp32_sum(acc, part):
    """fp32 acc + an exact fp64 part, rounded once (an FMA's rounding)."""
    return (acc.astype(np.float64) + part).astype(np.float32)


def _emulate_k4(v, sq, scales, queries, offs, cnts, coarse, window, metric,
                *, drop_piece=None, scale=True, add_coarse=True):
    """K4's ring route in numpy, on every live window slot: (Q, P, window)
    fp32 scores, -inf past each count."""
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    cap, d = v.shape
    esize = v.element_size()
    qv = queries.to(topk_ops.query_dtype(v.dtype)).double().numpy()
    xv = v.double().numpy()
    sv, sqv = scales.numpy(), sq.numpy()
    cf = (coarse.numpy() if coarse is not None
          else np.zeros(offs.shape, np.float32))
    scaled = v.dtype == torch.int8
    per_piece = 16 // esize
    n_pieces = d // per_piece
    out = np.full(offs.shape + (window,), -np.inf, np.float32)
    for qi in range(offs.shape[0]):
        for pi in range(offs.shape[1]):
            live = min(int(cnts[qi, pi]), window)
            rows = int(offs[qi, pi]) + np.arange(live)
            halves = [np.zeros(live, np.float32), np.zeros(live, np.float32)]
            for c0 in range(0, n_pieces, 8):  # 128-byte chunks
                pieces = min(8, n_pieces - c0)
                mid = (pieces + 1) // 2
                for p in range(pieces):
                    if c0 + p == drop_piece:
                        continue
                    h = 0 if p < mid else 1
                    for e in range((c0 + p) * per_piece,
                                   (c0 + p + 1) * per_piece):
                        halves[h] = _fp32_sum(halves[h], xv[rows, e] * qv[qi, e])
            dot = _fp32_sum(halves[0], halves[1].astype(np.float64))
            ip = (dot * sv[rows]).astype(np.float32) if scaled and scale else dot
            c = np.float32(cf[qi, pi]) if scaled and add_coarse else np.float32(0)
            aux0 = sqv[rows]
            if metric == "sqeuclidean":
                s = (np.float32(2) * ip - aux0).astype(np.float32) + c
            else:
                s = (ip + c) - np.maximum(aux0 - np.float32(1e29), 0)
            out[qi, pi, :live] = s
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_ivf_rounding_bound_matches_fp64_reference(dtype, metric):
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    v, sq, scales, queries, offs, cnts, coarse, window = _layout(dtype, 31)
    want, allowed = ik.ivf_rounding_bound(
        v, sq, scales, queries, offs, cnts, window=window, metric=metric,
        coarse_ip=coarse)
    q_n, p_n = offs.shape
    cap, d = v.shape
    qv = queries.to(topk_ops.query_dtype(v.dtype)).double().numpy()
    xv, sv, sqv = v.double().numpy(), scales.double().numpy(), \
        sq.double().numpy()
    scaled = dtype == "int8"
    mult = 2.0 if metric == "sqeuclidean" else 1.0
    u = 2.0 ** -24
    for qi in range(q_n):
        for pi in range(p_n):
            rows = np.minimum(int(offs[qi, pi]) + np.arange(window), cap - 1)
            ip = xv[rows] @ qv[qi]
            mag = np.abs(xv[rows]) @ np.abs(qv[qi])
            s = sv[rows] if scaled else np.ones(window)
            cf = float(coarse[qi, pi]) if scaled else 0.0
            term = mult * s * ip
            first = term - sqv[rows] if metric == "sqeuclidean" else term + cf
            ref = first + cf if metric == "sqeuclidean" else first
            ref_allowed = (mult * np.abs(s) * 2 * d * u * mag + u * np.abs(term)
                           + u * np.abs(first) + u * np.abs(ref))
            np.testing.assert_allclose(want[qi, pi].numpy(), ref, rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_allclose(allowed[qi, pi].numpy(), ref_allowed,
                                       rtol=1e-12)
    assert want.dtype == torch.float64 and want.shape == (q_n, p_n, window)
    # tight enough to hold something: far below the outer atol of 1e-3
    assert float(allowed.max()) < 1e-4
    # at chosen positions: the same numbers, each with its own probe's coarse
    s, pos = ik.ivf_scan(v, sq, scales, queries, offs, cnts, k=10,
                         window=window, metric=metric, coarse_ip=coarse)
    w, a = ik.ivf_rounding_bound(v, sq, scales, queries, offs, cnts,
                                 window=window, metric=metric,
                                 coarse_ip=coarse, positions=pos)
    full_pos = offs.long()[:, :, None] + torch.arange(window)
    for qi in range(q_n):
        for j in range(10):
            if pos[qi, j] < 0:
                continue
            live = full_pos[qi] < (offs.long()[qi, :, None]
                                   + cnts.long().clamp(max=window)[qi, :, None])
            pi, col = (full_pos[qi] == pos[qi, j]).logical_and(live).nonzero()[0]
            assert w[qi, j] == want[qi, pi, col] and a[qi, j] == allowed[qi, pi, col]
    # the plain version is inside its own bound
    assert bool(((s.double() - w).abs() <= a)[pos >= 0].all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_k4_order_emulation_stays_within_bound(dtype, metric):
    lay = _layout(dtype, 32)
    v, sq, scales, queries, offs, cnts, coarse, window = lay
    want, allowed = ik.ivf_rounding_bound(
        v, sq, scales, queries, offs, cnts, window=window, metric=metric,
        coarse_ip=coarse)
    got = _emulate_k4(*lay, metric)
    live = np.isfinite(got)
    ratio = np.abs(got - want.numpy())[live] / allowed.numpy()[live]
    assert live.sum() > 1000 and ratio.max() <= 1.0
    if dtype == "float32":  # rounded products and sums: the bound is used
        assert ratio.max() > 1e-3


@pytest.mark.parametrize("fault", ["dropped_piece", "missing_scale",
                                   "missing_coarse"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_k4_planted_faults_break_the_bound(fault, metric):
    """Each would be a kernel that reads or adds one thing fewer; none stays
    within ten times the rounding bound."""
    lay = _layout("int8", 33)
    v, sq, scales, queries, offs, cnts, coarse, window = lay
    want, allowed = ik.ivf_rounding_bound(
        v, sq, scales, queries, offs, cnts, window=window, metric=metric,
        coarse_ip=coarse)
    kw = {"dropped_piece": dict(drop_piece=3),
          "missing_scale": dict(scale=False),
          "missing_coarse": dict(add_coarse=False)}[fault]
    got = _emulate_k4(*lay, metric, **kw)
    live = np.isfinite(got)
    ratio = np.abs(got - want.numpy())[live] / allowed.numpy()[live]
    assert ratio.min() > 10.0


def test_k4_sweep_times_the_pieces_the_wrapper_chooses_from():
    from cuvs_rag_tpu_torch.eval import k4_sweep

    assert set(ik._K4_PIECES) <= set(k4_sweep.PIECES.values())
    assert ik._K4_PIECE is None  # the shipped wrapper applies the rule
