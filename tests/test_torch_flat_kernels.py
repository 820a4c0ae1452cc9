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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.ops import pallas_flat
from cuvs_rag_tpu.utils.config import FlatParams
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
    assert fk.flat_topk_exact.launches == 0  # the CPU path launches nothing
