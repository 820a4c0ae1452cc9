"""The port's filtered views (index/filters.py) against the JAX package's,
for the flat, IVF-Flat and IVF-PQ families, on indexes built by the JAX
package and loaded through the port's index/io.py.

Tolerance: both sides score with exact products of the same operands summed
in fp32 in another order, so distances agree to rtol 1e-5 / atol 1e-4 and
ids up to swaps among distances tied with the k-th.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.index import filters as jfilters
from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.index import ivf_pq as jpq
from cuvs_rag_tpu.utils.config import FlatParams as JFlatParams
from cuvs_rag_tpu.utils.config import IVFFlatParams as JIVFParams
from cuvs_rag_tpu.utils.config import IVFFlatSearchParams as JIVFSearch
from cuvs_rag_tpu.utils.config import IVFPQParams as JPQParams
from cuvs_rag_tpu.utils.config import IVFPQSearchParams as JPQSearch
from cuvs_rag_tpu_torch.index import filters as tfilters
from cuvs_rag_tpu_torch.index import flat as tflat
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.index import ivf_flat as tivf
from cuvs_rag_tpu_torch.index import ivf_pq as tpq
from cuvs_rag_tpu_torch.utils.config import FlatParams as tflat_params
from cuvs_rag_tpu_torch.utils.config import (IVFFlatSearchParams,
                                             IVFPQSearchParams)
from torch_parity import compare_topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM = 2000, 32
FAMILIES = ["flat", "ivf_flat", "ivf_pq"]
MODULES = {"flat": (tflat, jflat), "ivf_flat": (tivf, jivf),
           "ivf_pq": (tpq, jpq)}  # port, JAX


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(queries, {family: npz path}) of JAX-built bf16 indexes over a
    clustered corpus."""
    rng = np.random.default_rng(41)
    cent = rng.standard_normal((16, DIM)).astype(np.float32)
    x = (cent[rng.integers(0, 16, N)]
         + 0.5 * rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[:10] + 0.1 * rng.standard_normal((10, DIM))).astype(np.float32)
    d = tmp_path_factory.mktemp("filters")
    paths = {}
    for family, ix in (
            ("flat", jflat.build(JFlatParams(dtype="bfloat16"), jnp.asarray(x))),
            ("ivf_flat", jivf.build(JIVFParams(n_lists=12, dtype="bfloat16"),
                                    jnp.asarray(x))),
            ("ivf_pq", jpq.build(JPQParams(n_lists=12, pq_dim=8),
                                 jnp.asarray(x)))):
        paths[family] = str(d / f"{family}.npz")
        jio.save_index(paths[family], ix)
    return q, paths


def _params(family):
    return {"flat": (None, None),
            "ivf_flat": (IVFFlatSearchParams(n_probes=5),
                         JIVFSearch(n_probes=5)),
            "ivf_pq": (IVFPQSearchParams(n_probes=5, refine_ratio=4),
                       JPQSearch(n_probes=5, refine_ratio=4))}[family]


def _both(built, family, k, allow, delete=()):
    """Filtered search by each package: (port (d, i), JAX (d, i))."""
    q, paths = built
    tix, jix = tio.load_index(paths[family], device="cpu"), jio.load_index(paths[family])
    if len(delete):
        tmod, jmod = MODULES[family]
        tix, jix = tmod.delete(tix, delete), jmod.delete(jix, delete)
    tsp, jsp = _params(family)
    got = tfilters.search(tsp, tix, torch.from_numpy(q), k, allow)
    want = jfilters.search(jsp, jix, jnp.asarray(q), k, allow)
    return got, tuple(np.asarray(a) for a in want)


def test_masks_match_jax():
    ids = [5, -1, 3, 3, 99, 12]
    np.testing.assert_array_equal(tfilters.allow_from_ids(20, ids),
                                  jfilters.allow_from_ids(20, ids))
    np.testing.assert_array_equal(tfilters.deny_from_ids(20, ids),
                                  jfilters.deny_from_ids(20, ids))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k", [10, 64])
def test_view_matches_jax_and_stays_inside_allow(built, family, k):
    allow = np.random.default_rng(42).random(N) < 0.3
    (d, i), (rd, ri) = _both(built, family, k, allow)
    compare_topk(-d, i, -rd, ri, **TOL)
    ids = i.numpy()
    assert allow[ids[ids >= 0]].all()


@pytest.mark.parametrize("family", FAMILIES)
def test_views_compose_with_delete(built, family):
    """Deleted rows stay dead whatever the mask says."""
    allow = tfilters.deny_from_ids(N, range(100, 200))
    gone = np.arange(0, N, 7)
    (d, i), (rd, ri) = _both(built, family, 10, allow, delete=gone)
    compare_topk(-d, i, -rd, ri, **TOL)
    ids = i.numpy()
    assert not np.isin(ids, gone).any() and not np.isin(ids, range(100, 200)).any()


@pytest.mark.parametrize("family", FAMILIES)
def test_few_allowed_rows_leave_minus_one_slots(built, family):
    allow = tfilters.allow_from_ids(N, [3, 4, 1500])
    (d, i), (rd, ri) = _both(built, family, 10, allow)
    np.testing.assert_array_equal(i.numpy() == -1, ri == -1)
    assert set(i.numpy()[i.numpy() >= 0].tolist()) <= {3, 4, 1500}
    if family == "flat":  # every allowed row is reachable
        assert (i.numpy()[:, :3] >= 0).all() and (i.numpy()[:, 3:] == -1).all()


def test_bad_masks_and_unported_families_raise(built):
    _, paths = built
    tix = tio.load_index(paths["flat"], device="cpu")
    with pytest.raises(ValueError, match="boolean"):
        tfilters.filtered_view(tix, np.ones(N, np.int32))
    with pytest.raises(ValueError, match=f"\\({N},\\)"):
        tfilters.filtered_view(tix, np.ones(N - 1, bool))

    # a sharded index (once refused as unported) filters through
    # parallel/search.search: the JAX package's ids, inside the mask;
    # index/filters stays single-index and names the dispatcher
    from cuvs_rag_tpu.parallel import search as jps
    from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
    from cuvs_rag_tpu_torch.parallel import search as tps
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

    q, _ = built
    x = tio.recover_rows(tix).float().numpy()
    allow = np.arange(N) % 3 != 0
    jmesh = JMesh(jax.devices()[:4])
    jsix = jps.build_sharded("flat", JFlatParams(tile_n=64), x, jmesh)
    want = jps.search_sharded(None, jsix, jnp.asarray(q), 5, jmesh,
                              allow=allow)
    tsix = tps.build_sharded("flat", tflat_params(tile_n=64), x,
                             DeviceMesh(["cpu"] * 4))
    d, i = tps.search(None, tsix, q, 5, allow=allow)
    compare_topk(-d, i, -np.asarray(want[0]), np.asarray(want[1]), **TOL)
    assert allow[i.numpy()].all()
    with pytest.raises(TypeError, match="parallel/search"):
        tfilters.search(None, tsix, q, 5, allow)
    with pytest.raises(TypeError):
        tfilters.view_traced(object(), torch.ones(N, dtype=torch.bool))


def test_ivf_view_reads_ids_past_a_short_mask_as_excluded(built):
    """view_traced's IVF form takes a mask of any width (the sharded layer's
    need in the JAX package): ids past it read False, as there."""
    _, paths = built
    tix, jix = tio.load_index(paths["ivf_flat"], device="cpu"), jio.load_index(paths["ivf_flat"])
    short = np.ones(N // 2, bool)
    got = tfilters.view_traced(tix, torch.from_numpy(short))
    want = jfilters.view_traced(jix, jnp.asarray(short))
    np.testing.assert_array_equal(got.sqnorms.numpy(), np.asarray(want.sqnorms))
    rid = tix.row_ids.numpy()
    assert (got.sqnorms.numpy()[rid >= N // 2] > 1e29).all()


def test_ivf_pq_view_masks_row_ids_and_keeps_deletions(built):
    """The IVF-PQ view replaces row_ids alone (-1 where not allowed), as
    the JAX package's; a view of a deleted index keeps the deleted rows
    deleted, and deleted_ids is read from the base, not the view."""
    q, paths = built
    tix = tio.load_index(paths["ivf_pq"], device="cpu")
    jix = jio.load_index(paths["ivf_pq"])
    gone = np.arange(0, N, 9)
    tix, jix = tpq.delete(tix, gone), jpq.delete(jix, gone)
    allow = np.random.default_rng(43).random(N) < 0.5
    got = tfilters.filtered_view(tix, torch.from_numpy(allow))
    want = jfilters.filtered_view(jix, allow)
    np.testing.assert_array_equal(got.row_ids.numpy(), np.asarray(want.row_ids))
    assert got.codes.data_ptr() == tix.codes.data_ptr()  # storage is shared
    live = got.row_ids.numpy()
    live = live[live >= 0]
    assert allow[live].all() and not np.isin(live, gone).any()
    np.testing.assert_array_equal(tpq.deleted_ids(tix), gone)
    for refine in (0, 4):
        sp = IVFPQSearchParams(n_probes=5, refine_ratio=refine)
        d, i = tpq.search(sp, got, torch.from_numpy(q), 10)
        rd, ri = jpq.search(JPQSearch(n_probes=5, refine_ratio=refine), want,
                            jnp.asarray(q), 10)
        compare_topk(-d, i, -np.asarray(rd), ri, **TOL)
