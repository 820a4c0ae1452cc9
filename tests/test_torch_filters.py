"""The port's filtered views (index/filters.py) against the JAX package's,
for the flat and IVF-Flat families, on indexes built by the JAX package and
loaded through the port's index/io.py.

Tolerance: both sides score with exact products of the same operands summed
in fp32 in another order, so distances agree to rtol 1e-5 / atol 1e-4 and
ids up to swaps among distances tied with the k-th.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import filters as jfilters
from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.utils.config import FlatParams as JFlatParams
from cuvs_rag_tpu.utils.config import IVFFlatParams as JIVFParams
from cuvs_rag_tpu.utils.config import IVFFlatSearchParams as JIVFSearch
from cuvs_rag_tpu_torch.index import filters as tfilters
from cuvs_rag_tpu_torch.index import flat as tflat
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.index import ivf_flat as tivf
from cuvs_rag_tpu_torch.utils.config import IVFFlatSearchParams
from torch_parity import compare_topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM = 2000, 32
FAMILIES = ["flat", "ivf_flat"]
MODULES = {"flat": (tflat, jflat), "ivf_flat": (tivf, jivf)}  # port, JAX


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
                                    jnp.asarray(x)))):
        paths[family] = str(d / f"{family}.npz")
        jio.save_index(paths[family], ix)
    return q, paths


def _params(family):
    return (IVFFlatSearchParams(n_probes=5), JIVFSearch(n_probes=5)) \
        if family == "ivf_flat" else (None, None)


def _both(built, family, k, allow, delete=()):
    """Filtered search by each package: (port (d, i), JAX (d, i))."""
    q, paths = built
    tix, jix = tio.load_index(paths[family]), jio.load_index(paths[family])
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
    tix = tio.load_index(paths["flat"])
    with pytest.raises(ValueError, match="boolean"):
        tfilters.filtered_view(tix, np.ones(N, np.int32))
    with pytest.raises(ValueError, match=f"\\({N},\\)"):
        tfilters.filtered_view(tix, np.ones(N - 1, bool))

    class IVFPQIndex:
        pass

    class CagraIndex:
        pass

    with pytest.raises(NotImplementedError, match="slice 3"):
        tfilters.filtered_view(IVFPQIndex(), np.ones(N, bool))
    with pytest.raises(NotImplementedError, match="slice 4"):
        tfilters.search(None, CagraIndex(), None, 5, np.ones(N, bool))
    with pytest.raises(TypeError):
        tfilters.view_traced(object(), torch.ones(N, dtype=torch.bool))


def test_ivf_view_reads_ids_past_a_short_mask_as_excluded(built):
    """view_traced's IVF form takes a mask of any width (the sharded layer's
    need in the JAX package): ids past it read False, as there."""
    _, paths = built
    tix, jix = tio.load_index(paths["ivf_flat"]), jio.load_index(paths["ivf_flat"])
    short = np.ones(N // 2, bool)
    got = tfilters.view_traced(tix, torch.from_numpy(short))
    want = jfilters.view_traced(jix, jnp.asarray(short))
    np.testing.assert_array_equal(got.sqnorms.numpy(), np.asarray(want.sqnorms))
    rid = tix.row_ids.numpy()
    assert (got.sqnorms.numpy()[rid >= N // 2] > 1e29).all()
