"""eval/sweeps.py of the port, as the JAX package's tests/test_sweeps.py
holds its own (2 tests), and the operating curve against the JAX
package's on the same index."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.eval import sweeps as jsweeps
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.eval import recall as recall_lib
from cuvs_rag_tpu_torch.eval import sweeps
from cuvs_rag_tpu_torch.index import io, ivf_flat
from cuvs_rag_tpu_torch.utils.config import (
    IVFFlatParams, IVFFlatSearchParams, Metric)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def topics():
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((16, 24)).astype(np.float32) * 3
    lbl = rng.integers(0, 16, 3000)
    corpus = (centers[lbl] + 0.5 * rng.standard_normal((3000, 24))).astype(
        np.float32)
    queries = (centers[rng.integers(0, 16, 10)]
               + 0.5 * rng.standard_normal((10, 24))).astype(np.float32)
    gt = recall_lib.exact_ground_truth(corpus, queries, 10,
                                       Metric.SQEUCLIDEAN, device="cpu")
    return corpus, queries, gt


def test_nprobe_sweep_monotone_recall(topics):
    corpus, queries, gt = topics
    ix = ivf_flat.build(IVFFlatParams(n_lists=16), corpus, device="cpu")
    curve = sweeps.nprobe_sweep(
        ivf_flat, ix, lambda p: IVFFlatSearchParams(n_probes=p),
        torch.from_numpy(queries), gt, k=10, n_probes_list=(1, 4, 16),
    )
    recalls = [p.recall for p in curve]
    assert recalls == sorted(recalls)  # more probes -> more recall
    assert recalls[-1] == 1.0  # full probe exact
    assert all(p.qps > 0 and p.latency_ms_per_query > 0 for p in curve)

    best = sweeps.best_operating_point(curve, min_recall=0.95)
    assert best is not None and best.recall >= 0.95
    assert sweeps.best_operating_point(curve, min_recall=1.1) is None


def test_operating_curve_recall_equals_the_jax_package(topics, tmp_path):
    """The same JAX-built index (through the npz format) gives the same
    recall at every n_probes in both packages' operating curves."""
    corpus, queries, gt = topics
    jix = jivf.build(jconfig.IVFFlatParams(n_lists=16), jnp.asarray(corpus))
    jio.save_index(str(tmp_path / "ivf.npz"), jix)
    tix = io.load_index(str(tmp_path / "ivf.npz"), device="cpu")
    probes = (1, 2, 3, 5, 8, 16)
    jcurve = jsweeps.nprobe_sweep(
        jivf, jix, lambda p: jconfig.IVFFlatSearchParams(n_probes=p),
        queries, gt, k=10, n_probes_list=probes)
    tcurve = sweeps.nprobe_sweep(
        ivf_flat, tix, lambda p: IVFFlatSearchParams(n_probes=p),
        torch.from_numpy(queries), gt, k=10, n_probes_list=probes)
    assert [p.param for p in tcurve] == list(probes)
    assert [p.recall for p in tcurve] == [p.recall for p in jcurve]


def test_batched_sharded_search():
    from cuvs_rag_tpu_torch.parallel import search as psearch
    from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    rng = np.random.default_rng(42)
    corpus = rng.standard_normal((512, 16)).astype(np.float32)
    queries = rng.standard_normal((23, 16)).astype(np.float32)  # != batch
    dmesh = DeviceMesh(["cpu"] * 8)
    sindex = psearch.build_sharded("flat", FlatParams(tile_n=8), corpus,
                                   dmesh)
    d_b, i_b = psearch.search_sharded_batched(
        None, sindex, queries, 5, dmesh, batch_size=10)
    d_1, i_1 = psearch.search_sharded(None, sindex, queries, 5, dmesh)
    np.testing.assert_array_equal(i_b.numpy(), i_1.numpy())
    assert d_b.shape == (23, 5)
