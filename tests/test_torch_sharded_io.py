"""Sharded checkpoints (index/io.save_sharded / load_sharded): per-shard part
files restore exactly on a mesh of the same size and rebuild onto another
size, row recovery from every family, and the files of either package
read by the other, as the JAX package's tests/test_sharded_io.py holds it.

Both packages write `{prefix}_part{i}.npz` (each shard's save_index) and
`{prefix}.json`; a checkpoint crossing packages must search identically
(the same rows, lists and graph: ids equal, distances within 8 fp32
roundings of their largest terms) and re-save to the same manifest bytes
and the same arrays.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.parallel import search as jps
from cuvs_rag_tpu.parallel.mesh import DeviceMesh as JMesh
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.index import io
from cuvs_rag_tpu_torch.parallel import search as tps
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

N, D, K = 3000, 64, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((20, D)).astype(np.float32) * 3
    corpus = centers[rng.integers(0, 20, N)] + 0.4 * rng.standard_normal(
        (N, D)).astype(np.float32)
    queries = centers[rng.integers(0, 20, 8)] + 0.4 * rng.standard_normal(
        (8, D)).astype(np.float32)
    return corpus.astype(np.float32), queries.astype(np.float32)


def _cases(cfg):
    return [
        ("flat", cfg.FlatParams(), None),
        ("ivf_flat", cfg.IVFFlatParams(n_lists=8), None),
        ("ivf_pq", cfg.IVFPQParams(n_lists=8, pq_dim=8),
         cfg.IVFPQSearchParams(n_probes=8, refine_ratio=4)),
        ("cagra", cfg.CagraParams(graph_degree=16,
                                  intermediate_graph_degree=32), None),
    ]


FAMILIES = ["flat", "ivf_flat", "ivf_pq", "cagra"]


def _case(family, cfg):
    return {f: (p, sp) for f, p, sp in _cases(cfg)}[family]


def _mesh(s=8):
    return DeviceMesh(["cpu"] * s)


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_round_trip_same_mesh(data, family, tmp_path):
    corpus, queries = data
    params, sp = _case(family, tconfig)
    six = tps.build_sharded(family, params, corpus, _mesh())
    d1, i1 = tps.search_sharded(sp, six, queries, K, _mesh())
    prefix = str(tmp_path / f"{family}_ck")
    io.save_sharded(prefix, six)
    six2 = io.load_sharded(prefix, _mesh())
    assert six2.family == family and six2.total == N
    d2, i2 = tps.search_sharded(sp, six2, queries, K, _mesh())
    assert torch.equal(i1, i2)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5)


def test_sharded_reload_onto_smaller_mesh(data, tmp_path):
    """An 8-shard checkpoint restored onto 4 positions: rows recovered from
    the parts and rebuilt with `params` (required), tombstones applied
    again; results match a fresh 4-shard build."""
    corpus, queries = data
    params = tconfig.FlatParams()
    six = tps.delete_sharded(tps.build_sharded("flat", params, corpus,
                                               _mesh()), [7])
    prefix = str(tmp_path / "flat_ck")
    io.save_sharded(prefix, six)
    with pytest.raises(ValueError, match="pass `params`"):
        io.load_sharded(prefix, _mesh(4))
    six4 = io.load_sharded(prefix, _mesh(4), params=params)
    assert six4.num_shards == 4
    _, i4 = tps.search_sharded(None, six4, queries, K, _mesh(4))
    ref = tps.delete_sharded(tps.build_sharded("flat", params, corpus,
                                               _mesh(4)), [7])
    _, iref = tps.search_sharded(None, ref, queries, K, _mesh(4))
    assert torch.equal(i4, iref)
    _, i7 = tps.search_sharded(None, six4, corpus[7:8], 1, _mesh(4))
    assert int(i7[0, 0]) != 7


@pytest.mark.parametrize("family", FAMILIES)
def test_recover_rows_round_trip(data, family):
    """recover_rows gives the corpus in original order from every family's
    storage (float storage exactly up to its rounding; quantized families
    within their error)."""
    corpus, _ = data
    params, _ = _case(family, tconfig)
    ix = tps.FAMILIES[family].build(params, corpus, device="cpu")
    rows = io.recover_rows(ix).float().numpy()
    assert rows.shape == corpus.shape
    rel = np.linalg.norm(rows - corpus) / np.linalg.norm(corpus)
    assert rel < 0.05, (family, rel)


def test_recover_rows_pq_codes_only(data):
    """Without the raw store, IVF-PQ rows come from the code reconstruction:
    lossy, but row-aligned."""
    corpus, _ = data
    ix = tps.FAMILIES["ivf_pq"].build(
        tconfig.IVFPQParams(n_lists=8, pq_dim=8, store_raw=False), corpus,
        device="cpu")
    rows = io.recover_rows(ix).numpy()
    assert rows.shape == corpus.shape
    sample = np.arange(0, N, 137)
    d_self = np.sum((rows[sample] - corpus[sample]) ** 2, 1)
    d_rand = np.sum((rows[sample] - corpus[(sample + 977) % N]) ** 2, 1)
    assert (d_self < d_rand).mean() > 0.95


def _same_files(a: str, b: str, s: int) -> None:
    """Two checkpoints hold the same manifest bytes and the same arrays."""
    with open(f"{a}.json", "rb") as fa, open(f"{b}.json", "rb") as fb:
        assert fa.read() == fb.read()
    for i in range(s):
        with np.load(f"{a}_part{i}.npz") as za, \
                np.load(f"{b}_part{i}.npz") as zb:
            assert sorted(za.files) == sorted(zb.files)
            for name in za.files:
                if name == "__meta__":
                    assert json.loads(bytes(za[name])) == \
                        json.loads(bytes(zb[name]))
                else:
                    np.testing.assert_array_equal(za[name], zb[name])


@pytest.mark.parametrize("family", FAMILIES)
def test_part_files_cross_between_packages(data, family, tmp_path):
    """The port's parts load in the JAX package (which stacks them, so the
    shards' shapes must agree) and search identically there; the JAX
    package re-saves them as the same files; the port re-saves a JAX
    checkpoint as the same files too."""
    corpus, queries = data
    params, sp = _case(family, tconfig)
    jparams, jsp = _case(family, jconfig)
    jmesh = JMesh(jax.devices()[:4])
    six = tps.build_sharded(family, params, corpus, _mesh(4))
    ours = str(tmp_path / "port")
    io.save_sharded(ours, six)
    jsix = jio.load_sharded(ours, jmesh)
    d, i = tps.search_sharded(sp, six, queries, K, _mesh(4))
    jd, ji = jps.search_sharded(jsp, jsix, jnp.asarray(queries), K, jmesh)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # a distance is ||q||² + ||x||² - 2 q.x: terms of ~1e3 here, so a few
    # fp32 roundings of them, summed in another order, reach ~1e-3
    terms = (queries ** 2).sum(1).max() + (corpus ** 2).sum(1).max()
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=8 * np.finfo(np.float32).eps * terms)
    again = str(tmp_path / "jax_again")
    jio.save_sharded(again, jsix)
    _same_files(ours, again, 4)

    theirs = str(tmp_path / "jax")
    jio.save_sharded(theirs, jps.build_sharded(family, jparams, corpus, jmesh))
    back = str(tmp_path / "port_again")
    io.save_sharded(back, io.load_sharded(theirs, _mesh(4)))
    _same_files(theirs, back, 4)
