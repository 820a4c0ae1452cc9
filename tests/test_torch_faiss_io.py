"""cuvs_rag_tpu_torch.index.faiss_io against the JAX package's
index/faiss_io.py: the reference's golden-byte cases (files built by hand
from FAISS's documented layout, tests/test_faiss_io.py), the same bytes
as the JAX writer for the same index, and imported indexes that search as
the JAX package's imports of the same file do.

Tolerances: bytes and parsed arrays exact; searches of two imports of one
file: distances within rtol 1e-5 / atol 1e-4, ids up to ties at the k-th
(utils/compare.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.index import faiss_io as jfaiss
from cuvs_rag_tpu.index import flat as jflat
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_flat as jivf
from cuvs_rag_tpu.index import ivf_pq as jpq
from cuvs_rag_tpu.utils import config as jconfig
from cuvs_rag_tpu_torch.index import faiss_io
from cuvs_rag_tpu_torch.index import flat, io, ivf_flat, ivf_pq
from cuvs_rag_tpu_torch.utils import config as tconfig
from test_faiss_io import (
    _faiss_flat_bytes,
    _faiss_index_pq_bytes,
    _faiss_ivfflat_bytes,
    _faiss_ivfpq_bytes,
)
from torch_parity import compare_topk

torch.set_num_threads(1)

N, D = 600, 32
TOL = dict(rtol=1e-5, atol=1e-4)


def _data(seed=11):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((12, D)).astype(np.float32)
    x = cent[rng.integers(0, 12, N)] + 0.3 * rng.standard_normal((N, D))
    q = x[:9] + 0.05 * rng.standard_normal((9, D))
    return x.astype(np.float32), q.astype(np.float32)


def _ivf_parts(seed=23, nlist=8):
    x, _ = _data()
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((nlist, D)).astype(np.float32)
    labels = rng.integers(0, nlist, (N,)).astype(np.int64)
    labels[labels == 2] = 5  # an empty list
    return x, labels, centroids


def _pq_parts(seed=17, n=300, m=8, nlist=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    codebooks = rng.standard_normal((m, 256, D // m)).astype(np.float32)
    centroids = rng.standard_normal((nlist, D)).astype(np.float32)
    labels = rng.integers(0, nlist, (n,)).astype(np.int32)
    return codes, codebooks, centroids, labels


# ------------------------------------------------------------ golden bytes


@pytest.mark.parametrize("metric_type,metric", [(1, "sqeuclidean"),
                                                (0, "inner_product")])
def test_flat_golden_bytes(tmp_path, metric_type, metric):
    x, _ = _data()
    p = tmp_path / "flat.faiss"
    p.write_bytes(_faiss_flat_bytes(x, metric_type))
    parsed = faiss_io.read_index(str(p))
    assert isinstance(parsed, faiss_io.FaissFlat) and parsed.metric == metric
    np.testing.assert_array_equal(parsed.vectors, x)
    faiss_io.write_index(parsed, str(tmp_path / "w.faiss"))
    assert (tmp_path / "w.faiss").read_bytes() == p.read_bytes()


def test_ivf_flat_golden_bytes(tmp_path):
    x, labels, centroids = _ivf_parts()
    p = tmp_path / "ivf.faiss"
    p.write_bytes(_faiss_ivfflat_bytes(x, labels, centroids, 1, nprobe=3))
    parsed = faiss_io.read_index(str(p))
    assert isinstance(parsed, faiss_io.FaissIVFFlat) and parsed.nprobe == 3
    np.testing.assert_array_equal(parsed.vectors, x)
    np.testing.assert_array_equal(parsed.labels, labels)
    np.testing.assert_array_equal(parsed.centroids, centroids)
    faiss_io.write_index(parsed, str(tmp_path / "w.faiss"))
    assert (tmp_path / "w.faiss").read_bytes() == p.read_bytes()


def test_pq_golden_bytes(tmp_path):
    codes, codebooks, centroids, labels = _pq_parts()
    p = tmp_path / "ivfpq.faiss"
    p.write_bytes(_faiss_ivfpq_bytes(codes, labels, codebooks, centroids, 1))
    parsed = faiss_io.read_index(str(p))
    assert isinstance(parsed, faiss_io.FaissIVFPQ)
    np.testing.assert_array_equal(parsed.codes, codes)
    np.testing.assert_array_equal(parsed.labels, labels)
    np.testing.assert_array_equal(parsed.codebooks, codebooks)
    faiss_io.write_index(parsed, str(tmp_path / "w.faiss"))
    assert (tmp_path / "w.faiss").read_bytes() == p.read_bytes()
    p = tmp_path / "pq.faiss"
    p.write_bytes(_faiss_index_pq_bytes(codes, codebooks, 1))
    parsed = faiss_io.read_index(str(p))
    assert isinstance(parsed, faiss_io.FaissPQ)
    faiss_io.write_index(parsed, str(tmp_path / "w2.faiss"))
    assert (tmp_path / "w2.faiss").read_bytes() == p.read_bytes()


# ------------------------------------------- the JAX writer's bytes, imports


def _jax_indexes(x):
    """JAX-built native indexes of each exportable kind, some rows deleted."""
    xj = jnp.asarray(x)
    out = {
        "flat_fp32": jflat.build(jconfig.FlatParams(), xj),
        "flat_bf16": jflat.build(jconfig.FlatParams(dtype="bfloat16"), xj),
        "flat_int8": jflat.build(jconfig.FlatParams(dtype="int8"), xj),
        "flat_ip": jflat.build(jconfig.FlatParams(metric="inner_product"), xj),
        "ivf_fp32": jivf.build(jconfig.IVFFlatParams(n_lists=8), xj),
        "ivf_bf16": jivf.build(
            jconfig.IVFFlatParams(n_lists=8, dtype="bfloat16"), xj),
        "ivf_int8": jivf.build(jconfig.IVFFlatParams(n_lists=8, dtype="int8"),
                               xj),
        "pq_two_level": jpq.build(jconfig.IVFPQParams(n_lists=8, pq_dim=8), xj),
        "pq_flat8": jpq.build(jconfig.IVFPQParams(
            n_lists=8, pq_dim=8, two_level=False, store_raw=False), xj),
    }
    mods = {"flat": jflat, "ivf": jivf, "pq": jpq}
    for name in list(out):
        if name in ("flat_fp32", "ivf_fp32", "pq_two_level"):
            out[name + "_deleted"] = mods[name.split("_")[0]].delete(
                out[name], jnp.asarray([0, 7, 333]))
    return out


@pytest.fixture(scope="module")
def jax_indexes():
    return _jax_indexes(_data()[0])


@pytest.mark.parametrize("name", [
    "flat_fp32", "flat_bf16", "flat_int8", "flat_ip", "ivf_fp32", "ivf_bf16",
    "ivf_int8", "pq_two_level", "pq_flat8", "flat_fp32_deleted",
    "ivf_fp32_deleted", "pq_two_level_deleted"])
def test_writes_the_jax_packages_bytes(tmp_path, jax_indexes, name):
    """A JAX-built index, loaded in the port through index/io.py: both
    packages' write_index give the same file."""
    jix = jax_indexes[name]
    jio.save_index(str(tmp_path / "ix.npz"), jix)
    tix = io.load_index(str(tmp_path / "ix.npz"), device="cpu")
    jfaiss.write_index(jix, str(tmp_path / "jax.faiss"))
    faiss_io.write_index(tix, str(tmp_path / "port.faiss"))
    assert (tmp_path / "port.faiss").read_bytes() == \
        (tmp_path / "jax.faiss").read_bytes()


def _search(family, mods, ix, q, **kw):
    mod = {"flat": mods[0], "ivf_flat": mods[1], "ivf_pq": mods[2]}[family]
    d, i = mod.search(kw.get("sp"), ix, q, kw.get("k", 8))
    return np.asarray(d), np.asarray(i)


def _same_imports(path, dtype="auto", sp=None):
    """The JAX package's import of `path` and the port's search alike."""
    x, q = _data()
    jfam, jix = jfaiss.import_index(str(path), **(
        {"dtype": dtype} if dtype != "auto" else {}))
    tfam, tix = faiss_io.import_index(str(path), dtype=dtype, device="cpu")
    assert jfam == tfam
    jd, ji = _search(jfam, (jflat, jivf, jpq), jix, jnp.asarray(q), sp=sp[0]
                     if sp else None)
    td, ti = _search(tfam, (flat, ivf_flat, ivf_pq), tix, torch.from_numpy(q),
                     sp=sp[1] if sp else None)
    ascending = jfam != "flat" or jix.metric == "sqeuclidean"
    sign = -1.0 if ascending else 1.0
    compare_topk(sign * td, ti, sign * jd, ji, **TOL)
    return tfam, tix


@pytest.mark.parametrize("name", [
    "flat_fp32", "flat_bf16", "flat_ip", "ivf_fp32", "ivf_bf16",
    "flat_fp32_deleted", "ivf_fp32_deleted"])
@pytest.mark.parametrize("dtype", ["auto", "bfloat16", "int8"])
def test_imports_search_as_the_jax_packages(tmp_path, jax_indexes, name,
                                            dtype):
    jfaiss.write_index(jax_indexes[name], str(tmp_path / "f.faiss"))
    sp = (jconfig.IVFFlatSearchParams(n_probes=3),
          tconfig.IVFFlatSearchParams(n_probes=3))
    fam, tix = _same_imports(tmp_path / "f.faiss", dtype,
                             sp if name.startswith("ivf") else None)
    parsed = faiss_io.read_index(str(tmp_path / "f.faiss"))
    if fam == "ivf_flat":  # the file's quantizer, not a re-clustering
        np.testing.assert_array_equal(tix.centroids.numpy(), parsed.centroids)
        _, labels = ivf_flat._recover_rows(tix, tix.n_valid)
        np.testing.assert_array_equal(labels.numpy(), parsed.labels)
    if name.endswith("deleted"):
        assert tix.n_valid == N - 3


@pytest.mark.parametrize("name", ["pq_two_level", "pq_flat8",
                                  "pq_two_level_deleted"])
def test_pq_imports_search_as_the_jax_packages(tmp_path, jax_indexes, name):
    """An imported IVF-PQ has flat 8-bit codes (levels 1): scanned by
    ops/pq.scan_probed_lists_pq; its ADC equals the source's."""
    jfaiss.write_index(jax_indexes[name], str(tmp_path / "f.faiss"))
    sp = (jconfig.IVFPQSearchParams(n_probes=8, refine_ratio=0),
          tconfig.IVFPQSearchParams(n_probes=8, refine_ratio=0))
    fam, tix = _same_imports(tmp_path / "f.faiss", sp=sp)
    assert fam == "ivf_pq" and tix.levels == 1 and not tix.codes_packed
    assert not tix.has_raw


def test_hand_built_files_import_as_the_jax_package(tmp_path):
    x, labels, centroids = _ivf_parts()
    (tmp_path / "ivf.faiss").write_bytes(
        _faiss_ivfflat_bytes(x, labels, centroids, 1))
    sp = (jconfig.IVFFlatSearchParams(n_probes=8),
          tconfig.IVFFlatSearchParams(n_probes=8))
    _same_imports(tmp_path / "ivf.faiss", sp=sp)
    codes, codebooks, cents, lab = _pq_parts()
    (tmp_path / "ivfpq.faiss").write_bytes(
        _faiss_ivfpq_bytes(codes, lab, codebooks, cents, 1))
    sp = (jconfig.IVFPQSearchParams(n_probes=4, refine_ratio=0),
          tconfig.IVFPQSearchParams(n_probes=4, refine_ratio=0))
    _same_imports(tmp_path / "ivfpq.faiss", sp=sp)
    (tmp_path / "pq.faiss").write_bytes(_faiss_index_pq_bytes(codes,
                                                              codebooks, 1))
    sp = (jconfig.IVFPQSearchParams(n_probes=1, refine_ratio=0),
          tconfig.IVFPQSearchParams(n_probes=1, refine_ratio=0))
    fam, tix = _same_imports(tmp_path / "pq.faiss", sp=sp)
    assert tix.n_lists == 1


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq"])
def test_the_ports_own_indexes_round_trip(tmp_path, kind):
    """A port-built index exported and imported by the port: the same
    values and the same answers (IVF-PQ by its ADC)."""
    x, q = _data()
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    if kind == "flat":
        ix = flat.build(tconfig.FlatParams(dtype="bfloat16"), xt, device="cpu")
        sp, mod = None, flat
    elif kind == "ivf_flat":
        ix = ivf_flat.build(tconfig.IVFFlatParams(n_lists=8,
                                                  dtype="bfloat16"), xt,
                            device="cpu")
        sp, mod = tconfig.IVFFlatSearchParams(n_probes=4), ivf_flat
    else:
        ix = ivf_pq.build(tconfig.IVFPQParams(n_lists=8, pq_dim=8), xt,
                          device="cpu")
        sp, mod = tconfig.IVFPQSearchParams(n_probes=8, refine_ratio=0), ivf_pq
    faiss_io.write_index(ix, str(tmp_path / "f.faiss"))
    fam, back = faiss_io.import_index(
        str(tmp_path / "f.faiss"),
        **({"dtype": "bfloat16"} if kind != "ivf_pq" else {}), device="cpu")
    assert fam == kind
    if kind == "flat":
        assert torch.equal(back.vectors[:N], ix.vectors[:N])
    compare_topk(*(-t for t in mod.search(sp, back, qt, 8)[:1]),
                 mod.search(sp, back, qt, 8)[1],
                 *(-t for t in mod.search(sp, ix, qt, 8)[:1]),
                 mod.search(sp, ix, qt, 8)[1], rtol=1e-4, atol=1e-3)
    # and the JAX package reads the port's file
    assert isinstance(jfaiss.read_index(str(tmp_path / "f.faiss")),
                      {"flat": jfaiss.FaissFlat, "ivf_flat": jfaiss.FaissIVFFlat,
                       "ivf_pq": jfaiss.FaissIVFPQ}[kind])


def test_unsupported_payloads_fail_as_in_the_jax_package(tmp_path):
    x, _ = _data()
    bad = {
        "fourcc": b"IHNf" + _faiss_flat_bytes(x, 1)[4:],
        "truncated": _faiss_flat_bytes(x, 1)[:-8],
        "trailing": _faiss_flat_bytes(x, 1) + b"\0",
    }
    for name, blob in bad.items():
        (tmp_path / name).write_bytes(blob)
        with pytest.raises(ValueError) as got:
            faiss_io.read_index(str(tmp_path / name))
        with pytest.raises(ValueError) as want:
            jfaiss.read_index(str(tmp_path / name))
        assert str(got.value) == str(want.value)
    xt = torch.from_numpy(x)
    for params, match in ((dict(pq_bits=4), "4-bit"), (dict(opq=True), "OPQ")):
        ix = ivf_pq.build(tconfig.IVFPQParams(n_lists=8, pq_dim=8,
                                              store_raw=False, **params),
                          xt, device="cpu")
        with pytest.raises(ValueError, match=match):
            faiss_io.write_index(ix, str(tmp_path / "x.faiss"))
    with pytest.raises(TypeError):
        faiss_io.write_index(object(), str(tmp_path / "y.faiss"))


def test_import_defaults_to_the_card(tmp_path):
    """device=None means the card: no CPU index without a card."""
    x, _ = _data()
    (tmp_path / "f.faiss").write_bytes(_faiss_flat_bytes(x, 1))
    if torch.cuda.is_available():
        assert faiss_io.import_index(str(tmp_path / "f.faiss"))[1] \
            .vectors.device.type == "cuda"
    else:  # CUDA's own error, no CPU index
        with pytest.raises((RuntimeError, AssertionError)):
            faiss_io.import_index(str(tmp_path / "f.faiss"))
