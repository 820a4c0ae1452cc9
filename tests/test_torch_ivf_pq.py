"""The port's IVF-PQ index (index/ivf_pq.py, index/io.py) against the JAX
package's: indexes built by the JAX package in every code form and loaded
through the port's io search identically; the port's own builds reach the
JAX builds' recall; extend, delete and the out-of-core refine behave alike.

Tolerance: search on a shared index sums the same fp32 table entries and
products in another order: distances agree to rtol 1e-5 / atol 1e-4 and ids
up to swaps among scores tied with the k-th. Builds differ by RNG
(torch.Generator vs jax.random) and are held by recall@10 within 0.02.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.eval import recall as jrecall
from cuvs_rag_tpu.index import io as jio
from cuvs_rag_tpu.index import ivf_pq as jpq
from cuvs_rag_tpu.utils.config import IVFPQParams as JParams
from cuvs_rag_tpu.utils.config import IVFPQSearchParams as JSearch
from cuvs_rag_tpu_torch.index import base
from cuvs_rag_tpu_torch.index import io as tio
from cuvs_rag_tpu_torch.index import ivf_pq as tpq
from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams
from torch_parity import compare_topk, to_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, DIM, LISTS, M, NPROBE = 3000, 32, 16, 8, 6
FORMS = {
    "two_level": dict(pq_bits=8),
    "four_bit": dict(pq_bits=4),
    "flat8": dict(pq_bits=8, two_level=False),
    "two_level_opq": dict(pq_bits=8, opq=True, opq_iters=2),
    "four_bit_cosine": dict(pq_bits=4, metric="cosine"),
}


def _corpus(seed=51, n=N, n_q=16):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((24, DIM)).astype(np.float32)
    x = cent[rng.integers(0, 24, n)] + 0.5 * rng.standard_normal((n, DIM))
    q = x[:n_q] + 0.1 * rng.standard_normal((n_q, DIM))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _corpus()


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """{form: npz path} of JAX-built indexes with every 37th row deleted."""
    x, _ = data
    d = tmp_path_factory.mktemp("ivfpq")
    out = {}
    for form, kw in FORMS.items():
        ix = jpq.build(JParams(n_lists=LISTS, pq_dim=M, **kw), jnp.asarray(x))
        ix = jpq.delete(ix, np.arange(0, N, 37))
        out[form] = str(d / f"{form}.npz")
        jio.save_index(out[form], ix)
    return out


def _same(tix, jix, q, k, refine, **kw):
    td, ti = tpq.search(IVFPQSearchParams(n_probes=NPROBE,
                                          refine_ratio=refine), tix,
                        torch.from_numpy(q), k, **kw)
    jd, ji = jpq.search(JSearch(n_probes=NPROBE, refine_ratio=refine), jix,
                        jnp.asarray(q), k)
    sign = -1.0 if tix.metric == "sqeuclidean" else 1.0
    compare_topk(sign * to_numpy(td), ti, sign * np.asarray(jd), ji, **TOL)
    return to_numpy(ti)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("refine", [0, 4])
def test_jax_built_index_searches_identically(data, jax_files, form, refine):
    _, q = data
    jix = jio.load_index(jax_files[form])
    tix = tio.load_index(jax_files[form], device="cpu")
    assert tix.codes.dtype == torch.uint8 and tix.row_ids.dtype == torch.int32
    assert tix.codes.shape == tuple(jix.codes.shape)
    assert tix.codes_packed == (form != "flat8")
    assert tix.levels == (2 if form.startswith("two_level") else 1)
    assert tix.has_opq == (form == "two_level_opq") and tix.has_raw
    assert (tix.n_valid, tix.dim, tix.pq_dim, tix.max_list_size) == \
        (int(jix.n_valid), jix.dim, jix.pq_dim, jix.max_list_size)
    ids = _same(tix, jix, q, 10, refine)
    assert not np.isin(ids, np.arange(0, N, 37)).any()  # deleted stay out
    np.testing.assert_array_equal(tpq.deleted_ids(tix), jpq.deleted_ids(jix))


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8"])
def test_port_file_loads_in_jax(data, jax_files, form, tmp_path):
    """uint8 codes and the (0,) / (0, 0) / (0, Dp) empty tensors round-trip
    both ways."""
    _, q = data
    tix = tpq.strip_raw(tio.load_index(jax_files[form], device="cpu"))
    assert tix.raw_vectors.shape == (0, DIM) and not tix.has_raw
    path = str(tmp_path / "t.npz")
    tio.save_index(path, tix)
    jix = jio.load_index(path)
    assert jix.raw_vectors.shape == (0, DIM) and jix.rotation.shape == (0, 0)
    back = tio.load_index(path, device="cpu")
    for f in tpq.IVFPQIndex._tensor_fields:
        assert torch.equal(getattr(back, f), getattr(tix, f)), f
    _same(tix, jix, q, 10, 4)  # no raw store: refine turns itself off


def test_format1_file_is_transposed_on_load(data, jax_files, tmp_path):
    """A file older than format 2 holds row-major (cap, mb) codes."""
    _, q = data
    with np.load(jax_files["two_level"]) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["format"] = 1
    arrays["codes"] = np.ascontiguousarray(arrays["codes"].T)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = str(tmp_path / "v1.npz")
    np.savez(path, **arrays)
    old = tio.load_index(path, device="cpu")
    new = tio.load_index(jax_files["two_level"], device="cpu")
    assert torch.equal(old.codes, new.codes)
    _same(old, jio.load_index(path), q, 10, 0)


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8"])
def test_own_build_reaches_jax_recall(form):
    x, q = _corpus(seed=52, n_q=128)
    gt = jrecall.exact_ground_truth(x, q, 10, "sqeuclidean")
    rec = {(side, r): [] for side in "tj" for r in (0, 4)}
    for seed in range(3):
        kw = dict(n_lists=LISTS, pq_dim=M, **FORMS[form])
        tix = tpq.build(IVFPQParams(**kw), x, seed=seed, device="cpu")
        jix = jpq.build(JParams(**kw), jnp.asarray(x), seed=seed)
        assert tix.codes.shape[0] == jix.codes.shape[0]
        assert int(tix.list_counts.max()) <= int(np.ceil(2.5 * N / LISTS))
        for r in (0, 4):
            _, ti = tpq.search(IVFPQSearchParams(n_probes=NPROBE,
                                                 refine_ratio=r), tix, q, 10)
            _, ji = jpq.search(JSearch(n_probes=NPROBE, refine_ratio=r), jix,
                               jnp.asarray(q), 10)
            rec["t", r].append(jrecall.recall_at_k(ti.numpy(), gt, 10))
            rec["j", r].append(jrecall.recall_at_k(np.asarray(ji), gt, 10))
    for r in (0, 4):
        assert np.mean(rec["t", r]) >= np.mean(rec["j", r]) - 0.02, rec
    assert np.mean(rec["t", 4]) > np.mean(rec["t", 0])


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8"])
@pytest.mark.parametrize("store_raw", [True, False])
def test_build_from_chunks_equals_build(data, form, store_raw):
    x, _ = data
    params = IVFPQParams(n_lists=LISTS, pq_dim=M, kmeans_sample=1500,
                         pq_train_sample=1000, balance_factor=1.2,
                         store_raw=store_raw, **FORMS[form])
    whole = tpq.build(params, x, seed=3, device="cpu")
    chunked = tpq.build_from_chunks(
        params, lambda i: x[i * 500:(i + 1) * 500], N, DIM, n_chunks=6,
        seed=3, device="cpu")
    for f in tpq.IVFPQIndex._tensor_fields:
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f
    assert whole.max_list_size == chunked.max_list_size
    assert whole.has_raw == store_raw
    with pytest.raises(ValueError, match="divide"):
        tpq.build_from_chunks(params, lambda i: x, N, DIM, n_chunks=7,
                              device="cpu")


@pytest.mark.parametrize("form", ["two_level", "four_bit", "flat8"])
def test_extend_and_delete_match_jax(data, jax_files, form):
    """In-place appends, then an append past a list's region (the headroom
    re-layout, which re-applies the tombstones): both packages end with
    indexes that search alike, and deleted rows stay deleted."""
    x, q = data
    rng = np.random.default_rng(53)
    jix = jio.load_index(jax_files[form])
    tix = tio.load_index(jax_files[form], device="cpu")
    small = (x[:40] + 0.05 * rng.standard_normal((40, DIM))).astype(np.float32)
    window0 = tix.max_list_size
    old_codes = tix.codes
    jix, tix = jpq.extend(jix, jnp.asarray(small)), tpq.extend(tix, small)
    assert tix.n_valid == N + 40 and tix.max_list_size == window0
    assert tix.codes.data_ptr() == old_codes.data_ptr()  # landed in place
    ids = _same(tix, jix, small[:8], 5, 4)
    assert (ids[:, 0] == N + np.arange(8)).all()
    gone = np.array([N + 1, 5, 6])
    jix, tix = jpq.delete(jix, gone), tpq.delete(tix, gone)
    # 700 near-copies of one row overflow its list's region
    burst = (x[7] + 0.01 * rng.standard_normal((700, DIM))).astype(np.float32)
    jix, tix = jpq.extend(jix, jnp.asarray(burst)), tpq.extend(tix, burst)
    assert tix.n_valid == N + 740 and tix.max_list_size > window0
    assert (tix.max_list_size, tuple(tix.codes.shape)) == \
        (jix.max_list_size, tuple(jix.codes.shape))
    np.testing.assert_array_equal(tpq.deleted_ids(tix), jpq.deleted_ids(jix))
    assert set(gone) <= set(tpq.deleted_ids(tix).tolist())
    for refine in (0, 4):
        ids = _same(tix, jix, np.concatenate([q[:6], small[:4]]), 10, refine)
        assert not np.isin(ids, gone).any()
    with pytest.raises(ValueError, match="new vectors"):
        tpq.extend(tix, np.zeros((2, DIM + 1), np.float32))


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_out_of_core_refine_equals_in_core(data, metric):
    """store_raw=False + fetch_rows: the device re-rank and the host
    re-rank of fetched rows give what the in-core refine gives, and what
    the JAX package gives on the same index."""
    x, q = data
    params = IVFPQParams(n_lists=LISTS, pq_dim=M, metric=metric)
    full = tpq.build(params, x, device="cpu")
    bare = tpq.strip_raw(full)
    sp = IVFPQSearchParams(n_probes=NPROBE, refine_ratio=4)
    calls = []

    def fetch(ids):
        assert (np.diff(ids) > 0).all()  # sorted, unique, ascending
        calls.append(len(ids))
        return x[ids]

    d0, i0 = tpq.search(sp, full, q, 10)
    d1, i1 = tpq.search(sp, bare, q, 10, fetch_rows=fetch)
    d2, i2 = tpq.search(sp, bare, q, 10, fetch_rows=fetch, host_rerank=True)
    assert isinstance(d1, torch.Tensor) and isinstance(d2, np.ndarray)
    assert len(calls) == 2
    sign = -1.0 if metric == "sqeuclidean" else 1.0
    compare_topk(sign * d1, i1, sign * d0, i0, **TOL)
    compare_topk(sign * d2, i2, sign * d0, i0, **TOL)
    # without refine the callback is never asked
    tpq.search(IVFPQSearchParams(n_probes=NPROBE, refine_ratio=0), bare, q,
               10, fetch_rows=fetch)
    assert len(calls) == 2
    jd, ji = jpq.search(JSearch(n_probes=NPROBE, refine_ratio=4),
                        _to_jax(bare), jnp.asarray(q), 10,
                        fetch_rows=lambda ids: x[ids], host_rerank=True)
    compare_topk(sign * d2, i2, sign * np.asarray(jd), ji, **TOL)


def _to_jax(tix):
    """The port's index as the JAX package's, through a file."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ix.npz")
        tio.save_index(path, tix)
        return jio.load_index(path)


def test_recover_rows(data, jax_files):
    x, _ = data
    tix = tio.load_index(jax_files["two_level"], device="cpu")
    live = np.arange(N) % 37 != 0  # a deleted row has no slot to read
    np.testing.assert_array_equal(tio.recover_rows(tix).numpy()[live], x[live])
    approx = tio.recover_rows(tpq.strip_raw(tix)).numpy()[live]
    want = np.asarray(jio.recover_rows(jpq.strip_raw(
        jio.load_index(jax_files["two_level"]))))[live]
    np.testing.assert_allclose(approx, want, rtol=1e-5, atol=1e-5)
    assert np.mean((approx - x[live]) ** 2) < 0.5 * np.mean(x ** 2)


def test_entry_points_default_to_the_card(data, jax_files):
    """device=None means the card for numpy and file inputs, a tensor keeps
    its device, and device="cpu" is the CPU. Without a card the default
    fails with CUDA's own error; it never carries on on the CPU."""
    from cuvs_rag_tpu_torch.index import flat, ivf_flat
    from cuvs_rag_tpu_torch.models import bert_encoder as be
    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer
    from cuvs_rag_tpu_torch.utils.config import FlatParams, IVFFlatParams

    x = data[0][:600]
    cpu = torch.device("cpu")
    assert base.resolve_device(None) == torch.device("cuda")
    assert base.resolve_device("cpu") == cpu
    assert base.resolve_device(None, torch.zeros(2)) == cpu
    assert base.resolve_device("cpu", torch.zeros(2)) == cpu
    cfg = be.BertConfig(vocab_size=50, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32, max_position=16)
    entry_points = {
        "flat": lambda dev: flat.build(FlatParams(), x, device=dev),
        "ivf_flat": lambda dev: ivf_flat.build(IVFFlatParams(n_lists=4), x,
                                               device=dev),
        "ivf_pq": lambda dev: tpq.build(IVFPQParams(n_lists=4, pq_dim=4), x,
                                        device=dev),
        "load_index": lambda dev: tio.load_index(jax_files["four_bit"],
                                                 device=dev),
        "encoder": lambda dev: be.TorchSentenceEncoder(
            cfg, be.BertEncoderModel(cfg), HashTokenizer(49), device=dev),
    }
    for name, make in entry_points.items():
        assert make("cpu").device == cpu, name
        if torch.cuda.is_available():
            assert make(None).device.type == "cuda", name
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make(None)
    # a tensor input keeps its own device
    assert flat.build(FlatParams(), torch.from_numpy(x)).device == cpu
    assert tpq.build(IVFPQParams(n_lists=4, pq_dim=4),
                     torch.from_numpy(x)).device == cpu
