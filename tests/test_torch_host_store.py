"""The port's disk-backed embedding store (rag/host_store.py) against the
JAX package's: a file written by either opens in the other and gives the
same rows. bf16 files hold the same bytes (both round to nearest even);
rows read back are float32 on both sides.
"""

import json

import numpy as np
import pytest
import torch

from cuvs_rag_tpu.rag import host_store as jstore
from cuvs_rag_tpu_torch.rag import host_store as tstore

torch.set_num_threads(1)

N, DIM = 300, 24


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(71).standard_normal((N, DIM)).astype(np.float32)


def _write(mod, path, rows, dtype):
    st = mod.MemmapStore.create(path, N, DIM, dtype)
    assert st.append_chunk(rows[:100]) == 100
    st.append_chunk(rows[100:])
    return st.finalize()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_files_cross_open(rows, tmp_path, dtype, writer):
    path = str(tmp_path / "store.bin")
    _write(tstore if writer == "torch" else jstore, path, rows, dtype)
    ts, js = tstore.MemmapStore.open(path), jstore.MemmapStore.open(path)
    assert ts.shape == js.shape == (N, DIM) and len(ts) == N
    assert ts.dtype == js.dtype == dtype
    ids = np.array([0, 7, 7, 299, 150])
    got = ts.fetch_rows(ids)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, js.fetch_rows(ids))
    np.testing.assert_array_equal(ts.chunk(2, 128), js.chunk(2, 128))
    assert ts.chunk(2, 128).shape == (N - 256, DIM)
    np.testing.assert_array_equal(ts[ids], got)
    np.testing.assert_array_equal(ts[5:9], np.asarray(js[5:9], np.float32))
    want = rows if dtype == "float32" else \
        torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ts[:], want)


def test_both_packages_write_the_same_bytes(rows, tmp_path):
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    _write(tstore, a, rows, "bfloat16")
    _write(jstore, b, rows, "bfloat16")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with open(a + ".json") as fa, open(b + ".json") as fb:
        assert json.load(fa) == json.load(fb)


def test_lifecycle_errors(rows, tmp_path):
    path = str(tmp_path / "s.bin")
    st = tstore.MemmapStore.create(path, N, DIM)
    with pytest.raises(ValueError, match="chunk must be"):
        st.append_chunk(rows[:, :-1])
    st.append_chunk(rows[:200])
    with pytest.raises(ValueError, match="incomplete"):
        st.finalize()
    with pytest.raises(ValueError, match="overflow"):
        st.append_chunk(rows)
    st.append_chunk(rows[200:])
    st.finalize()
    opened = tstore.MemmapStore.open(path)
    with pytest.raises(ValueError, match="read-only"):
        opened.append_chunk(rows[:1])
    with pytest.raises(ValueError, match="read-only"):
        opened.finalize()
    with open(path, "ab") as f:
        f.write(b"\0" * 10)
    with pytest.raises(ValueError, match="truncated or mismatched"):
        tstore.MemmapStore.open(path)


def test_materialize_from_chunks(rows, tmp_path):
    path = str(tmp_path / "m.bin")
    st = tstore.materialize_from_chunks(
        path, lambda i: torch.from_numpy(rows[i * 100:(i + 1) * 100]), N, DIM,
        n_chunks=3, dtype="float32")
    np.testing.assert_array_equal(st.fetch_rows(np.arange(N)), rows)
    np.testing.assert_array_equal(
        jstore.MemmapStore.open(path).fetch_rows(np.arange(N)), rows)
