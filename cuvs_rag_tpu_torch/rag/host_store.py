"""Disk-backed host embedding store: raw rows beyond device and host RAM.

The counterpart of the JAX package's `rag/host_store.py`, numpy only. An
IVF-PQ index with `store_raw=False` keeps only its codes on the device; the
exact refine re-rank then needs the raw rows from somewhere. This store is
an np.memmap over a disk file: the OS page cache keeps hot rows in RAM, and
a refine fetch touches only k·refine_ratio rows a query, whatever the
corpus size.

The file is a flat binary of rows in ORIGINAL id order plus a JSON sidecar
(n, dim, dtype). A file written by either package opens in the other.
bf16 rows (the default) halve disk bytes and I/O; they are kept as their
16-bit patterns here, so no extra dtype package is needed, and
`fetch_rows` returns float32 (what the exact re-rank scores with).

The write path streams: `create()` + `append_chunk()` never hold more than
one chunk in RAM.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _np_dtype(name: str) -> np.dtype:
    """The dtype the file is mapped with: bf16 as its uint16 bit pattern."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def _to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float rows -> bf16 bit patterns, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(u: np.ndarray) -> np.ndarray:
    return (np.asarray(u).astype(np.uint32) << 16).view(np.float32)


class MemmapStore:
    """Row store over np.memmap. Open with `MemmapStore.open(path)` or
    build with `MemmapStore.create(...)` + `append_chunk()` + `finalize()`.

    Usable where a host embedding array is expected:
      * `store.fetch_rows(ids)` — the out-of-core refine source
        (`ivf_pq.search(fetch_rows=store.fetch_rows, host_rerank=True)`)
      * `store[ids]` / `store.shape` / `len(store)` — ndarray-like surface
      * `store.chunk(i, rows)` — build feed for
        `ivf_pq.build_from_chunks(..., chunk_fn=...)`
    """

    def __init__(self, path: str, mm: np.memmap, n: int, dim: int,
                 dtype: str, writable: bool = False):
        self.path = path
        self._mm = mm
        self.n = n
        self.dim = dim
        self.dtype = dtype
        self._writable = writable
        self._written = 0

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    def _sidecar(path: str) -> str:
        return path + ".json"

    @classmethod
    def create(cls, path: str, n: int, dim: int,
               dtype: str = _BF16) -> "MemmapStore":
        """Allocate the backing file (sparse where the FS allows) for n
        rows; fill with append_chunk(); finalize() writes the sidecar."""
        mm = np.memmap(path, dtype=_np_dtype(dtype), mode="w+", shape=(n, dim))
        return cls(path, mm, n, dim, dtype, writable=True)

    def append_chunk(self, arr) -> int:
        """Write the next rows (any float dtype; cast to the store dtype).
        Returns rows written so far."""
        if not self._writable:
            raise ValueError("store is read-only (opened, not created)")
        a = np.asarray(arr)
        if a.ndim != 2 or a.shape[1] != self.dim:
            raise ValueError(f"chunk must be (m, {self.dim}), got {a.shape}")
        end = self._written + a.shape[0]
        if end > self.n:
            raise ValueError(f"store overflow: {end} rows > declared {self.n}")
        self._mm[self._written:end] = _to_bf16_bits(a) \
            if self.dtype == _BF16 else a.astype(self._mm.dtype)
        self._written = end
        return end

    def finalize(self) -> "MemmapStore":
        if not self._writable:
            raise ValueError("store is read-only")
        if self._written != self.n:
            raise ValueError(
                f"store incomplete: {self._written} of {self.n} rows")
        self._mm.flush()
        with open(self._sidecar(self.path), "w") as f:
            json.dump({"n": self.n, "dim": self.dim, "dtype": self.dtype,
                       "format": 1}, f)
        self._writable = False
        return self

    @classmethod
    def open(cls, path: str) -> "MemmapStore":
        with open(cls._sidecar(path)) as f:
            meta = json.load(f)
        expect = meta["n"] * meta["dim"] * _np_dtype(meta["dtype"]).itemsize
        actual = os.path.getsize(path)
        if actual != expect:
            raise ValueError(
                f"store file {path} is {actual} bytes, sidecar implies "
                f"{expect} — truncated or mismatched sidecar")
        mm = np.memmap(path, dtype=_np_dtype(meta["dtype"]), mode="r",
                       shape=(meta["n"], meta["dim"]))
        return cls(path, mm, meta["n"], meta["dim"], meta["dtype"])

    # -- read surface --------------------------------------------------------

    @property
    def shape(self):
        return (self.n, self.dim)

    def __len__(self) -> int:
        return self.n

    def _f32(self, raw) -> np.ndarray:
        # always a copy: callers never hold a view of the read-only map
        return _from_bf16_bits(raw) if self.dtype == _BF16 \
            else np.array(raw, dtype=np.float32)

    def __getitem__(self, key) -> np.ndarray:
        """Rows as float32 (bf16 files are decoded)."""
        return self._f32(self._mm[key])

    def fetch_rows(self, ids) -> np.ndarray:
        """(m,) ids -> (m, dim) float32 rows: the refine-source contract
        (ivf_pq.search fetch_rows=). Fancy-indexing a memmap reads only the
        touched pages."""
        return self._f32(self._mm[np.asarray(ids)])

    def chunk(self, i: int, rows: int) -> np.ndarray:
        """Rows [i*rows, (i+1)*rows) as float32: a build_from_chunks feed,
        ivf_pq.build_from_chunks(params, lambda i: store.chunk(i, R), ...)."""
        lo = i * rows
        return self._f32(self._mm[lo:min(lo + rows, self.n)])


def materialize_from_chunks(path: str, chunk_fn, n: int, dim: int,
                            n_chunks: int, dtype: str = _BF16,
                            log: Optional[int] = None) -> MemmapStore:
    """Stream n rows from chunk_fn(i) (tensors or host arrays) into a new
    MemmapStore; peak RAM is one chunk whatever n."""
    st = MemmapStore.create(path, n, dim, dtype)
    for i in range(n_chunks):
        c = chunk_fn(i)
        if isinstance(c, torch.Tensor):
            c = c.float().cpu().numpy()
        st.append_chunk(np.asarray(c))
        if log and (i + 1) % log == 0:
            print(f"  host store: {st._written}/{n} rows", flush=True)
    return st.finalize()
