"""ctypes bindings for libhostops, the host-side C++ runtime (`hostops.cpp`):
the heap merge of per-shard top-k lists, exact CPU brute force, the BM25
scorers over CSR postings, and row-wise int8 quantization.

`hostops.cpp` is a byte-for-byte copy of the JAX package's
`native/hostops.cpp` (a test holds them equal). It is built at first use by
`g++` into `build/native/` at the repository root, keyed by a hash of the
source, the flags and the native target `g++ -march=native` resolves to, and
renamed into place atomically: the JAX package's directory is never written.
A failed build raises; nothing falls back to numpy. Each entry point has a
`<name>_plain` numpy version of the same contract, which the tests hold the
native one against. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-pthread")


def _native_target() -> bytes:
    """What -march=native means on this host: a library built for one CPU
    may not run on another, so the target is part of the build's key."""
    proc = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True, timeout=60)
    return proc.stdout


def _build() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
        + _native_target()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libhostops_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LD_FLAGS],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    argtypes set. Raises when g++ fails."""
    lib = ctypes.CDLL(str(_build()))
    i64, c_int = ctypes.c_int64, ctypes.c_int
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    signatures = {
        "topk_merge": [f32p, i32p, i64, i64, i64, f32p, i32p, i64, c_int],
        "brute_topk_l2": [f32p, i64, i64, f32p, i64, i64, f32p, i32p, c_int],
        "quantize_int8": [f32p, i64, i64, i8p, f32p],
        "dequantize_int8": [i8p, f32p, i64, i64, f32p],
        "bm25_score_topk": [
            i64p, i64p, f32p, f32p, i64, i64, ctypes.c_float,
            i64p, f32p, i64p, i64, u8p, i64, f32p, i64p, c_int,
        ],
        "bm25_maxscore_topk": [
            i64p, i64p, f32p, f32p, i64, i64, ctypes.c_float,
            i64p, f32p, f32p, i64p, i64, u8p, i64, f32p, i64p, c_int,
        ],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


# ------------------------------------------------------------ top-k merge ---


def topk_merge(scores: np.ndarray, ids: np.ndarray, k: int,
               descending: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (S, Q, k_in) sorted per-shard candidates -> (Q, k) global top-k
    (ids < 0 are skipped; short rows pad with -1 and the worst score)."""
    scores = np.ascontiguousarray(scores, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    s, q, k_in = scores.shape
    out_s = np.empty((q, k), np.float32)
    out_i = np.empty((q, k), np.int32)
    load().topk_merge(scores, ids, s, q, k_in, out_s, out_i, k,
                      1 if descending else 0)
    return out_s, out_i


def topk_merge_plain(scores: np.ndarray, ids: np.ndarray, k: int,
                     descending: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """topk_merge by flatten + argsort."""
    scores = np.asarray(scores, np.float32)
    ids = np.asarray(ids, np.int32)
    s, q, k_in = scores.shape
    worst = -np.inf if descending else np.inf
    flat_s = scores.transpose(1, 0, 2).reshape(q, s * k_in)
    flat_i = ids.transpose(1, 0, 2).reshape(q, s * k_in)
    flat_s = np.where(flat_i < 0, worst, flat_s)
    order = np.argsort(-flat_s if descending else flat_s, axis=1,
                       kind="stable")[:, :k]
    out_s = np.take_along_axis(flat_s, order, axis=1)
    out_i = np.take_along_axis(flat_i, order, axis=1)
    out_i = np.where(np.isinf(out_s), -1, out_i)
    if k > s * k_in:
        pad = k - s * k_in
        out_s = np.pad(out_s, ((0, 0), (0, pad)), constant_values=worst)
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
    return out_s.astype(np.float32), out_i.astype(np.int32)


# ------------------------------------------------------------ brute force ---


def brute_topk_l2(corpus: np.ndarray, queries: np.ndarray, k: int,
                  nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact CPU brute-force squared-L2 top-k: ((Q, k) distances, ids)."""
    corpus = np.ascontiguousarray(corpus, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    n, d = corpus.shape
    q = queries.shape[0]
    out_d = np.empty((q, k), np.float32)
    out_i = np.empty((q, k), np.int32)
    load().brute_topk_l2(corpus, n, d, queries, q, k, out_d, out_i, nthreads)
    return out_d, out_i


def brute_topk_l2_plain(corpus: np.ndarray, queries: np.ndarray, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    corpus = np.asarray(corpus, np.float32)
    queries = np.asarray(queries, np.float32)
    n = corpus.shape[0]
    dists = (
        (queries ** 2).sum(1)[:, None]
        - 2.0 * queries @ corpus.T
        + (corpus ** 2).sum(1)[None, :]
    ).clip(min=0)
    kk = min(k, n)
    order = np.argsort(dists, axis=1, kind="stable")[:, :kk]
    out = np.take_along_axis(dists, order, axis=1)
    if kk < k:
        out = np.pad(out, ((0, 0), (0, k - kk)), constant_values=np.inf)
        order = np.pad(order, ((0, 0), (0, k - kk)), constant_values=-1)
    return out.astype(np.float32), order.astype(np.int32)


# ------------------------------------------------------------------ BM25 ---


def _bm25_args(indptr, post_docs, post_tfs, norm_cache, q_tids, q_idf,
               q_offsets, mask):
    return (np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(post_docs, np.int64),
            np.ascontiguousarray(post_tfs, np.float32),
            np.ascontiguousarray(norm_cache, np.float32),
            np.ascontiguousarray(q_tids, np.int64),
            np.ascontiguousarray(q_idf, np.float32),
            np.ascontiguousarray(q_offsets, np.int64),
            np.ascontiguousarray(mask, np.uint8))


def bm25_score_topk(indptr, post_docs, post_tfs, norm_cache, k1: float,
                    q_tids, q_idf, q_offsets, mask, k: int,
                    nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Batch BM25 over CSR postings: per query, walk its terms' postings,
    accumulate, and keep the top k. q_tids / q_idf are the queries' term ids
    and idfs concatenated, q_offsets their (Q + 1) bounds; norm_cache[d] =
    1 - b + b dl / avgdl; mask (n_docs,) excludes docs. Returns (Q, k)
    scores (0-padded) and ids (-1-padded), best first, ties by ascending doc
    id. Queries run in parallel on `nthreads` threads (0: every core)."""
    (indptr, post_docs, post_tfs, norm_cache, q_tids, q_idf, q_offsets,
     mask) = _bm25_args(indptr, post_docs, post_tfs, norm_cache, q_tids,
                        q_idf, q_offsets, mask)
    q = len(q_offsets) - 1
    out_s = np.zeros((q, k), np.float32)
    out_i = np.full((q, k), -1, np.int64)
    load().bm25_score_topk(
        indptr, post_docs, post_tfs, norm_cache, len(indptr) - 1,
        len(norm_cache), float(k1), q_tids, q_idf, q_offsets, q, mask, k,
        out_s, out_i, nthreads)
    return out_s, out_i


def bm25_maxscore_topk(indptr, post_docs, post_tfs, norm_cache, k1: float,
                       q_tids, q_idf, q_bounds, q_offsets, mask, k: int,
                       nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact DAAT MaxScore BM25 (see hostops.cpp): bm25_score_topk's
    results, with head-term postings probed instead of walked once the
    top-k threshold makes them non-essential. q_bounds: per query term, an
    upper bound on one doc's contribution."""
    (indptr, post_docs, post_tfs, norm_cache, q_tids, q_idf, q_offsets,
     mask) = _bm25_args(indptr, post_docs, post_tfs, norm_cache, q_tids,
                        q_idf, q_offsets, mask)
    q_bounds = np.ascontiguousarray(q_bounds, np.float32)
    q = len(q_offsets) - 1
    out_s = np.zeros((q, k), np.float32)
    out_i = np.full((q, k), -1, np.int64)
    load().bm25_maxscore_topk(
        indptr, post_docs, post_tfs, norm_cache, len(indptr) - 1,
        len(norm_cache), float(k1), q_tids, q_idf, q_bounds, q_offsets, q,
        mask, k, out_s, out_i, nthreads)
    return out_s, out_i


def bm25_score_topk_plain(indptr, post_docs, post_tfs, norm_cache, k1: float,
                          q_tids, q_idf, q_offsets, mask, k: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """bm25_score_topk in numpy (both native scorers' contract), each
    contribution in fp32 as the C++ computes it."""
    indptr = np.asarray(indptr, np.int64)
    post_docs = np.asarray(post_docs, np.int64)
    post_tfs = np.asarray(post_tfs, np.float32)
    norm_cache = np.asarray(norm_cache, np.float32)
    mask = np.asarray(mask, bool)
    n = len(norm_cache)
    k1 = np.float32(k1)
    q = len(q_offsets) - 1
    out_s = np.zeros((q, k), np.float32)
    out_i = np.full((q, k), -1, np.int64)
    for qi in range(q):
        scores = np.zeros((n,), np.float32)
        for t in range(q_offsets[qi], q_offsets[qi + 1]):
            tid = q_tids[t]
            if tid < 0 or tid >= len(indptr) - 1:
                continue
            docs = post_docs[indptr[tid]:indptr[tid + 1]]
            tf = post_tfs[indptr[tid]:indptr[tid + 1]]
            scores[docs] += (np.float32(q_idf[t]) * tf * (k1 + np.float32(1))
                             / (tf + k1 * norm_cache[docs]))
        live = np.flatnonzero((scores > 0) & mask)
        order = np.lexsort((live, -scores[live]))[:k]
        out_i[qi, :len(order)] = live[order]
        out_s[qi, :len(order)] = scores[live[order]]
    return out_s, out_i


# ---------------------------------------------------------- quantization ---


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise symmetric int8 quantization -> (values int8, scales fp32)."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    values = np.empty((n, d), np.int8)
    scales = np.empty((n,), np.float32)
    load().quantize_int8(x, n, d, values, scales)
    return values, scales


def quantize_int8_plain(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=1)
    scales = np.where(amax > 0, amax / np.float32(127.0), 1.0).astype(np.float32)
    # half away from zero, as the C++ lround (np.round is half to even)
    v = x / scales[:, None]
    values = (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int8)
    return values, scales


def dequantize_int8(values: np.ndarray, scales: np.ndarray) -> np.ndarray:
    values = np.ascontiguousarray(values, np.int8)
    scales = np.ascontiguousarray(scales, np.float32)
    n, d = values.shape
    out = np.empty((n, d), np.float32)
    load().dequantize_int8(values, scales, n, d, out)
    return out


def dequantize_int8_plain(values: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return (np.asarray(values, np.float32)
            * np.asarray(scales, np.float32)[:, None])
