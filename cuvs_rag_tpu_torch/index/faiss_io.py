"""FAISS binary index interop — read/write `faiss.write_index` files.

The reference's flagship pipeline STARTS from a prebuilt FAISS index on
disk (`faiss.read_index(path)` of a 6.29M x 384 Wikipedia IndexFlatL2,
/root/reference/Latest/faiss-main.ipynb#cell8). A user switching from the
reference holds such artifacts; this module parses the FAISS binary format
directly — no faiss dependency — and converts to the port's index
families on the card (or the device the caller names), plus the reverse
direction (export) so indexes remain portable back to a FAISS deployment.

The port of the JAX package's `index/faiss_io.py`: the parsers and
writers are its numpy code, so both packages write the same bytes for the
same index; the conversions lay rows out with this package's own layout
code (`ivf_flat._layout`, `ivf_pq._pq_layout`). The file's coarse
quantizer and list assignment are kept exactly: no re-clustering.

Format coverage (faiss >= 1.7 on-disk layout, impl/index_write.cpp):
  * IndexFlat      — fourccs "IxF2" (L2), "IxFI" (IP), "IxFl" (generic)
  * IndexIVFFlat   — fourcc "IwFl" with an ArrayInvertedLists "ilar"/"full"
    payload and an IndexFlat coarse quantizer
  * IndexPQ        — fourcc "IxPq" (nbits=8 only)
  * IndexIVFPQ     — fourcc "IwPQ" (nbits=8, by_residual; the reference's
    compressed family — cuVS ivf_pq at
    Attempt_1/index_building_coordinator.py:398-404 — has IndexIVFPQ as
    its on-disk analogue, VERDICT r3 #7)
Anything else (HNSW, ID-mapped/PreTransform wrappers, IVFPQR, fastscan,
sparse/mmap list payloads) raises with the offending fourcc so the
failure is diagnosable.

Layout notes (all little-endian):
  header  = fourcc u32 | d i32 | ntotal i64 | dummy i64 x2 (=1<<20)
          | is_trained u8 | metric_type i32 | [metric_arg f32 if metric>1]
  IndexFlat payload   = nfloat u64 | f32 x nfloat         (codes as floats)
  ProductQuantizer    = d u64 | M u64 | nbits u64
                      | ncent u64 | f32 x ncent  (M * 2^nbits * d/M floats)
  IndexPQ             = header | ProductQuantizer
                      | ncodes u64 | u8 x ncodes (ntotal * M for nbits=8)
                      | search_type i32 | encode_signs u8 | polysemous_ht i32
  IndexIVFFlat        = header | nlist u64 | nprobe u64
                      | <nested quantizer index>
                      | direct_map: type u8 | n u64 | i64 x n
                      | invlists: "ilar" u32 | nlist u64 | code_size u64
                      | "full" u32 | nsz u64 | u64 x nsz (list sizes)
                      | per list: f32 codes (n*d) then i64 ids (n)
  IndexIVFPQ          = header | nlist u64 | nprobe u64 | <quantizer>
                      | direct_map | by_residual u8 | code_size u64
                      | ProductQuantizer
                      | invlists (code_size = M bytes/row for nbits=8)

Two-level note: the native IVFPQIndex stores 8-bit codes as ADDITIVE
nibble pairs r̂ = CB1[c&15] + CB2[c>>4] (ops/pq.train_two_level_codebooks,
the layout the K6 kernel scans). The additive form expands EXACTLY to a
flat 256-entry FAISS codebook (flat[c] = CB1[c&15] + CB2[c>>4]) with the
SAME code bytes, so export is reconstruction-exact; imports land as
levels=1 flat-codebook indexes (two_level=False), whose unpacked codes the
search scans with ops/pq.scan_probed_lists_pq, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO

import numpy as np

import torch

from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric

# FAISS MetricType enum values (faiss/MetricType.h)
_METRIC_INNER_PRODUCT = 0
_METRIC_L2 = 1

_METRIC_TO_NATIVE = {
    _METRIC_INNER_PRODUCT: Metric.INNER_PRODUCT,
    _METRIC_L2: Metric.SQEUCLIDEAN,
}
_NATIVE_TO_METRIC = {
    Metric.INNER_PRODUCT: _METRIC_INNER_PRODUCT,
    Metric.SQEUCLIDEAN: _METRIC_L2,
    # cosine rows are stored L2-normalized, so IP order is cosine order —
    # the closest FAISS equivalent of our cosine index is an IP index over
    # the normalized vectors (standard FAISS practice).
    Metric.COSINE: _METRIC_INNER_PRODUCT,
}


@dataclasses.dataclass
class FaissFlat:
    """Parsed IndexFlat content."""

    vectors: np.ndarray  # (ntotal, d) float32
    metric: str  # native Metric string

    @property
    def ntotal(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]


@dataclasses.dataclass
class FaissIVFFlat:
    """Parsed IndexIVFFlat content (reassembled to original-id order)."""

    vectors: np.ndarray  # (ntotal, d) float32, row r = original id r
    labels: np.ndarray  # (ntotal,) int32 list assignment
    centroids: np.ndarray  # (nlist, d) float32 coarse quantizer
    metric: str
    nprobe: int  # the file's stored default

    @property
    def ntotal(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]


@dataclasses.dataclass
class FaissPQ:
    """Parsed IndexPQ content (standalone PQ, no coarse quantizer)."""

    codes: np.ndarray  # (ntotal, M) uint8, row r = original id r
    codebooks: np.ndarray  # (M, 256, d/M) float32
    metric: str
    d: int

    @property
    def ntotal(self) -> int:
        return self.codes.shape[0]

    @property
    def m(self) -> int:
        return self.codes.shape[1]


@dataclasses.dataclass
class FaissIVFPQ:
    """Parsed IndexIVFPQ content (reassembled to original-id order)."""

    codes: np.ndarray  # (ntotal, M) uint8, row r = original id r
    labels: np.ndarray  # (ntotal,) int32 list assignment
    codebooks: np.ndarray  # (M, 256, d/M) float32
    centroids: np.ndarray  # (nlist, d) float32 coarse quantizer
    metric: str
    nprobe: int
    d: int

    @property
    def ntotal(self) -> int:
        return self.codes.shape[0]

    @property
    def m(self) -> int:
        return self.codes.shape[1]


# ----------------------------------------------------------------- reading


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise ValueError("truncated FAISS index file")
    out = struct.unpack("<" + fmt, buf)
    return out[0] if len(out) == 1 else out


def _read_fourcc(f: BinaryIO) -> str:
    buf = f.read(4)
    if len(buf) != 4:
        raise ValueError("truncated FAISS index file (fourcc)")
    return buf.decode("latin1")


def _read_array(f: BinaryIO, dtype, count: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    buf = f.read(dtype.itemsize * count)
    if len(buf) != dtype.itemsize * count:
        raise ValueError("truncated FAISS index file (array)")
    return np.frombuffer(buf, dtype=dtype).copy()


def _read_header(f: BinaryIO):
    d = _read(f, "i")
    ntotal = _read(f, "q")
    _read(f, "qq")  # two dummy i64 fields (always 1<<20)
    is_trained = _read(f, "B")
    metric_type = _read(f, "i")
    if metric_type > 1:
        _read(f, "f")  # metric_arg — parsed but unused
    if metric_type not in _METRIC_TO_NATIVE:
        raise ValueError(
            f"unsupported FAISS metric_type {metric_type} "
            "(only L2 and inner-product indexes are importable)"
        )
    if d <= 0 or ntotal < 0:
        raise ValueError(f"implausible FAISS header: d={d} ntotal={ntotal}")
    return d, ntotal, bool(is_trained), _METRIC_TO_NATIVE[metric_type]


def _read_flat_body(f: BinaryIO, d: int, ntotal: int) -> np.ndarray:
    nfloat = _read(f, "Q")  # stored as float count (READXBVECTOR)
    if nfloat != d * ntotal:
        raise ValueError(
            f"IndexFlat size mismatch: file says {nfloat} floats, "
            f"header implies {d * ntotal}"
        )
    return _read_array(f, np.float32, nfloat).reshape(ntotal, d)


def _read_index_any(f: BinaryIO):
    fourcc = _read_fourcc(f)
    if fourcc in ("IxF2", "IxFI", "IxFl"):
        d, ntotal, _, metric = _read_header(f)
        return FaissFlat(vectors=_read_flat_body(f, d, ntotal), metric=metric)
    if fourcc == "IwFl":
        return _read_ivf_flat(f)
    if fourcc == "IxPq":
        return _read_pq(f)
    if fourcc == "IwPQ":
        return _read_ivf_pq(f)
    raise ValueError(
        f"unsupported FAISS index type {fourcc!r} — supported: IndexFlatL2/"
        "IndexFlatIP (IxF2/IxFI/IxFl), IndexIVFFlat (IwFl), IndexPQ (IxPq) "
        "and IndexIVFPQ (IwPQ)"
    )


def _read_ivf_common(f: BinaryIO):
    """header | nlist | nprobe | quantizer | direct_map — shared by every
    IndexIVF* subtype (faiss read_ivf_header)."""
    d, ntotal, _, metric = _read_header(f)
    nlist = _read(f, "Q")
    nprobe = _read(f, "Q")
    quantizer = _read_index_any(f)  # nested index, almost always IndexFlat
    if not isinstance(quantizer, FaissFlat):
        raise ValueError("IVF quantizer is not an IndexFlat — unsupported")
    if quantizer.ntotal != nlist or quantizer.d != d:
        raise ValueError(
            f"quantizer shape {quantizer.vectors.shape} inconsistent with "
            f"nlist={nlist}, d={d}"
        )
    # direct map: type byte + WRITEVECTOR(array of i64)
    dm_type = _read(f, "B")
    dm_n = _read(f, "Q")
    _read_array(f, np.int64, dm_n)
    if dm_type == 2:
        raise ValueError("hashtable direct maps are unsupported")
    return d, ntotal, metric, int(nlist), int(nprobe), quantizer


def _read_invlists_bytes(f: BinaryIO, nlist: int, ntotal: int,
                         code_size: int):
    """ArrayInvertedLists payload: yields the raw per-row code bytes and
    original-id placement. Returns (codes (ntotal, code_size) u8 in
    original-id order, labels (ntotal,) i32)."""
    il = _read_fourcc(f)
    if il != "ilar":
        raise ValueError(
            f"inverted-list payload {il!r} unsupported (only in-file "
            "ArrayInvertedLists 'ilar')"
        )
    il_nlist = _read(f, "Q")
    file_code_size = _read(f, "Q")
    if il_nlist != nlist:
        raise ValueError(f"list count mismatch: {il_nlist} vs {nlist}")
    if file_code_size != code_size:
        raise ValueError(
            f"code_size {file_code_size} != expected {code_size}"
        )
    list_fmt = _read_fourcc(f)
    if list_fmt != "full":
        raise ValueError(
            f"inverted-list storage {list_fmt!r} unsupported (only 'full')"
        )
    nsz = _read(f, "Q")
    if nsz != nlist:
        raise ValueError(f"sizes vector length {nsz} != nlist {nlist}")
    sizes = _read_array(f, np.uint64, nsz).astype(np.int64)
    if int(sizes.sum()) != ntotal:
        raise ValueError(
            f"list sizes sum {int(sizes.sum())} != ntotal {ntotal}"
        )
    codes = np.empty((ntotal, code_size), np.uint8)
    labels = np.empty((ntotal,), np.int32)
    seen = np.zeros((ntotal,), bool)
    for li in range(nlist):
        n = int(sizes[li])
        if n == 0:
            continue
        row_codes = _read_array(f, np.uint8, n * code_size)
        ids = _read_array(f, np.int64, n)
        if (ids < 0).any() or (ids >= ntotal).any():
            raise ValueError(
                "IVF ids outside [0, ntotal) — add_with_ids indexes need an "
                "explicit id remap before import"
            )
        codes[ids] = row_codes.reshape(n, code_size)
        labels[ids] = li
        seen[ids] = True
    if not seen.all():
        raise ValueError("duplicate/missing ids in IVF lists")
    return codes, labels


def _read_ivf_flat(f: BinaryIO) -> FaissIVFFlat:
    d, ntotal, metric, nlist, nprobe, quantizer = _read_ivf_common(f)
    codes, labels = _read_invlists_bytes(f, nlist, ntotal, 4 * d)
    vectors = codes.view(np.float32).reshape(ntotal, d)
    return FaissIVFFlat(
        vectors=vectors, labels=labels, centroids=quantizer.vectors,
        metric=metric, nprobe=nprobe,
    )


def _read_product_quantizer(f: BinaryIO):
    """ProductQuantizer block -> (M, 256, dsub) float32 (nbits=8 only)."""
    d = _read(f, "Q")
    m = _read(f, "Q")
    nbits = _read(f, "Q")
    if nbits != 8:
        raise ValueError(
            f"PQ nbits={nbits} unsupported (only 8-bit flat codebooks; "
            "4-bit fastscan files use a different index type)"
        )
    if d == 0 or m == 0 or d % m:
        raise ValueError(f"implausible PQ geometry d={d} M={m}")
    ncent = _read(f, "Q")
    ksub, dsub = 256, d // m
    if ncent != m * ksub * dsub:
        raise ValueError(
            f"PQ centroid count {ncent} != M*256*dsub={m * ksub * dsub}"
        )
    cents = _read_array(f, np.float32, ncent)
    return int(d), int(m), cents.reshape(m, ksub, dsub)


def _read_pq(f: BinaryIO) -> FaissPQ:
    d, ntotal, _, metric = _read_header(f)
    pq_d, m, codebooks = _read_product_quantizer(f)
    if pq_d != d:
        raise ValueError(f"PQ dim {pq_d} != index dim {d}")
    ncodes = _read(f, "Q")
    if ncodes != ntotal * m:
        raise ValueError(
            f"IndexPQ code bytes {ncodes} != ntotal*M={ntotal * m}"
        )
    codes = _read_array(f, np.uint8, ncodes).reshape(ntotal, m)
    _read(f, "i")  # search_type — parsed but unused
    _read(f, "B")  # encode_signs
    _read(f, "i")  # polysemous_ht
    return FaissPQ(codes=codes, codebooks=codebooks, metric=metric, d=d)


def _read_ivf_pq(f: BinaryIO) -> FaissIVFPQ:
    d, ntotal, metric, nlist, nprobe, quantizer = _read_ivf_common(f)
    by_residual = _read(f, "B")
    code_size = _read(f, "Q")
    pq_d, m, codebooks = _read_product_quantizer(f)
    if pq_d != d:
        raise ValueError(f"PQ dim {pq_d} != index dim {d}")
    if code_size != m:
        raise ValueError(
            f"code_size {code_size} != M={m} — not an 8-bit IVFPQ payload"
        )
    if not by_residual:
        raise ValueError(
            "IndexIVFPQ with by_residual=False is unsupported — the native "
            "ivf_pq family encodes residuals against the coarse centroid "
            "(the FAISS default); re-train with by_residual=True"
        )
    codes, labels = _read_invlists_bytes(f, nlist, ntotal, m)
    return FaissIVFPQ(
        codes=codes, labels=labels, codebooks=codebooks,
        centroids=quantizer.vectors, metric=metric, nprobe=nprobe, d=d,
    )


def read_index(path: str):
    """Parse a `faiss.write_index` file -> FaissFlat | FaissIVFFlat."""
    with open(path, "rb") as f:
        out = _read_index_any(f)
        trailing = f.read(1)
    if trailing:
        raise ValueError("trailing bytes after FAISS index payload")
    return out


# ----------------------------------------------------------------- writing


def _write(f: BinaryIO, fmt: str, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _write_header(f: BinaryIO, fourcc: str, d: int, ntotal: int, metric: str):
    f.write(fourcc.encode("latin1"))
    _write(f, "i", d)
    _write(f, "q", ntotal)
    _write(f, "qq", 1 << 20, 1 << 20)
    _write(f, "B", 1)  # is_trained
    _write(f, "i", _NATIVE_TO_METRIC[metric])


def _write_flat(f: BinaryIO, vectors: np.ndarray, metric: str):
    v = np.ascontiguousarray(vectors, np.float32)
    ntotal, d = v.shape
    fourcc = "IxFI" if _NATIVE_TO_METRIC[metric] == _METRIC_INNER_PRODUCT \
        else "IxF2"
    _write_header(f, fourcc, d, ntotal, metric)
    _write(f, "Q", ntotal * d)
    f.write(v.tobytes())


def _write_ivf_flat(f: BinaryIO, vectors, labels, centroids, metric,
                    nprobe: int = 1):
    v = np.ascontiguousarray(vectors, np.float32)
    lb = np.asarray(labels, np.int64)
    cents = np.ascontiguousarray(centroids, np.float32)
    ntotal, d = v.shape
    nlist = cents.shape[0]
    _write_header(f, "IwFl", d, ntotal, metric)
    _write(f, "QQ", nlist, nprobe)
    _write_flat(f, cents, metric)  # nested quantizer
    _write(f, "B", 0)  # DirectMap::NoMap
    _write(f, "Q", 0)  # empty direct-map array
    f.write(b"ilar")
    _write(f, "QQ", nlist, 4 * d)
    f.write(b"full")
    order = np.argsort(lb, kind="stable")
    sizes = np.bincount(lb, minlength=nlist).astype(np.uint64)
    _write(f, "Q", nlist)
    f.write(sizes.tobytes())
    off = 0
    for li in range(nlist):
        n = int(sizes[li])
        if n == 0:
            continue
        ids = order[off:off + n]
        off += n
        f.write(np.ascontiguousarray(v[ids]).tobytes())
        f.write(ids.astype(np.int64).tobytes())


def _write_product_quantizer(f: BinaryIO, codebooks: np.ndarray):
    m, ksub, dsub = codebooks.shape
    assert ksub == 256, ksub
    _write(f, "QQQ", m * dsub, m, 8)  # d, M, nbits
    _write(f, "Q", m * ksub * dsub)
    f.write(np.ascontiguousarray(codebooks, np.float32).tobytes())


def _write_pq(f: BinaryIO, codes: np.ndarray, codebooks: np.ndarray,
              metric: str):
    ntotal, m = codes.shape
    d = codebooks.shape[0] * codebooks.shape[2]
    _write_header(f, "IxPq", d, ntotal, metric)
    _write_product_quantizer(f, codebooks)
    _write(f, "Q", ntotal * m)
    f.write(np.ascontiguousarray(codes, np.uint8).tobytes())
    _write(f, "i", 0)  # search_type = ST_PQ
    _write(f, "B", 0)  # encode_signs
    _write(f, "i", 0)  # polysemous_ht


def _write_ivf_pq(f: BinaryIO, codes: np.ndarray, labels: np.ndarray,
                  codebooks: np.ndarray, centroids: np.ndarray,
                  metric: str, nprobe: int = 1):
    codes = np.ascontiguousarray(codes, np.uint8)
    lb = np.asarray(labels, np.int64)
    cents = np.ascontiguousarray(centroids, np.float32)
    ntotal, m = codes.shape
    nlist, d = cents.shape
    _write_header(f, "IwPQ", d, ntotal, metric)
    _write(f, "QQ", nlist, nprobe)
    _write_flat(f, cents, metric)  # nested quantizer
    _write(f, "B", 0)  # DirectMap::NoMap
    _write(f, "Q", 0)  # empty direct-map array
    _write(f, "B", 1)  # by_residual (the native encoding)
    _write(f, "Q", m)  # code_size
    _write_product_quantizer(f, codebooks)
    f.write(b"ilar")
    _write(f, "QQ", nlist, m)
    f.write(b"full")
    order = np.argsort(lb, kind="stable")
    sizes = np.bincount(lb, minlength=nlist).astype(np.uint64)
    _write(f, "Q", nlist)
    f.write(sizes.tobytes())
    off = 0
    for li in range(nlist):
        n = int(sizes[li])
        if n == 0:
            continue
        ids = order[off:off + n]
        off += n
        f.write(np.ascontiguousarray(codes[ids]).tobytes())
        f.write(ids.astype(np.int64).tobytes())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pq_export_parts(index):
    """Native IVFPQIndex -> (codes (nlive, M) u8 original-id order,
    labels (nlive,), flat (M, 256, dsub) codebooks, centroids (C, d)).

    Two-level additive codebooks expand EXACTLY to a flat 256-entry
    codebook (flat[c] = CB1[c & 15] + CB2[c >> 4] — ops/pq.pack_nibbles
    order) with the stored code bytes unchanged, so the FAISS
    reconstruction is bit-identical to the native one. Deleted rows are
    dropped and ids compacted (FAISS has no tombstones — same policy as
    the IVFFlat exporter)."""
    m = index.pq_dim
    if index.rotation.shape[0]:
        raise ValueError(
            "OPQ-rotated indexes cannot be exported (FAISS stores the "
            "rotation in an IndexPreTransform wrapper this writer does not "
            "produce); build with opq=False for FAISS-portable indexes"
        )
    if index.levels == 1 and (
        index.codes_packed or index.codebooks.shape[1] != 256
    ):
        raise ValueError(
            "4-bit fastscan codes are not exportable to IndexIVFPQ "
            "(FAISS packs nbits=4 differently); build with pq_bits=8"
        )
    if index.padded_dim != index.dim:
        raise ValueError(
            f"dim {index.dim} is not a multiple of pq_dim {m}; the padded "
            "subspace layout has no FAISS equivalent — pick pq_dim "
            "dividing dim for FAISS-portable indexes"
        )
    cb = _host(index.codebooks).astype(np.float32)
    if index.levels == 2:
        c = np.arange(256)
        flat_cb = cb[:m, c & 15, :] + cb[m:, c >> 4, :]  # (m, 256, ds)
    else:
        flat_cb = cb
    codes_sm = _host(index.codes)  # (m, cap) stream-major
    row_ids = _host(index.row_ids)
    offs = _host(index.list_offsets)
    cnts = _host(index.list_counts)
    slot_lists = np.full((codes_sm.shape[1],), -1, np.int64)
    for li in range(len(offs)):
        slot_lists[offs[li]:offs[li] + cnts[li]] = li
    live = (row_ids >= 0) & (slot_lists >= 0)
    orig = row_ids[live]
    order = np.argsort(orig, kind="stable")
    codes_rm = codes_sm[:, live].T[order]  # (nlive, m) original-id order
    labels = slot_lists[live][order].astype(np.int32)
    cents = _host(index.centroids).astype(np.float32)[:, :index.dim]
    return codes_rm, labels, flat_cb, cents


def write_index(index, path: str) -> None:
    """Export to the FAISS binary format (readable by `faiss.read_index`).

    Accepts a parsed FaissFlat/FaissIVFFlat/FaissPQ/FaissIVFPQ, or a
    native FlatIndex/IVFFlatIndex/IVFPQIndex on any device. Native indexes
    export their fp32 reconstruction (int8 storage dequantizes; deleted
    rows are dropped — FAISS has no tombstones). Cosine indexes export as
    IP over the stored normalized rows (equivalent ordering). IVFPQIndex
    exports as IndexIVFPQ — two-level codebooks expand exactly (see
    _pq_export_parts); a single-list index exports as IndexPQ only via
    the parsed FaissPQ form.
    """
    from cuvs_rag_tpu_torch.index import ivf_flat as ivf_mod
    from cuvs_rag_tpu_torch.index.io import deleted_row_ids

    with open(path, "wb") as f:
        if isinstance(index, FaissFlat):
            _write_flat(f, index.vectors, index.metric)
        elif isinstance(index, FaissIVFFlat):
            _write_ivf_flat(f, index.vectors, index.labels, index.centroids,
                            index.metric, index.nprobe)
        elif isinstance(index, FaissPQ):
            _write_pq(f, index.codes, index.codebooks, index.metric)
        elif isinstance(index, FaissIVFPQ):
            _write_ivf_pq(f, index.codes, index.labels, index.codebooks,
                          index.centroids, index.metric, index.nprobe)
        elif type(index).__name__ == "IVFPQIndex":
            codes, labels, flat_cb, cents = _pq_export_parts(index)
            _write_ivf_pq(f, codes, labels, flat_cb, cents, index.metric)
        elif type(index).__name__ == "FlatIndex":
            nv = int(index.n_valid)
            v = (_host(index.vectors[:nv].float())
                 * _host(index.scales[:nv].float())[:, None])
            gone = deleted_row_ids(index)
            if len(gone):
                v = np.delete(v, gone, axis=0)
            _write_flat(f, v, index.metric)
        elif type(index).__name__ == "IVFFlatIndex":
            nv = int(index.n_valid)
            if index.vectors.dtype == torch.int8:
                vecs, labels = _reconstruct_once(index, nv)
            else:
                vecs, labels = ivf_mod._recover_rows(index, nv)
                vecs = _host(vecs.float())
            labels = _host(labels).astype(np.int64)
            gone = deleted_row_ids(index)
            if len(gone):
                keep = np.setdiff1d(np.arange(len(vecs)), gone)
                vecs, labels = vecs[keep], labels[keep]
            _write_ivf_flat(f, vecs, labels, _host(index.centroids.float()),
                            index.metric)
        else:
            raise TypeError(f"cannot export {type(index).__name__}")


def _reconstruct_once(index, nv: int, chunk: int = 65_536):
    """((nv, D) fp32 rows x̂ = c + s·r, (nv,) labels) of an int8 IVF-Flat
    layout in original-id order (`ivf_flat._recover_rows`), each row value
    rounded once from the exact one (computed in fp64 a chunk at a time):
    the JAX package's reconstruction, which XLA fuses into one multiply-add,
    so both packages write the same bytes."""
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops

    slot_of, label_of_slot = ivf_ops.invert_layout(
        index.row_ids, index.list_offsets, nv)
    slot_of = slot_of.long()
    cents = index.centroids.double()
    out = np.empty((nv, index.dim), np.float32)
    for i in range(0, nv, chunk):
        slots = slot_of[i:i + chunk]
        rows = (cents[label_of_slot[slots].long()]
                + index.scales[slots].double()[:, None]
                * index.vectors[slots].double())
        out[i:i + chunk] = _host(rows.float())
    return out, label_of_slot[slot_of]


# -------------------------------------------------------------- conversion


def _padded_labels(labels: np.ndarray, n_lists: int, device):
    """(labels padded to a multiple of 8 rows, valid mask, n_pad, window,
    capacity) of a file's list assignment, as the native layouts take
    them: the window covers the longest list, so no row is truncated."""
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    n = labels.shape[0]
    n_pad = topk_ops.round_up(n, 8)
    lab = torch.from_numpy(
        np.pad(labels, (0, n_pad - n)).astype(np.int32)).to(device)
    valid = torch.arange(n_pad, device=device) < n
    counts = np.bincount(labels, minlength=n_lists)
    max_list = topk_ops.round_up(max(int(counts.max()), 8), ivf_ops.ALIGN)
    capacity = ivf_ops.capacity_for(n_pad, n_lists, max_list)
    return lab, valid, n_pad, max_list, capacity


def to_flat_index(parsed: FaissFlat, dtype: str = "auto", *, device=None):
    """FaissFlat -> native FlatIndex (exact same vectors and metric) on
    `device` (None: the card)."""
    from cuvs_rag_tpu_torch.index import flat

    return flat.build(
        FlatParams(metric=parsed.metric, dtype=dtype), parsed.vectors,
        device=device,
    )


def to_ivf_flat_index(parsed: FaissIVFFlat, dtype: str = "auto", *,
                      device=None):
    """FaissIVFFlat -> native IVFFlatIndex on `device` (None: the card)
    with the FILE's coarse quantizer and list assignment preserved exactly
    (no re-clustering — a FAISS-built and an imported index probe
    identical lists)."""
    from cuvs_rag_tpu_torch.index import base as base_mod
    from cuvs_rag_tpu_torch.index import ivf_flat as ivf_mod
    from cuvs_rag_tpu_torch.ops import topk as topk_ops

    dev = base_mod.resolve_device(device)
    n = parsed.ntotal
    n_lists = parsed.centroids.shape[0]
    sdtype = base_mod.storage_dtype(dtype, torch.float32)
    labels, valid, n_pad, max_list, capacity = _padded_labels(
        parsed.labels, n_lists, dev)
    vectors = torch.from_numpy(np.ascontiguousarray(parsed.vectors)).to(dev)
    if sdtype != torch.int8:
        vectors = vectors.to(sdtype)
    centroids = torch.from_numpy(
        np.ascontiguousarray(parsed.centroids, np.float32)).to(dev)
    return ivf_mod._layout(
        topk_ops.pad_rows(vectors, n_pad), labels, valid, centroids, n,
        parsed.metric, sdtype, capacity=capacity, max_list=max_list,
    )


def to_ivf_pq_index(parsed, *, device=None):
    """FaissPQ | FaissIVFPQ -> native IVFPQIndex on `device` (None: the
    card), levels=1 with flat 256-entry codebooks (the FAISS-compatible
    pq_bits=8 two_level=False variant) and the FILE's quantizer, codebooks
    and codes preserved exactly: a FAISS-built and an imported index probe
    identical lists and produce identical reconstructions. Its unpacked
    codes are scanned by ops/pq.scan_probed_lists_pq, not the K6 kernel.

    A standalone IndexPQ lands as a single-list IVF-PQ whose coarse
    centroid is the origin (residual-vs-zero == IndexPQ's raw encoding);
    search it with n_probes=1.
    """
    from cuvs_rag_tpu_torch.index import base as base_mod
    from cuvs_rag_tpu_torch.index import ivf_pq as pq_mod
    from cuvs_rag_tpu_torch.ops import distance as dist_ops

    dev = base_mod.resolve_device(device)
    if isinstance(parsed, FaissPQ):
        labels_np = np.zeros((parsed.ntotal,), np.int32)
        centroids_np = np.zeros((1, parsed.d), np.float32)
    else:
        labels_np = parsed.labels
        centroids_np = parsed.centroids
    m, d = parsed.m, parsed.d
    n = parsed.ntotal
    n_lists = centroids_np.shape[0]
    labels, valid, n_pad, max_list, capacity = _padded_labels(
        labels_np, n_lists, dev)
    codes_pad = np.zeros((n_pad, m), np.uint8)
    codes_pad[:n] = parsed.codes
    centroids = torch.from_numpy(
        np.ascontiguousarray(centroids_np, np.float32)).to(dev)
    sorted_codes, row_ids, offsets, counts, raw, raw_sq, sorted_corr = (
        pq_mod._pq_layout(
            torch.from_numpy(codes_pad).to(dev),
            torch.zeros((0, d), dtype=torch.bfloat16, device=dev),  # no raw
            labels, valid, torch.zeros((0,), dtype=torch.float32, device=dev),
            n_lists=n_lists, capacity=capacity, max_list_size=max_list,
            store_raw=False,
        )
    )
    return pq_mod.IVFPQIndex(
        codes=sorted_codes,
        row_ids=row_ids,
        centroids=centroids,
        centroid_sqnorms=dist_ops.sqnorms(centroids),
        codebooks=torch.from_numpy(
            np.ascontiguousarray(parsed.codebooks, np.float32)).to(dev),
        list_offsets=offsets,
        list_counts=counts,
        raw_vectors=raw,
        raw_sqnorms=raw_sq,
        norm_corr=sorted_corr,
        rotation=torch.zeros((0, 0), dtype=torch.float32, device=dev),
        n_valid=n,
        metric=parsed.metric,
        max_list_size=max_list,
        dim=d,
        levels=1,
    )


def import_index(path: str, dtype: str = "auto", *, device=None):
    """One-call migration: FAISS file -> the matching native index on
    `device` (None: the card).

    Returns (family_name, index): ("flat", FlatIndex), ("ivf_flat",
    IVFFlatIndex) or ("ivf_pq", IVFPQIndex — also for standalone IndexPQ
    files, as a single-list index). The reference's `faiss.read_index` +
    `index_cpu_to_gpus_list` flow becomes `import_index`.
    """
    parsed = read_index(path)
    if isinstance(parsed, FaissFlat):
        return "flat", to_flat_index(parsed, dtype, device=device)
    if isinstance(parsed, (FaissPQ, FaissIVFPQ)):
        return "ivf_pq", to_ivf_pq_index(parsed, device=device)
    return "ivf_flat", to_ivf_flat_index(parsed, dtype, device=device)
