"""Streaming-read and scattered-gather measurement kernels (M1-M4), and their
plain PyTorch versions.

The counterparts of the JAX package's four measurement kernels under
`scripts/`: `read_all` (M1, `bench_roofline.py:70`), `pallas_gather` (M2,
`bench_gather_modes.py:60`, and M4, `bench_pallas_gather.py:61`, its span =
1 case) and `pallas_gather_reduce` (M3, `bench_gather_modes.py:198`). Each
wrapper launches the hand-written CUDA kernel of `csrc/stream.cu` on a CUDA
tensor and runs its `_plain` version on a CPU tensor — never a fallback from
one to the other — and counts its kernel launches in `.launches`.

The kernels take plain (n, d) rows: the TPU scripts' `(n, sub, 128)` 3-D
view, their `sub_pad` padding, the `tile_c` sweep and the `rows` per grid
step (a DMA-semaphore count) are Mosaic parameters and have no counterpart.

- `read_all(corpus, full_reduce)`: corpus (n, d) bf16, d a multiple of 128
  -> (8, 128) fp32. "reduce" (`full_reduce=True`): out[r, c] = max over rows
  = r (mod 8) and columns = c (mod 128). "touch": every byte is still read,
  and only the `[:8, :128]` corner of each TILE_ROWS-row tile is folded:
  out[r, c] = max over tiles t of corpus[t * TILE_ROWS + r, c]. A maximum
  does not depend on the order it is taken in: kernel and plain version are
  equal bit for bit.
- `gather_rows(vectors, ids, span=1)`: out[i * span + t] = vectors[ids[i] +
  t]; rows of any dtype whose byte length is a multiple of 16. A copy: equal
  bit for bit.
- `gather_reduce(vectors, ids)`: the fp32 sum (d,) of the gathered rows,
  with no write-back of the rows; bf16, int8 or fp32 rows of at most 4096
  bytes. The kernel adds in another order than `.float().sum(0)`, always
  the same one: rtol 1e-4 / atol 2e-3 at 131,072 rows of unit-variance
  values (the TPU script held its kernel to rtol 2e-2).

ids out of range are the caller's bug and would read outside the tensor, so
the wrappers check them on the host (one device -> host read); a caller
that has checked its ids once and times repeated calls passes
`check_ids=False`.
"""

from __future__ import annotations

import functools
import math

import torch

_SOURCE = "stream.cu"
TILE_ROWS = 1024  # the tile of read_all's "touch" mode
_MAX_BLOCKS = 132 * 8  # blocks of 256 threads that the card holds at once
# read_all's grid, 4 blocks an SM: grids of 2 to 32 an SM read within 2% of
# each other on an H100 (700 W)
_READ_BLOCKS = 132 * 4
_THREADS = 256
_GATHER_MAX_BLOCKS = 1 << 20  # beyond it a group walks several segments
_REDUCE_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def _check_corpus(corpus):
    if corpus.ndim != 2 or corpus.dtype != torch.bfloat16:
        raise ValueError("corpus must be (n, d) bfloat16")
    n, d = corpus.shape
    if n < 1 or d < 128 or d % 128 != 0:
        raise ValueError(f"corpus {tuple(corpus.shape)}: d must be a "
                         f"positive multiple of 128 and n >= 1")


def _check_gather(vectors, ids, span, check_ids):
    """Validate; return ids as a contiguous int64 tensor."""
    if vectors.ndim != 2 or vectors.shape[0] < 1 or vectors.shape[1] < 1:
        raise ValueError(f"vectors must be (n, d), got {tuple(vectors.shape)}")
    if ids.ndim != 1 or ids.numel() < 1 or ids.is_floating_point():
        raise ValueError("ids must be a non-empty 1-D integer tensor")
    if ids.device != vectors.device:
        raise ValueError(f"tensors on {ids.device} and {vectors.device}")
    if span < 1 or span > vectors.shape[0]:
        raise ValueError(f"span must be in [1, {vectors.shape[0]}], got {span}")
    if check_ids:
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) + span > vectors.shape[0]:
            raise IndexError(f"ids in [{int(lo)}, {int(hi)}] with span {span} "
                             f"leave the {vectors.shape[0]} rows")
    # the usual caller's ids are int64 and contiguous already: no dispatch
    if ids.dtype != torch.int64:
        ids = ids.to(torch.int64)
    return ids if ids.is_contiguous() else ids.contiguous()


def _blocks(items: int, per_block: int) -> int:
    return max(1, min(_MAX_BLOCKS, -(-items // per_block)))


@functools.lru_cache(maxsize=1024)
def gather_plan(m: int, seg_chunks: int) -> tuple[int, int]:
    """(lanes that own a segment, blocks of the grid) for `gather_rows` on m
    segments of `seg_chunks` 16-byte chunks. The group is the part of a warp
    (32, 16, 8 or 4 lanes) that leaves the fewest lanes idle on a segment's
    last pass, the widest of those: 96 chunks -> 32, 48 -> 16, 1 -> 4. The
    grid has a group for every segment, up to 2^20 blocks."""
    if m < 1 or seg_chunks < 1:
        raise ValueError(f"m = {m}, seg_chunks = {seg_chunks}")
    lanes = min((32, 16, 8, 4), key=lambda g: -seg_chunks % g)
    return lanes, max(1, min(_GATHER_MAX_BLOCKS, -(-m * lanes // _THREADS)))


# ------------------------------------------------------------------ M1 ---


def read_all_plain(corpus, full_reduce: bool):
    """Plain PyTorch version of M1: `amax` over reshaped views (in bf16: a
    maximum is exact in any float type)."""
    _check_corpus(corpus)
    n, d = corpus.shape
    out = torch.full((8, 128), float("-inf"), dtype=torch.float32,
                     device=corpus.device)
    step = 8 if full_reduce else TILE_ROWS
    whole = n // step * step
    if whole and full_reduce:
        out = corpus[:whole].reshape(-1, 8, d // 128, 128).amax(
            dim=(0, 2)).float()
    elif whole:
        out = corpus[:whole].reshape(-1, TILE_ROWS, d)[:, :8, :128].amax(
            dim=0).float()
    # the rows past the last whole step: row whole + i is of class i
    tail = corpus[whole:whole + 8]
    if tail.shape[0]:
        tail = tail.reshape(tail.shape[0], d // 128, 128).amax(dim=1) \
            if full_reduce else tail[:, :128]
        out[:tail.shape[0]] = torch.maximum(out[:tail.shape[0]], tail.float())
    return out


def read_all(corpus, full_reduce: bool):
    """M1: stream an (n, d) bf16 corpus once and fold it to (8, 128) fp32.

    Replaces `read_all` of scripts/bench_roofline.py (`_kernel` :46). It is
    bound by bytes: n * d * 2 read once, 4 KB written. Its time is the
    card's measured streaming-read floor, the yardstick of every scan
    kernel. Threads read the corpus in memory order, 16 bytes a load and
    four loads in flight; the grid is sized so that a thread's chunks all
    fall in one (row mod 8, column mod 128) class, whose maxima it keeps in
    registers; block partials and a second pass give the (8, 128) result.
    """
    if corpus.device.type == "cpu":
        return read_all_plain(corpus, full_reduce)
    if corpus.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {corpus.device}")
    _check_corpus(corpus)
    from cuvs_rag_tpu_torch.kernels import build

    x = corpus.contiguous()  # held until the call returns
    n, d = x.shape
    # threads in the grid: a multiple of d, the 16-byte chunks of 8 rows
    step = d // math.gcd(d, _THREADS)
    n_blocks = max(step, _READ_BLOCKS // step * step)
    partial = torch.empty((n_blocks, 8, 128), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    with build.device_guard(x.device):
        err = build.load(_SOURCE).read_all(
            x.data_ptr(), n, d, int(bool(full_reduce)), TILE_ROWS, n_blocks,
            partial.data_ptr(), out.data_ptr(), build.raw_stream(x.device))
    build.check(err, "read_all")
    read_all.launches += 1
    return out


read_all.launches = 0


# ------------------------------------------------------------- M2 / M4 ---


def gather_rows_plain(vectors, ids, span: int = 1, *, check_ids: bool = True):
    """Plain PyTorch version of M2 / M4: `index_select` (+ `arange` for
    spans)."""
    ids = _check_gather(vectors, ids, span, check_ids)
    if span > 1:
        ids = (ids[:, None] + torch.arange(span, device=ids.device)).flatten()
    return vectors.index_select(0, ids)


def gather_rows(vectors, ids, span: int = 1, *, check_ids: bool = True):
    """M2 / M4: out[i * span + t] = vectors[ids[i] + t], (m * span, d).

    Replaces `pallas_gather` of scripts/bench_gather_modes.py (`_kernel` :42)
    and of scripts/bench_pallas_gather.py (`_kernel` :38, span = 1). It is
    bound by bytes: m * span rows read and written once, and at a few
    thousand rows by the launch. A group of lanes (`gather_plan`) owns a
    segment: one load of its id, shared by shuffle; the lanes walk its
    16-byte chunks with no division; the grid has a group for every
    segment; rows leave by streaming stores, so the copy does not evict
    corpus lines that duplicate ids hit in the L2.
    """
    if vectors.device.type == "cpu":
        return gather_rows_plain(vectors, ids, span, check_ids=check_ids)
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {vectors.device}")
    ids = _check_gather(vectors, ids, span, check_ids)
    row_bytes = vectors.shape[1] * vectors.element_size()
    if row_bytes % 16 != 0:
        raise ValueError(f"rows of {row_bytes} bytes: the kernel moves 16 "
                         f"bytes a load")
    from cuvs_rag_tpu_torch.kernels import build

    # held until the call returns
    src = vectors if vectors.is_contiguous() else vectors.contiguous()
    m = ids.shape[0]
    out = torch.empty((m * span, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    lanes, n_blocks = gather_plan(m, row_bytes // 16 * span)
    with build.device_guard(src.device):
        err = build.load(_SOURCE).gather_rows(
            src.data_ptr(), ids.data_ptr(), out.data_ptr(), m, span,
            row_bytes, lanes, n_blocks, build.raw_stream(src.device))
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ------------------------------------------------------------------ M3 ---


def gather_reduce_plain(vectors, ids, *, check_ids: bool = True):
    """Plain PyTorch version of M3: `index_select`, then `.float().sum(0)`."""
    ids = _check_gather(vectors, ids, 1, check_ids)
    return vectors.index_select(0, ids).float().sum(0)


def gather_reduce(vectors, ids, *, check_ids: bool = True):
    """M3: the fp32 sum (d,) of rows vectors[ids], the rows never written.

    Replaces `pallas_gather_reduce` of scripts/bench_gather_modes.py
    (`_kernel_reduce` :171). It is bound by bytes: m rows read once, (d,)
    written: the ceiling of a kernel that gathers and consumes on chip. A
    thread owns one 16-byte chunk of the row and sums it in registers over
    the rows its block reads; block partials are added in block order.
    """
    if vectors.device.type == "cpu":
        return gather_reduce_plain(vectors, ids, check_ids=check_ids)
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {vectors.device}")
    ids = _check_gather(vectors, ids, 1, check_ids)
    d = vectors.shape[1]
    row_bytes = d * vectors.element_size()
    if vectors.dtype not in _REDUCE_KINDS or row_bytes % 16 != 0 \
            or row_bytes // 16 > _THREADS:
        raise ValueError(f"the kernel takes bfloat16, int8 or float32 rows of "
                         f"a multiple of 16 and at most {16 * _THREADS} "
                         f"bytes, got {vectors.dtype} rows of {row_bytes}")
    from cuvs_rag_tpu_torch.kernels import build

    # held until the call returns
    src = vectors if vectors.is_contiguous() else vectors.contiguous()
    m = ids.shape[0]
    n_blocks = _blocks(m, (_THREADS // (row_bytes // 16)) * 4)
    partial = torch.empty((n_blocks, d), dtype=torch.float32,
                          device=src.device)
    out = torch.empty((d,), dtype=torch.float32, device=src.device)
    with build.device_guard(src.device):
        err = build.load(_SOURCE).gather_reduce(
            src.data_ptr(), ids.data_ptr(), m, d, _REDUCE_KINDS[src.dtype],
            n_blocks, partial.data_ptr(), out.data_ptr(),
            build.raw_stream(src.device))
    build.check(err, "gather_reduce")
    gather_reduce.launches += 1
    return out


gather_reduce.launches = 0
