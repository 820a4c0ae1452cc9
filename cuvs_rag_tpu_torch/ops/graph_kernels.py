"""The CAGRA beam's kernels (`csrc/graph.cu`): the candidate kernel and the
merge kernel, and the rules that route a beam to them.

A candidate step is one step of `ops/graph.beam_search`: from the parents
an iteration expands (or from given entry ids), the candidates' ids and
their beam scores, masked where the merge must not take them. Its plain
version is `ops/graph.candidates_plain`, the PyTorch ops the beam ran
before the kernel; `ops/graph.candidate_step` picks the route and is the
one way in. The kernel replaces no TPU kernel (the JAX package's beam is
XLA ops): it was added because the step was ~20 launches an iteration and
moved three times the bytes it needs (PERF.md).

Contract (both versions):
- rows (N, width) score-augmented rows (`ops/graph.augment_rows`), aq (Q,
  width) fp32 augmented queries.
- graph given: src (Q, e) int32 parent ids, graph (N, G) int32; the m =
  e·G candidate ids nbrs[q, j·G + t] = graph[max(src[q, j], 0), t].
  src_scores (Q, e) fp32: a parent whose score is not above
  -DELETED_THRESHOLD (a tombstoned or empty pick) has its candidates
  scored -inf; they still count as earlier copies.
- graph None: src (Q, m) the candidate ids themselves (the entry step).
- beam (Q, b) int32 or None: a candidate whose id the beam holds scores
  -inf, and so does one whose id an earlier position holds.
- -> (nbrs (Q, m) int32, scores (Q, m) fp32): ids bit-equal between the
  versions, -inf in the same places, other scores the fp32 sums of the
  stored values times the fp32 query in another order than the plain
  version's `bmm`.

`takes` is the route: the kernel for CUDA rows of bf16 or fp32 (every
CAGRA storage) whose width is a multiple of 8 (every augmented width), at
most MAX_CANDIDATES candidates a query and a beam of at most MAX_BEAM ids
(what a block holds in shared memory: 128 search_width x graph_degree
64, an itopk of 4,096); every other step runs the plain one, on the card
too (`ops/graph.candidate_step` warns once when a card's step does).
`prepare` checks and plans a search's launches once and returns the
launch its iterations call: the CAGRA cell waits on the host, and checks
on every launch would cost it. It launches through
`kernels/build.launcher`, which counts the launches in
`build.launches["cagra_candidates"]` and makes each launch call the span
`kernel.launch` (kernel "cagra_candidates").

A merge step is the other step of an iteration: the new beam, the b best
of the beam and the news, and the next iteration's picks from it (the e
best unexpanded slots). Its plain version is `ops/graph.merge_plain`, the
beam's PyTorch ops before the kernel, which runs on CPU tensors;
`ops/graph.merge_step` picks the route. The kernel replaces no TPU kernel
either: the step was ~16 launches an iteration of sorts, gathers and cats
over ~1,000 numbers a query, bound by launches, not bytes. Its outputs
equal the plain version's bit for bit (the same values moved, nothing
computed). `merge_takes` is its route: a CUDA beam of at most
MERGE_MAX_BEAM slots, with any number of news (the library merges them in
pieces of at most MAX_CANDIDATES, a launch each; one piece up to there);
`ops/graph.merge_step` refuses a wider CUDA beam. `prepare_merge` makes a
search's beam and picks once, which its launches rewrite in place, and
launches through `build.launcher` as "cagra_merge".
"""

from __future__ import annotations

import functools

import torch

from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import distance as dist_ops

_SOURCE = "graph.cu"
_KINDS = {torch.bfloat16: 0, torch.float32: 2}
MAX_CANDIDATES = 8192  # a query's candidate ids held in shared memory
MAX_BEAM = 4096  # the beam's ids held in shared memory
MERGE_MAX_BEAM = 16384  # the merge kernel's beam in shared memory
_TABLE_BITS = (6, 14)  # the dedup table: 64 to 16,384 slots (two of them)
_MIN_POSITIONS = 32  # candidates a block takes at the least
_FLOOR = -dist_ops.DELETED_THRESHOLD


def takes(rows, m: int, b: int, graph: torch.Tensor | None = None) -> bool:
    """The route of a candidate step of m candidates a query and a beam of
    b ids: True where `prepare` launches the kernel for these rows (and
    graph), False where the plain step runs."""
    return (rows.is_cuda and rows.ndim == 2 and rows.is_contiguous()
            and rows.dtype in _KINDS and rows.shape[1] > 0
            and rows.shape[1] % 8 == 0
            and 0 < m <= MAX_CANDIDATES and 0 <= b <= MAX_BEAM
            and (graph is None or (graph.dtype == torch.int32
                                   and graph.is_contiguous()
                                   and graph.device == rows.device)))


def table_bits(n_ids: int) -> int:
    """log2 of the dedup table's slots for n_ids beam and candidate ids:
    at least twice as many slots, within _TABLE_BITS."""
    return max(_TABLE_BITS[0], min(_TABLE_BITS[1],
                                   (n_ids - 1).bit_length() + 1))


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(index: int, kind: int, width: int, smem: int) -> int:
    with build.device_guard(torch.device("cuda", index)):
        n = build.load(_SOURCE).cagra_candidates_blocks(kind, width, smem)
    if n < 1:
        raise RuntimeError(f"cagra_candidates_blocks: CUDA error {-n} "
                           f"(or no block fits)")
    return n


@functools.lru_cache(maxsize=256)
def plan(index: int, kind: int, width: int, n_q: int, m: int, b: int,
         sms: int) -> tuple[int, int, int]:
    """(table bits, live capacity, blocks) of a launch: the grid is the
    blocks the card holds at once (or fewer, each with at least
    _MIN_POSITIONS candidates), and a block's segment of one query at most
    its even share of the n_q·m positions."""
    bits = table_bits(b + m)
    smem = 4 * ((2 << bits) + b + 2 * m) + b + m  # live capacity at most m
    blocks = min(sms * _blocks_per_sm(index, kind, width, smem),
                 max(1, n_q * m // _MIN_POSITIONS))
    return bits, min(m, -(-n_q * m // blocks)), blocks


def prepare(rows: torch.Tensor, aq: torch.Tensor, src_cols: int, *,
            graph: torch.Tensor | None = None, beam_width: int = 0):
    """The launches of one search's candidate steps, checked and planned
    once: -> launch(src, src_scores=None, beam=None) -> (nbrs, scores), src
    (Q, src_cols) int32 with unit column stride, src_scores likewise fp32
    (with `graph`) and beam (Q, beam_width) contiguous int32. The first
    call checks its arguments; the later ones pass what the beam's own ops
    make the same way, and are not checked again. Every call returns the
    same two tensors, made here, which the next call overwrites (the beam
    merges them before its next step). For CUDA rows that `takes` admits."""
    n_q, width = aq.shape
    degree = 0 if graph is None else graph.shape[1]
    m, b = src_cols * max(degree, 1), beam_width
    if not takes(rows, m, b, graph):
        raise ValueError(
            f"no kernel for {rows.dtype} rows {tuple(rows.shape)} on "
            f"{rows.device}, {m} candidates and a beam of {b}")
    if aq.dtype != torch.float32 or not aq.is_contiguous() \
            or width != rows.shape[1] or aq.device != rows.device:
        raise ValueError("aq must be (Q, width) contiguous fp32 on the rows' "
                         "device")
    dev = rows.device
    kind = _KINDS[rows.dtype]
    bits, live_cap, blocks = plan(dev.index, kind, width, n_q, m, b,
                                  build.sm_count(dev))
    fn = build.launcher(_SOURCE, "cagra_candidates", dev,
                        kernel="cagra_candidates")
    head = (rows.data_ptr(), kind, width,
            None if graph is None else graph.data_ptr(), degree)
    out = (torch.empty((n_q, m), dtype=torch.int32, device=dev),
           torch.empty((n_q, m), dtype=torch.float32, device=dev))
    tail = (n_q, m, bits, live_cap, blocks, out[0].data_ptr(),
            out[1].data_ptr())
    unchecked = [True]

    def check(src, src_scores, beam):
        def bad(t, dtype, cols):
            return (t.dtype != dtype or t.device != dev
                    or tuple(t.shape) != (n_q, cols) or t.stride(1) != 1)

        if bad(src, torch.int32, src_cols):
            raise ValueError(f"src must be ({n_q}, {src_cols}) int32 with "
                             f"unit column stride on {dev}")
        if src_scores is not None and (graph is None or bad(
                src_scores, torch.float32, src_cols)):
            raise ValueError("src_scores must be the parents' (Q, e) fp32 "
                             "scores with unit column stride")
        if (beam is None) != (b == 0) or beam is not None and (
                bad(beam, torch.int32, b) or not beam.is_contiguous()):
            raise ValueError(f"beam must be ({n_q}, {b}) contiguous int32")
        unchecked.clear()

    def launch(src, src_scores=None, beam=None):
        if unchecked:
            check(src, src_scores, beam)
        fn(*head, src.data_ptr(), src.stride(0),
           None if src_scores is None else src_scores.data_ptr(),
           0 if src_scores is None else src_scores.stride(0),
           _FLOOR, None if beam is None else beam.data_ptr(), b,
           aq.data_ptr(), *tail)
        return out

    return launch


def merge_takes(rows, b: int, e: int) -> bool:
    """The route of a search's merge steps, a beam of b slots and e picks:
    True where `prepare_merge` launches the kernel for a beam on the rows'
    device (any number of news), False where the plain step runs."""
    return rows.is_cuda and 0 < e <= b <= MERGE_MAX_BEAM


def prepare_merge(device, n_q: int, b: int, e: int):
    """The launches of one search's merge steps: -> launch(n_scores, nbrs,
    beam=None) -> (scores, ids, expanded, pick_s, pick_ids), the new beam
    ((Q, b) fp32 scores, int32 ids, bool flags with the picks set) and the
    picks ((Q, e) fp32 scores, int32 ids) of `ops/graph.merge_plain`, bit
    for bit. The five tensors are made here, once, and every launch
    rewrites them, the beam in place. n_scores, nbrs: the news, (Q, m)
    fp32 and int32 with unit column stride, any m; beam: None for the
    entry beam (the news are its rows), else `launch.beam`, the first
    three of the five (which a caller may fill with a beam of its own
    first). The first call of each (beam or none, m) checks its arguments
    and keeps the news' row strides; the later ones pass what the beam's
    own steps make the same way, and are not checked again. For a CUDA
    `device` and shapes that `merge_takes` admits."""
    if not 0 < e <= b <= MERGE_MAX_BEAM:
        raise ValueError(f"no merge kernel for a beam of {b} and {e} picks")
    if device.type == "cuda" and device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    fn = build.launcher(_SOURCE, "cagra_merge", device, kernel="cagra_merge")
    out = (torch.empty((n_q, b), dtype=torch.float32, device=device),
           torch.empty((n_q, b), dtype=torch.int32, device=device),
           torch.empty((n_q, b), dtype=torch.bool, device=device),
           torch.empty((n_q, e), dtype=torch.float32, device=device),
           torch.empty((n_q, e), dtype=torch.int32, device=device))
    beam_ptrs = tuple(t.data_ptr() for t in out[:3])
    pick_ptrs = tuple(t.data_ptr() for t in out[3:])
    strides = {}  # (no beam, m) -> the news' row strides, from a checked call

    def check(n_scores, nbrs, beam):
        m = n_scores.shape[1]

        def bad(t, dtype):
            return (t.dtype != dtype or t.device != device
                    or tuple(t.shape) != (n_q, m) or t.stride(1) != 1)

        if bad(n_scores, torch.float32) or bad(nbrs, torch.int32):
            raise ValueError(f"the news must be ({n_q}, m) fp32 scores and "
                             f"int32 ids with unit column stride on {device}")
        if beam is not None and (len(beam) != 3 or any(
                t is not own for t, own in zip(beam, out))):
            raise ValueError("the merge kernel rewrites its own beam in "
                             "place: pass launch.beam")
        strides[beam is None, m] = (n_scores.stride(0), nbrs.stride(0))

    def launch(n_scores, nbrs, beam=None):
        kind = (beam is None, n_scores.shape[1])
        if kind not in strides:
            check(n_scores, nbrs, beam)
        ns_stride, ni_stride = strides[kind]
        fn(*beam_ptrs, int(beam is not None), n_scores.data_ptr(), ns_stride,
           nbrs.data_ptr(), ni_stride, kind[1], n_q, b, e, *pick_ptrs)
        return out

    launch.beam = out[:3]
    return launch
