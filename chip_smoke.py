#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line (any failure raises and the exit code
is non-zero):
  1. device  — requires CUDA; the card's name and power limit (nvidia-smi).
  2. build   — builds the CUDA kernels from cuvs_rag_tpu_torch/csrc/, one
               nvcc per source, all started together.
  3. parity  — each flat kernel (K1 exact, K2 sketch, K3 large-k) against
               its plain PyTorch version at D = 384 on 1,048,576 rows, and
               on a ragged corpus with tombstoned rows.
  4. ivf_parity — the IVF scan kernels (K4 probed top-k, K5 certified
               large-k) against their plain versions on IVF-Flat indexes of
               a clustered 1,048,576 x 384 corpus (fp32, bf16, int8, 1% of
               rows deleted) and on a small index with empty and short lists.
  5. main    — the flat retrieval path at full width: a MiniLM-L6-shaped
               encoder with seeded random weights, a clustered 6,290,000 x
               384 bf16 corpus (the reference's FAISS Wikipedia deployment)
               with 4,096 planted passages, Retriever.build /
               retrieve_batch / retrieve (k = 2000, approx) / delete /
               extend.
  6. ivf_main — the IVF-Flat retrieval path on the same corpus:
               Retriever.build(family="ivf_flat"), retrieve_batch at k = 10,
               recall@10 against the flat results, retrieve at k = 2000,
               delete, extend and allow-filtered retrieve.
     The kernels' launch counters are set to 0 just before each main path
     and read just after it.
  7. pq_parity — the ADC window-scan kernel (K6) against its plain version
               on 1,048,576-row IVF-PQ indexes at default params in both
               packed code forms (two-level 8-bit with the cross-term
               correction, 4-bit without), 1% of rows deleted, and on a
               ragged index with empty lists and a list of one row; 16
               queries and one query.
  8. pq_main — the IVF-PQ retrieval path on the same 6.29M corpus:
               Retriever.build(family="ivf_pq") at default params, 64
               retrieve_batch at refine_ratio 2 and 64 with recall@10
               against the flat results, delete, extend in place and past a
               list's region (the re-layout), allow-filtered retrieve; then
               out of core: build_from_chunks(store_raw=False) fed from a
               MemmapStore in a temporary directory, retrieve_batch
               re-ranking on the host from that store, save and load.
  9. attn_parity — the flash-attention kernel (K7) against its plain
               version on the whole output: one 8,192-token sequence at the
               Qwen3 widths (16 heads over 8 kv heads, head_dim 128, bf16),
               16 x 512 with ragged right and left padding down to one
               token, S = 1000, fp32 inputs at S = 777, 4 heads of 64.
 10. stream_parity — the measurement kernels M1-M4 against their plain
               versions on the flat corpus: read_all in both modes (and on a
               ragged row count), gather_rows on bf16 and int8 rows at span
               1 and 32 with duplicate ids, gather_reduce.
 11. qwen_main — the Qwen3 retrieval path at the published
               Qwen3-Embedding-0.6B widths (28 layers, seeded random bf16
               weights): 256 planted passages encoded 16 at a time at 512
               tokens and 4 of about 8,000 words one at a time at 8,192
               tokens, written into a clustered 1,000,000 x 1024 bf16
               corpus; Retriever.build(family="flat"), retrieve_batch at
               k = 10; then the same encodes with the plain attention.
 12. timing  — each kernel against its plain version at the main paths'
               shapes (CUDA events) beside its bound (the larger of this
               run's bytes over H100_BYTES_PER_S and its operations over the
               peak rate of their type), a second bound from the read rate
               M1 measured, and one library call where there is one; the
               streaming and gather rates of eval/roofline.py; encode times
               with a torch.profiler table; then the kernels JSON line.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Each kernel wrapper: its CUDA source, and the TPU kernel body it replaces.
SOURCES = {
    "flat_topk_exact": "cuvs_rag_tpu_torch/csrc/flat_topk.cu",
    "flat_topk_sketch": "cuvs_rag_tpu_torch/csrc/flat_topk.cu",
    "flat_topk_large": "cuvs_rag_tpu_torch/csrc/flat_topk.cu",
    "ivf_scan": "cuvs_rag_tpu_torch/csrc/ivf_scan.cu",
    "ivf_scan_large": "cuvs_rag_tpu_torch/csrc/ivf_scan.cu",
    "pq_adc_scores": "cuvs_rag_tpu_torch/csrc/pq_adc.cu",
    "flash_attention": "cuvs_rag_tpu_torch/csrc/flash_attn.cu",
    "read_all": "cuvs_rag_tpu_torch/csrc/stream.cu",
    "gather_rows": "cuvs_rag_tpu_torch/csrc/stream.cu",
    "gather_reduce": "cuvs_rag_tpu_torch/csrc/stream.cu",
}
REPLACES = {
    "flat_topk_exact": "cuvs_rag_tpu/ops/pallas_flat.py:166",
    "flat_topk_sketch": "cuvs_rag_tpu/ops/pallas_flat.py:224",
    "flat_topk_large": "cuvs_rag_tpu/ops/pallas_flat.py:275",
    "ivf_scan": "cuvs_rag_tpu/ops/pallas_ivf.py:92",
    "ivf_scan_large": "cuvs_rag_tpu/ops/pallas_ivf.py:314",
    "pq_adc_scores": "cuvs_rag_tpu/ops/pallas_pq.py:62",
    "flash_attention": "cuvs_rag_tpu/models/flax_qwen.py:157",
    "read_all": "scripts/bench_roofline.py:46",
    "gather_rows": "scripts/bench_gather_modes.py:42",
    "gather_reduce": "scripts/bench_gather_modes.py:171",
}
# gather_rows also stands for the span = 1 kernel of this script
REPLACES_M4 = "scripts/bench_pallas_gather.py:38"
FLAT_KERNELS = ("flat_topk_exact", "flat_topk_sketch", "flat_topk_large")
IVF_KERNELS = ("ivf_scan", "ivf_scan_large")
PQ_KERNELS = ("pq_adc_scores",)
ATTN_KERNELS = ("flash_attention",)
STREAM_KERNELS = ("read_all", "gather_rows", "gather_reduce")
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at the full
# 700 W limit): the yardsticks of every kernel's bound.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
D = 384
# The workload: the reference's FAISS Wikipedia corpus, 4,096 planted
# passages checked in 64 batches of 16, and the parity corpora.
ROWS = 6_290_000
PLANTED = 4096
BATCHES = 64
BATCH = 16
PARITY_ROWS = 1 << 20
PARITY_RAGGED = 1_000_003
# Real sentence embeddings are clustered, and IVF recall on uniform rows
# means nothing: rows are normalize(centre + SPREAD * z), z ~ N(0, I), around
# CENTRES centres uniform on the sphere.
CENTRES = 4096
SPREAD = 0.05
N_PROBES = 20  # IVFFlatSearchParams' default
K_LARGE = 2000
# Kernel vs plain: scores are fp32 sums of exact products taken in another
# order, so they agree to rounding; ids agree as sets up to swaps among
# scores tied (within this tolerance) with the k-th.
TOL = dict(rtol=1e-5, atol=1e-3)
# K6 vs plain: the same fp32 table entries summed in another order (the
# reference's own tolerance); ids and the -inf pattern must be equal.
PQ_TOL = dict(rtol=1e-5, atol=1e-4)
REFINE_TUNED = 64  # the reference's tuned refine_ratio for IVF-PQ
# IVF-PQ gates (see pq_main_path): recall@10 against flat at REFINE_TUNED on
# queries drawn like the corpus, and the loose floors of the planted clump
PQ_RECALL_FLOOR = 0.9
PQ_MIN_REACHABLE = 0.75
PQ_MIN_TOP1 = 0.25
OOC_CHUNKS = 10  # chunks of the out-of-core build (divides ROWS)
OOC_BATCHES = 16  # planted batches re-ranked on the host
# K7 vs plain on the whole output, the plain version given the same values
# as fp32 (it would else round its probabilities to bf16 before P.V, which
# alone moves an output by 4e-3). fp32 inputs: the same masked softmax with
# sums in another order and a fast exp. bf16 inputs: the kernel computes in
# fp32 and rounds its output once, so it is held to that one rounding, half a
# bf16 step (2^-8 of the value), and next to no absolute slack: most outputs
# deep in a long sequence are below 0.05.
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=2.0 ** -8, atol=2e-5)}
# the library's attention vs the same reference: it rounds P to bf16 too
ATTN_LIBRARY_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# The Qwen3 path: the published Qwen3-Embedding-0.6B widths (QwenConfig()),
# 256 planted passages at 512 tokens and 4 of ~8,000 words at 8,192 tokens
# in a clustered 1,000,000 x 1024 bf16 corpus.
QWEN_ROWS = 1_000_000
QWEN_PLANTED = 256
QWEN_LONG = 4
QWEN_LONG_WORDS = 8000
QWEN_TASK = "Given a web search query, retrieve relevant passages that answer the query"
# The scripts' gather shapes: m ids into 2M rows of 768 values
GATHER_ROWS = 2_000_000
GATHER_M2 = 131_072
GATHER_M4 = 409_600


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def kernel_fns():
    """Each wrapper by name, with its plain version."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.ops import stream_kernels as sk

    mods = {**{n: fk for n in FLAT_KERNELS}, **{n: ik for n in IVF_KERNELS},
            **{n: pk for n in PQ_KERNELS}, **{n: ak for n in ATTN_KERNELS},
            **{n: sk for n in STREAM_KERNELS}}
    return {n: (getattr(m, n), getattr(m, n + "_plain"))
            for n, m in mods.items()}


def reset_launches() -> None:
    for kern, _ in kernel_fns().values():
        kern.launches = 0


def read_launches(names) -> dict:
    fns = kernel_fns()
    launches = {n: fns[n][0].launches for n in names}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches


def counter(name: str) -> float:
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    return default_registry.snapshot()["counters"].get(name, 0)


# ---------------------------------------------------------------- parity ---


def make_rows(n, d, gen, device):
    import torch

    return torch.randn((n, d), generator=gen, device=device)


def make_centres(gen, device, dim=D):
    import torch

    return torch.nn.functional.normalize(make_rows(CENTRES, dim, gen, device),
                                         dim=1)


def clustered_rows(n, centres, gen, device):
    """(n, D) fp32 unit rows around random centres."""
    import torch

    b = torch.randint(0, centres.shape[0], (n,), generator=gen, device=device)
    return torch.nn.functional.normalize(
        centres[b] + SPREAD * make_rows(n, centres.shape[1], gen, device), dim=1)


def parity_phase(n_rows: int, n_ragged: int, seed: int, device="cuda",
                 k_large: int = 2000) -> dict:
    """Every kernel vs its plain version on `n_rows` rows (no padding) and on
    a ragged corpus of `n_ragged` rows (storage not a multiple of any tile,
    pad rows past n_valid, 1% of rows tombstoned), for each storage dtype
    the kernel takes: K1 and K3 fp32, bf16 and int8; K2 bf16 and int8."""
    import torch

    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    gen = torch.Generator(device=device).manual_seed(seed)
    n_q = 16
    out = {"exact": 0.0, "sketch": 0.0, "large": 0.0, "large_uncertified": 0,
           "cases": 0}
    for case, n in (("full", n_rows), ("ragged", n_ragged)):
        x = make_rows(n, D, gen, device)
        # half the queries are noisy copies of corpus rows, half random
        q = torch.cat([x[:n_q // 2] + 0.05 * make_rows(n_q // 2, D, gen, device),
                       make_rows(n_q - n_q // 2, D, gen, device)])
        for dtype in ("float32", "bfloat16", "int8"):
            ix = flat.build(FlatParams(dtype=dtype, tile_n=2048), x)
            storage = ix.size
            if case == "ragged":
                ix = flat.delete(ix, torch.arange(3, n, 100, device=device))
                # keep some pad rows past n_valid; a length no tile divides
                storage = min(ix.size, n + 1000)
            args = (ix.vectors[:storage], ix.sqnorms[:storage], q, ix.n_valid,
                    ix.scales[:storage])
            for metric in ("sqeuclidean", "inner_product"):
                for k in (1, 10, 32):
                    got = fk.flat_topk_exact(*args, k=k, metric=metric)
                    want = fk.flat_topk_exact_plain(*args, k=k, metric=metric)
                    out["exact"] = max(out["exact"],
                                       compare_topk(*got, *want, **TOL))
                    out["cases"] += 1
                if dtype != "float32":
                    int8c = dtype == "int8"
                    got = fk.flat_topk_sketch(*args, k=10, metric=metric,
                                              tile_c=2048, int8_compute=int8c)
                    want = fk.flat_topk_sketch_plain(*args, k=10, metric=metric,
                                                     tile_c=2048,
                                                     int8_compute=int8c)
                    out["sketch"] = max(out["sketch"],
                                        compare_topk(*got, *want, **TOL))
                    out["cases"] += 1
                ks, ki, cert = fk.flat_topk_large(*args, k=k_large,
                                                  metric=metric)
                es, ei = fk.flat_topk_exact_plain(*args, k=k_large,
                                                  metric=metric)
                rows = cert.nonzero().flatten()
                out["large_uncertified"] += int((~cert).sum())
                out["large"] = max(out["large"], compare_topk(
                    ks[rows], ki[rows], es[rows], ei[rows], **TOL))
                # few planes and classes: inserts reach every plane position
                # and many rows fail the certificate; the kernel's candidates
                # and flags must equal the plain K3's
                few = dict(k=300, metric=metric, tile_c=128, r_planes=3)
                ks, ki, cert = fk.flat_topk_large(*args, **few)
                ps, pi, pcert = fk.flat_topk_large_plain(*args, **few)
                if not torch.equal(cert, pcert):
                    raise AssertionError("K3 certificate differs from plain")
                out["large"] = max(out["large"],
                                   compare_topk(ks, ki, ps, pi, **TOL))
                out["cases"] += 2
            del ix, args
        del x
    return out


def ragged_ivf_index(x, gen, device):
    """A bf16 IVF-Flat index with 250 empty lists and six populated ones of
    1, 7, 40, 130, 600 and 1,500 rows (`train` on a sample, then `extend`
    with rows next to six of its most isolated centroids), and queries next
    to them."""
    import torch

    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    ix = ivf_flat.train(IVFFlatParams(n_lists=256, dtype="bfloat16"),
                        x[:20_000])
    c = ix.centroids
    gaps = torch.cdist(c, c) + torch.eye(c.shape[0], device=device) * 1e9
    lists = torch.topk(gaps.min(dim=1).values, 6).indices
    sizes = torch.tensor([1, 7, 40, 130, 600, 1500], device=device)
    near = c[lists].repeat_interleave(sizes, dim=0)
    ix = ivf_flat.extend(ix, near + 1e-3 * make_rows(near.shape[0], D, gen,
                                                     device))
    if not torch.equal(ix.list_counts[lists], sizes.to(torch.int32)) \
            or int(ix.list_counts.sum()) != int(sizes.sum()):
        raise AssertionError(f"ragged index counts {ix.list_counts[lists]}")
    q = c[lists[torch.arange(16, device=device) % 6]] \
        + 0.02 * make_rows(16, D, gen, device)
    return ix, q


def ivf_parity_phase(n_rows: int, seed: int, device="cuda",
                     k_large: int = K_LARGE) -> dict:
    """K4 and K5 vs their plain versions at N_PROBES probes, both metrics:
    on IVF-Flat indexes (default params) of a clustered `n_rows`-row corpus
    for fp32, bf16 and int8 storage with 1% of rows deleted, and on
    `ragged_ivf_index`. K4 at k = 1, 10, 32; K5 at k = `k_large` (certified
    rows must equal the plain exact top-k of the probed lists) and in a
    few-planes case (k = 300, 128-row classes, R = 3: flags and candidates
    must equal the plain K5's)."""
    import torch

    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    gen = torch.Generator(device=device).manual_seed(seed)
    centres = make_centres(gen, device)
    x = clustered_rows(n_rows, centres, gen, device)
    # half the queries are noisy copies of corpus rows, half fresh rows
    q = torch.cat([x[:8] + 0.02 * make_rows(8, D, gen, device),
                   clustered_rows(8, centres, gen, device)])
    out = {"k4": 0.0, "k5": 0.0, "k5_uncertified": {}, "k5_few_uncertified": {},
           "cases": 0, "windows": {}}
    cases = []
    for dtype in ("float32", "bfloat16", "int8"):
        ix = ivf_flat.build(IVFFlatParams(dtype=dtype), x)
        cases.append((dtype, ivf_flat.delete(
            ix, torch.arange(3, n_rows, 100, device=device)), q))
    cases.append(("ragged",) + ragged_ivf_index(x, gen, device))
    del x
    for name, ix, qs in cases:
        window = ix.max_list_size
        out["windows"][name] = window
        out["k5_uncertified"][name] = out["k5_few_uncertified"][name] = 0
        for metric in ("sqeuclidean", "inner_product"):
            probes, coarse = ivf_flat.probe(ix, qs, N_PROBES, metric)
            p = probes.long()
            args = (ix.vectors, ix.sqnorms, ix.scales, qs,
                    ix.list_offsets[p], ix.list_counts[p])
            kw = dict(window=window, metric=metric, coarse_ip=coarse)
            for k in (1, 10, 32):
                got = ik.ivf_scan(*args, k=k, **kw)
                want = ik.ivf_scan_plain(*args, k=k, **kw)
                out["k4"] = max(out["k4"], compare_topk(*got, *want, **TOL))
                out["cases"] += 1
            cfg = ik.large_k_config(window, D, k_large)
            if cfg is None:
                raise AssertionError(f"K5 does not take k={k_large} at "
                                     f"window {window}")
            ks, ki, cert = ik.ivf_scan_large(*args, k=k_large, n_sub=cfg[0],
                                             r_planes=cfg[1], **kw)
            es, ei = ik.ivf_scan_plain(*args, k=k_large, **kw)
            rows = cert.nonzero().flatten()
            out["k5_uncertified"][name] += int((~cert).sum())
            out["k5"] = max(out["k5"], compare_topk(
                ks[rows], ki[rows], es[rows], ei[rows], **TOL))
            few = dict(k=300, n_sub=window // 128, r_planes=3, **kw)
            ks, ki, cert = ik.ivf_scan_large(*args, **few)
            ps, pi, pcert = ik.ivf_scan_large_plain(*args, **few)
            if not torch.equal(cert, pcert):
                raise AssertionError("K5 certificate differs from plain")
            out["k5_few_uncertified"][name] += int((~cert).sum())
            out["k5"] = max(out["k5"], compare_topk(ks, ki, ps, pi, **TOL))
            out["cases"] += 2
    return out


def pq_scan_args(ix, q):
    """K6's arguments for queries `q` at N_PROBES probes, formed as
    ivf_pq.search_scores forms them: (codes, row ids, correction or None,
    tables, window offsets, list counts, coarse scores)."""
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.ops import pq as pq_ops

    qp = ivf_pq._prep_queries(ix, q)
    coarse, probes = ivf_ops.probe_lists(
        qp, ix.centroids, ix.centroid_sqnorms, min(N_PROBES, ix.n_lists),
        ix.metric)
    luts = pq_ops.probe_luts(qp, probes, ix.centroids, ix.codebooks,
                             ix.metric, levels=ix.levels)
    p = probes.long()
    return (ix.codes, ix.row_ids, ix.norm_corr if ix.levels == 2 else None,
            luts.contiguous(), ix.list_offsets[p], ix.list_counts[p], coarse)


def ragged_pq_index(x, gen, device):
    """`ragged_ivf_index`'s layout (250 empty lists, six of 1 to 1,500 rows)
    as a two-level IVF-PQ index: codebooks trained on a sample's residuals,
    every slot of the layout encoded against its list's centroid."""
    import torch

    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams

    flat_ix, q = ragged_ivf_index(x, gen, device)
    params = IVFPQParams()
    m = ivf_pq.default_pq_dim(D)
    rotation, codebooks, levels = ivf_pq._train_pq_quantizers(
        params, x[:20_000].float(), flat_ix.centroids, gen, m=m,
        n_codes=2 ** params.pq_bits)
    _, label_of_slot = ivf_ops.invert_layout(
        flat_ix.row_ids, flat_ix.list_offsets, flat_ix.n_valid)
    codes, corr = ivf_pq._encode_rows(flat_ix.vectors, label_of_slot,
                                      flat_ix.centroids, codebooks, None,
                                      levels)
    return ivf_pq.IVFPQIndex(
        codes=codes.T.contiguous(), row_ids=flat_ix.row_ids,
        centroids=flat_ix.centroids,
        centroid_sqnorms=flat_ix.centroid_sqnorms, codebooks=codebooks,
        list_offsets=flat_ix.list_offsets, list_counts=flat_ix.list_counts,
        raw_vectors=flat_ix.vectors, raw_sqnorms=flat_ix.sqnorms,
        norm_corr=corr, rotation=rotation, n_valid=flat_ix.n_valid,
        metric=flat_ix.metric, max_list_size=flat_ix.max_list_size, dim=D,
        levels=levels), q


def pq_parity_phase(n_rows: int, seed: int, device="cuda") -> dict:
    """K6 vs its plain version at N_PROBES probes, for 16 queries and for
    one: on IVF-PQ indexes (default params, no raw store) of a clustered
    `n_rows`-row corpus in both packed code forms, two-level 8-bit (with
    the cross-term correction) and 4-bit (without), 1% of rows deleted, and
    on `ragged_pq_index`. Row ids and the -inf pattern must be equal; scores
    within PQ_TOL."""
    import torch

    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams

    gen = torch.Generator(device=device).manual_seed(seed)
    centres = make_centres(gen, device)
    x = clustered_rows(n_rows, centres, gen, device)
    q = torch.cat([x[:8] + 0.02 * make_rows(8, D, gen, device),
                   clustered_rows(8, centres, gen, device)])
    cases = []
    for name, kw in (("two_level", {}), ("four_bit", dict(pq_bits=4))):
        ix = ivf_pq.build(IVFPQParams(store_raw=False, **kw), x, seed=seed)
        cases.append((name, ivf_pq.delete(
            ix, torch.arange(3, n_rows, 100, device=device)), q))
    cases.append(("ragged",) + ragged_pq_index(x, gen, device))
    del x
    out = {"k6": 0.0, "cases": 0, "windows": {}, "streams": {},
           "live_slots": {}}
    for name, ix, qs in cases:
        window = ix.max_list_size
        out["windows"][name] = window
        out["streams"][name] = ix.codes.shape[0]
        for sub in (qs, qs[:1]):
            args = pq_scan_args(ix, sub)
            s, i = pk.pq_adc_scores(*args, window=window)
            torch.cuda.synchronize()
            ps, pi = pk.pq_adc_scores_plain(*args, window=window)
            if not torch.equal(i, pi):
                raise AssertionError(f"K6 row ids differ from plain ({name})")
            live = torch.isfinite(ps)
            if not torch.equal(torch.isfinite(s), live) \
                    or not torch.equal(live, pi >= 0):
                raise AssertionError(f"K6 -inf pattern differs ({name})")
            if not live.any() or live.all():
                raise AssertionError(f"{name}: no live or no dead slot")
            torch.testing.assert_close(s[live], ps[live], **PQ_TOL)
            out["k6"] = max(out["k6"], float((s[live] - ps[live]).abs().max()))
            out["live_slots"][f"{name}_{sub.shape[0]}q"] = int(live.sum())
            out["cases"] += 1
    return out


def pad_mask(kind: str, b: int, s: int, device):
    """(b, s) int32 attention masks whose text lengths spread from 1 token
    to s: padded on the right, on the left, or on both sides ("mixed");
    "none" is all text."""
    import torch

    lens = torch.linspace(1, s, b, device=device).round().long()[:, None]
    pos = torch.arange(s, device=device)[None, :]
    if kind == "none":
        keep = torch.ones((b, s), dtype=torch.bool, device=device)
    elif kind == "right":
        keep = pos < lens
    elif kind == "left":
        keep = pos >= s - lens
    else:
        lo = (s - lens) // 2
        keep = (pos >= lo) & (pos < lo + lens)
    return keep.to(torch.int32)


def attn_inputs(b, s, nh, nkv, hd, dtype, gen, device):
    import torch

    return tuple(torch.randn((b, s, h, hd), generator=gen, device=device)
                 .to(dtype) for h in (nh, nkv, nkv))


def attn_hold(got, q, k, v, mask, scale):
    """Hold K7's output to the plain version of the same values in fp32,
    within ATTN_TOL of the input type. Returns (largest absolute error, that
    fp32 reference)."""
    import torch

    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    want = ak.flash_attention_plain(q.float(), k.float(), v.float(), mask,
                                    scale)
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError("NaN in the attention output")
    torch.testing.assert_close(got.float(), want,
                               **ATTN_TOL[str(q.dtype).split(".")[1]])
    return float((got.float() - want).abs().max()), want


def attn_parity_phase(seed: int, device="cuda", s_long: int = 8192,
                      s_batch: int = 512) -> dict:
    """K7 vs its plain version (on the same values as fp32, attn_hold) on
    the whole output, pad rows included, within ATTN_TOL of the input type,
    no NaN anywhere: one `s_long`-token
    sequence at the Qwen3 widths (16 heads over 8 kv heads, head_dim 128,
    bf16); 16 x `s_batch` with ragged right padding down to a one-token
    row, and the same left-padded (real rows see pad-only tiles first);
    S = 1000 (no multiple of any tile) padded on both sides; fp32 inputs at
    S = 777; and 4 heads over 4 kv heads of 64, bf16 and fp32."""
    import torch

    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [
        ("full", 1, s_long, 16, 8, 128, bf16, "none"),
        ("right", 16, s_batch, 16, 8, 128, bf16, "right"),
        ("left", 16, s_batch, 16, 8, 128, bf16, "left"),
        ("s1000", 2, 1000, 16, 8, 128, bf16, "mixed"),
        ("fp32_s777", 2, 777, 16, 8, 128, fp32, "left"),
        ("mha_hd64", 2, 600, 4, 4, 64, bf16, "right"),
        ("mha_hd64_fp32", 1, 333, 4, 4, 64, fp32, "none"),
    ]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"cases": 0, "max_abs_err": {}}
    for name, b, s, nh, nkv, hd, dtype, padding in cases:
        q, k, v = attn_inputs(b, s, nh, nkv, hd, dtype, gen, device)
        mask = pad_mask(padding, b, s, device)
        scale = hd ** -0.5
        got = ak.flash_attention(q, k, v, mask, scale)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype:
            raise AssertionError(f"{name}: output {got.shape} {got.dtype}")
        out["max_abs_err"][name], _ = attn_hold(got, q, k, v, mask, scale)
        out["cases"] += 1
    return out


def gather_views(corpus, rows: int = 0):
    """The (n, d) bf16 corpus as gather sources without a copy: rows of 2 d
    bf16 values (the scripts' 768 at d = 384) and rows of 2 d int8 values
    (its bytes), cut to `rows` rows when given."""
    import torch

    wide = corpus[: corpus.shape[0] // 2 * 2].view(-1, 2 * corpus.shape[1])
    as_int8 = corpus.view(torch.int8)
    return (wide[:rows], as_int8[:rows]) if rows else (wide, as_int8)


def stream_parity_phase(corpus, ragged_rows: int, seed: int,
                        m: int = GATHER_M2) -> dict:
    """M1-M4 vs their plain versions through eval/roofline.py's checks, which
    own the comparisons and gather_reduce's tolerance: read_all in both
    modes on all of the flat corpus (n, d) bf16 and on its first
    `ragged_rows` rows, equal bit for bit; gather_rows (uniform ids, 50% and
    90% of them row 0, 32-row spans) equal bit for bit and gather_reduce
    within REDUCE_TOL, on bf16 and int8 rows of 2 d values of that corpus
    and on fp32 rows of a ragged count."""
    import torch

    from cuvs_rag_tpu_torch.eval import roofline

    device = corpus.device
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"cases": roofline.check_read(corpus)
           + roofline.check_read(corpus[:ragged_rows]),
           "reduce_max_abs_err": {"rows": 0.0, "dup50": 0.0}}
    fp32_rows = torch.randn((100_003, 256), generator=gen, device=device)
    for vectors in (*gather_views(corpus), fp32_rows):
        held = roofline.check_gathers(
            vectors, roofline.gather_ids(vectors.shape[0], m, gen))
        out["cases"] += held["cases"]
        for name, err in held["reduce_max_abs_err"].items():
            out["reduce_max_abs_err"][name] = max(
                out["reduce_max_abs_err"][name], err)
    torch.cuda.synchronize()
    return out


# ------------------------------------------------------------ main paths ---


def synthetic_passages(n: int, rng) -> list:
    words = [f"w{i}" for i in range(5000)]
    return [
        f"passage {i} " + " ".join(rng.choice(words, size=int(rng.integers(20, 200))))
        for i in range(n)
    ]


def make_encoder(seed: int, dev):
    import torch

    from cuvs_rag_tpu_torch.models.bert_encoder import (
        BertConfig, BertEncoderModel, TorchSentenceEncoder)
    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer

    cfg = BertConfig.minilm_l6()
    model = BertEncoderModel(cfg).init_random_(torch.Generator().manual_seed(seed))
    # ids = hash(word) % vocab_mod + 1 must stay below vocab_size
    return TorchSentenceEncoder(cfg, model, HashTokenizer(cfg.vocab_size - 1),
                                max_length=256, device=dev)


def make_corpus(seed: int, enc, dev):
    """The clustered ROWS x D bf16 corpus, made on the card in chunks, with
    PLANTED rows replaced by the encoder's embeddings of their passages.
    Returns (embeddings, passages, planted row ids, planted texts)."""
    import torch

    rng = np.random.default_rng(seed)
    texts = synthetic_passages(PLANTED, rng)
    planted = np.sort(rng.choice(ROWS, size=PLANTED, replace=False))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    centres = make_centres(gen, dev)
    emb = torch.empty((ROWS, D), dtype=torch.bfloat16, device=dev)
    for i in range(0, ROWS, 1 << 20):
        n = min(1 << 20, ROWS - i)
        emb[i : i + n] = clustered_rows(n, centres, gen, dev).to(torch.bfloat16)
    emb[torch.as_tensor(planted, device=dev)] = enc.encode_device(
        texts, batch_size=256).to(torch.bfloat16)
    passages = [""] * ROWS
    for row, t in zip(planted.tolist(), texts):
        passages[row] = t
    return emb, passages, planted, texts


def check_top1(results, rows):
    for res, row in zip(results, rows):
        top = res.passages[0]
        if top.index != row or not top.distance < 0.05:
            raise AssertionError(f"planted row {row}: got {top.index} "
                                 f"at distance {top.distance}")


def planted_batches():
    """(query numbers) of each of the BATCHES planted batches."""
    return [range((b * BATCH) % PLANTED, (b * BATCH) % PLANTED + BATCH)
            for b in range(BATCHES)]


def main_path(enc, emb, passages, planted, texts, rng):
    """The flat path. Returns (fields, retriever, (Q, 10) flat ids of the
    planted batches)."""
    import torch

    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import FlatParams, FlatSearchParams

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    retriever = Retriever.build(
        Corpus(passages=list(passages), embeddings=emb), enc, family="flat",
        params=FlatParams(dtype="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if retriever.index.size <= flat._DENSE_THRESHOLD:
        raise AssertionError("corpus too small to reach the kernels")

    reset_launches()
    reruns0 = counter("flat.certificate_reruns")
    n_checked = 0
    flat_ids = []
    for sel in planted_batches():
        results = retriever.retrieve_batch([texts[i] for i in sel], k=10)
        check_top1(results, [int(planted[i]) for i in sel])
        flat_ids += [[p.index for p in r.passages] for r in results]
        n_checked += BATCH
    res = retriever.retrieve(texts[0], k=2000)
    check_top1([res], [int(planted[0])])
    if len(res.passages) != 2000:
        raise AssertionError(f"k=2000 returned {len(res.passages)} passages")
    retriever.search_params = FlatSearchParams(approx=True)
    check_top1([retriever.retrieve(texts[1], k=10)], [int(planted[1])])
    retriever.search_params = None
    retriever.delete([int(planted[2])])
    gone = [p.index for p in retriever.retrieve(texts[2], k=10).passages]
    if int(planted[2]) in gone:
        raise AssertionError("deleted row came back")
    new_text = "an extended passage " + " ".join(rng.choice([f"x{i}" for i in range(999)], 50))
    new_ids = retriever.extend([new_text])
    check_top1([retriever.retrieve(new_text, k=10)], [new_ids[0]])
    launches = read_launches(FLAT_KERNELS)
    out = {
        "rows": ROWS, "dim": D, "planted": PLANTED,
        "queries_checked": n_checked + 4, "build_s": build_s,
        "launches": launches,
        "certificate_reruns": counter("flat.certificate_reruns") - reruns0,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return out, retriever, np.asarray(flat_ids)


def reachability(enc, ix, planted, texts, probe_fn, min_top1: float = 1.0):
    """(probed, check_reachable) for an IVF-family index `ix`: whether each
    planted query's row lies in one of the lists `probe_fn(queries)` probes,
    and the top-1 check of the results whose row does. check_reachable
    returns (rows reachable, rows at top-1 within 0.05); it raises at the
    first miss when `min_top1` is 1 (an exact scan of the probed lists
    cannot miss), and the caller holds the share otherwise."""
    import torch

    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops

    dev = ix.device
    slot_of, label_of_slot = ivf_ops.invert_layout(ix.row_ids,
                                                   ix.list_offsets, ROWS)
    planted_t = torch.as_tensor(planted, device=dev)
    list_of = label_of_slot[slot_of[planted_t.long()].long()]

    def probed(numbers):
        q = enc.encode_device([texts[i] for i in numbers])
        sel = torch.as_tensor(list(numbers), device=dev)
        return (probe_fn(q) == list_of[sel][:, None]).any(dim=1).tolist()

    def check_reachable(results, numbers):
        reachable = hits = 0
        for res, i, ok in zip(results, numbers, probed(numbers)):
            if not ok:
                continue
            reachable += 1
            if min_top1 >= 1.0:
                check_top1([res], [int(planted[i])])
            top = res.passages[0] if res.passages else None
            hits += bool(top and top.index == int(planted[i])
                         and top.distance < 0.05)
        return reachable, hits

    return probed, check_reachable


def planted_sweep(retriever, planted, texts, check_reachable,
                  min_top1: float = 1.0, batches: int = 0,
                  min_reachable: float = 0.99):
    """The first `batches` planted batches at k = 10: (rows reachable, rows
    at top-1, (Q, 10) ids); all BATCHES when `batches` is 0. At least
    `min_reachable` must be reachable, and `min_top1` of those at top-1."""
    batches = batches or BATCHES
    reachable, hits, ids = 0, 0, []
    for sel in planted_batches()[:batches]:
        results = retriever.retrieve_batch([texts[i] for i in sel], k=10)
        r, h = check_reachable(results, sel)
        reachable, hits = reachable + r, hits + h
        ids += [[p.index for p in r.passages]
                + [-1] * (10 - len(r.passages)) for r in results]
    if reachable < min_reachable * batches * BATCH \
            or hits < min_top1 * reachable:
        raise AssertionError(
            f"of {batches * BATCH} planted rows {reachable} lie in a probed "
            f"list and {hits} are at top-1")
    return reachable, hits, np.asarray(ids)


def filtered_checks(retriever, planted, texts, first):
    """Two allow= retrievals: every id not divisible by 3 is allowed, one
    planted row excluded and another allowed. Results must stay inside the
    mask, the excluded row must not return, the allowed one keeps top-1."""
    allow = np.arange(len(retriever.corpus.passages)) % 3 != 0
    excluded, kept = int(planted[first[0]]), int(planted[first[1]])
    allow[excluded], allow[kept] = False, True

    def filtered_ids(i):
        ids = [p.index for p in retriever.retrieve(texts[i], k=10,
                                                   allow=allow).passages]
        if not ids or not allow[ids].all():
            raise AssertionError(f"filtered results {ids} leave the mask")
        return ids

    if excluded in filtered_ids(first[0]):
        raise AssertionError("a row the mask excludes came back")
    if filtered_ids(first[1])[0] != kept:
        raise AssertionError("an allowed planted row lost its top-1")


def ivf_main_path(enc, emb, passages, planted, texts, flat_ids, rng):
    """The IVF-Flat path at N_PROBES probes. A planted query's top-1 must be
    its row whenever that row's list is among the query's probed lists, and
    at least 99% of the planted queries must be so. Returns (fields,
    retriever)."""
    import torch

    from cuvs_rag_tpu_torch.eval.recall import recall_at_k
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    retriever = Retriever.build(
        Corpus(passages=list(passages), embeddings=emb), enc,
        family="ivf_flat", params=IVFFlatParams(dtype="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix = retriever.index
    probed, check_reachable = reachability(
        enc, ix, planted, texts,
        lambda q: ivf_flat.probe(ix, q, N_PROBES)[0])

    reset_launches()
    reruns0 = counter("ivf_flat.certificate_reruns")
    reachable, _, ivf_ids = planted_sweep(retriever, planted, texts,
                                          check_reachable)
    n_checked = BATCHES * BATCH
    recall = recall_at_k(ivf_ids, flat_ids, 10)
    # the checks below use planted queries whose rows are reachable
    first = [i for i, ok in enumerate(probed(range(64))) if ok][:4]
    res = retriever.retrieve(texts[first[0]], k=K_LARGE)
    check_top1([res], [int(planted[first[0]])])
    if len(res.passages) < 10:
        raise AssertionError(f"k={K_LARGE} returned {len(res.passages)}")
    gone_row = int(planted[first[1]])
    retriever.delete([gone_row])
    got = [p.index for p in retriever.retrieve(texts[first[1]], k=10).passages]
    if gone_row in got:
        raise AssertionError("deleted row came back")
    new_text = "an extended passage " + " ".join(rng.choice([f"y{i}" for i in range(999)], 50))
    new_ids = retriever.extend([new_text])
    check_top1([retriever.retrieve(new_text, k=10)], [new_ids[0]])
    filtered_checks(retriever, planted, texts, first[2:4])
    launches = read_launches(IVF_KERNELS)
    out = {
        "rows": ROWS, "n_lists": ix.n_lists,
        "max_list": int(ix.list_counts.max()), "window": ix.max_list_size,
        "build_s": build_s, "n_probes": N_PROBES,
        "queries_checked": n_checked, "reachable": reachable,
        "recall_at_10_vs_flat": recall, "launches": launches,
        "certificate_reruns": counter("ivf_flat.certificate_reruns") - reruns0,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return out, retriever


def pq_main_path(enc, emb, passages, planted, texts, flat_ids, flat_index,
                 rng):
    """The IVF-PQ path at default params and N_PROBES probes, in core and
    out of core.

    What is held exactly: with refine every returned distance is the exact
    distance of the returned row, ascending; deleted rows never return;
    filtered results stay inside the mask; a row added by extend is found;
    a saved and loaded retriever answers the same. What is held by share:
    on 1,024 queries drawn like the corpus (noisy copies of its rows) the
    source row is top-1 for >= 99% and recall@10 against flat is >=
    PQ_RECALL_FLOOR at REFINE_TUNED. The planted rows are held loosely
    (PQ_MIN_REACHABLE, PQ_MIN_TOP1) and their shares reported: they are one
    clump of 4,096 rows far tighter than the residuals the codebooks are
    trained on, larger than the eight lists a row may spill to can hold at
    the balance cap, and builds differ from run to run (the k-means
    products are not bit-reproducible), so between runs all 1,024 came
    first, or 934 of 975 reachable ones, or only 595 of 990. Returns (fields, in-core
    retriever, out-of-core retriever); the out-of-core retriever's store
    lives in a temporary directory that `fields["tmp"]` keeps alive."""
    import tempfile

    import torch

    from cuvs_rag_tpu_torch.eval.recall import recall_at_k
    from cuvs_rag_tpu_torch.index import flat, ivf_pq
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.rag import host_store
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams

    def probe_fn(ix):
        return lambda q: ivf_ops.probe_lists(
            ivf_pq._prep_queries(ix, q), ix.centroids, ix.centroid_sqnorms,
            N_PROBES, ix.metric)[1]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    retriever = Retriever.build(
        Corpus(passages=list(passages), embeddings=emb), enc,
        family="ivf_pq", params=IVFPQParams())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix = retriever.index
    if not (ix.levels == 2 and ix.codes_packed and ix.has_raw):
        raise AssertionError("default params must give packed two-level "
                             "codes with a raw store")
    out = {"rows": ROWS, "n_lists": ix.n_lists, "pq_dim": ix.pq_dim,
           "code_bytes_per_row": ix.codes.shape[0],
           "max_list": int(ix.list_counts.max()), "window": ix.max_list_size,
           "build_s": build_s, "n_probes": N_PROBES}
    probed, check_reachable = reachability(enc, ix, planted, texts,
                                           probe_fn(ix), PQ_MIN_TOP1)
    loose = dict(min_top1=PQ_MIN_TOP1, min_reachable=PQ_MIN_REACHABLE)

    reset_launches()
    # default search params (refine_ratio 2): top-1 counted, not gated
    default_ids, top1 = [], 0
    for sel in planted_batches():
        results = retriever.retrieve_batch([texts[i] for i in sel], k=10)
        top1 += sum(bool(r.passages) and r.passages[0].index == int(planted[i])
                    for r, i in zip(results, sel))
        default_ids += [[p.index for p in r.passages]
                        + [-1] * (10 - len(r.passages)) for r in results]
    out["top1_at_default_refine"] = top1
    out["recall_at_10_vs_flat_default_refine"] = recall_at_k(
        np.asarray(default_ids), flat_ids, 10)
    retriever.search_params = IVFPQSearchParams(n_probes=N_PROBES,
                                                refine_ratio=REFINE_TUNED)
    out["reachable"], out["top1_at_refine_64"], tuned_ids = planted_sweep(
        retriever, planted, texts, check_reachable, **loose)
    # refined distances are exact: ||q - row||² of the returned rows
    sel = planted_batches()[0]
    q = enc.encode_device([texts[i] for i in sel])
    dist, ids = retriever.retrieve_ids([texts[i] for i in sel], 10)
    exact = ((q[:, None, :] - emb[torch.as_tensor(ids, device=emb.device)
                                  .clamp(min=0).long()].float()) ** 2).sum(-1)
    if (ids < 0).any() or not np.allclose(dist, exact.cpu().numpy(),
                                          rtol=1e-4, atol=1e-4) \
            or (np.diff(dist, axis=1) < -1e-6).any():
        raise AssertionError("refined distances are not the exact ones")
    out["queries_checked"] = 2 * BATCHES * BATCH
    out["recall_at_10_vs_flat_refine_64"] = recall_at_k(tuned_ids, flat_ids, 10)
    # the planted queries' neighbours are the other planted rows, whose
    # codes nearly tie: no floor, but the wider pool must not lose
    if out["recall_at_10_vs_flat_refine_64"] \
            < out["recall_at_10_vs_flat_default_refine"]:
        raise AssertionError(f"recall@10 against flat: {out}")
    # the same two pools on queries drawn like the corpus: noisy copies of
    # 1,024 of its rows, searched through the index modules directly
    gen_q = torch.Generator(device=emb.device).manual_seed(11)
    src = torch.randint(0, ROWS, (1024,), generator=gen_q, device=emb.device)
    qs = torch.nn.functional.normalize(
        emb[src].float() + 0.02 * make_rows(1024, D, gen_q, emb.device), dim=1)
    _, want = flat.search(None, flat_index, qs, 10)
    for name, ratio in (("default_refine", 2), ("refine_64", REFINE_TUNED)):
        sp = IVFPQSearchParams(n_probes=N_PROBES, refine_ratio=ratio)
        got = torch.cat([ivf_pq.search(sp, ix, qs[i:i + BATCH], 10)[1]
                         for i in range(0, 1024, BATCH)])
        out[f"corpus_like_recall_at_10_{name}"] = recall_at_k(
            got.cpu().numpy(), want.cpu().numpy(), 10)
        out[f"corpus_like_top1_{name}"] = int((got[:, 0] == src).sum())
    if out["corpus_like_recall_at_10_refine_64"] < PQ_RECALL_FLOOR \
            or out["corpus_like_top1_refine_64"] < 0.99 * 1024:
        raise AssertionError(f"recall on corpus-like queries: {out}")

    # the checks below use planted queries that this index answers from
    # a pool of 20 already: far from the edge of the pool of 640
    default_ids = np.asarray(default_ids)
    first = [i for i, ok in enumerate(probed(range(min(256, len(tuned_ids)))))
             if ok and default_ids[i, 0] == int(planted[i])
             and tuned_ids[i, 0] == int(planted[i])][:4]
    gone_row = int(planted[first[0]])
    retriever.delete([gone_row])

    def gone_stays_gone():
        got = [p.index for p in
               retriever.retrieve(texts[first[0]], k=10).passages]
        if gone_row in got:
            raise AssertionError("deleted row came back")

    gone_stays_gone()
    new_text = "an extended passage " + " ".join(rng.choice([f"z{i}" for i in range(999)], 50))
    codes_before = retriever.index.codes
    new_ids = retriever.extend([new_text])
    # in place unless the row's list had no slack left in its region
    out["one_row_extend_in_place"] = \
        retriever.index.codes.data_ptr() == codes_before.data_ptr()

    def new_row_is_found():
        """With every other row masked out the new passage is found: the
        mask keeps the planted clump out of its ADC pool."""
        allow = np.zeros(len(retriever.corpus.passages), bool)
        allow[new_ids[0]] = True
        check_top1([retriever.retrieve(new_text, k=10, allow=allow)],
                   [new_ids[0]])

    new_row_is_found()
    filtered_checks(retriever, planted, texts, first[2:4])
    # 1,500 near-copies of one row outgrow its list's region: the layout is
    # rebuilt with headroom and the tombstone is applied again
    burst = emb[int(planted[first[1]])].float() \
        + 1e-3 * make_rows(1500, D, torch.Generator(device=emb.device)
                           .manual_seed(7), emb.device)
    window_before = retriever.index.max_list_size
    burst_ids = retriever.extend(vectors=burst)
    if retriever.index.max_list_size <= window_before:
        raise AssertionError("the burst did not force a re-layout")
    out["window_after_relayout"] = retriever.index.max_list_size
    gone_stays_gone()
    new_row_is_found()
    got = retriever.retrieve(texts[first[1]], k=10).passages
    if not set(p.index for p in got) & (set(burst_ids)
                                        | {int(planted[first[1]])}):
        raise AssertionError("rows of the burst are not found after the "
                             "re-layout")
    out["launches"] = read_launches(PQ_KERNELS)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # out of core: codes on the card, raw rows in a disk-backed store
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    rows = ROWS // OOC_CHUNKS
    t0 = time.perf_counter()
    store = host_store.materialize_from_chunks(
        os.path.join(tmp.name, "emb.bin"), lambda i: emb[i * rows:(i + 1) * rows],
        ROWS, D, OOC_CHUNKS)
    out["store_write_s"] = time.perf_counter() - t0
    store = host_store.MemmapStore.open(store.path)
    params = IVFPQParams(store_raw=False)
    t0 = time.perf_counter()
    ooc_ix = ivf_pq.build_from_chunks(
        params, lambda i: store.chunk(i, rows), ROWS, D, n_chunks=OOC_CHUNKS)
    torch.cuda.synchronize()
    out["ooc_build_s"] = time.perf_counter() - t0
    if ooc_ix.has_raw or ooc_ix.device != emb.device:
        raise AssertionError("the out-of-core index must hold codes only, "
                             "on the card")
    out["ooc_index_gb"] = sum(
        getattr(ooc_ix, f).numel() * getattr(ooc_ix, f).element_size()
        for f in ivf_pq.IVFPQIndex._tensor_fields) / 1e9
    ooc = Retriever(enc, ooc_ix, Corpus(passages=list(passages),
                                        embeddings=store),
                    family="ivf_pq", params=params,
                    search_params=IVFPQSearchParams(
                        n_probes=N_PROBES, refine_ratio=REFINE_TUNED))
    _, ooc_check = reachability(enc, ooc_ix, planted, texts, probe_fn(ooc_ix),
                                PQ_MIN_TOP1)
    launches0 = read_launches(PQ_KERNELS)["pq_adc_scores"]
    out["ooc_reachable"], out["ooc_top1"], _ = planted_sweep(
        ooc, planted, texts, ooc_check, batches=OOC_BATCHES, **loose)
    out["ooc_launches"] = read_launches(PQ_KERNELS)["pq_adc_scores"] - launches0
    queries = [texts[i] for i in planted_batches()[0]]
    want = ooc.retrieve_ids(queries, 10)
    ooc.save(os.path.join(tmp.name, "saved"))
    loaded = Retriever.load(os.path.join(tmp.name, "saved"), enc)
    if not isinstance(loaded.corpus.embeddings, host_store.MemmapStore) \
            or loaded.index.device != emb.device:
        raise AssertionError("the loaded retriever must reopen the store and "
                             "put the index on the card")
    got = loaded.retrieve_ids(queries, 10)
    if not np.array_equal(got[1], want[1]) \
            or not np.allclose(got[0], want[0], rtol=1e-5, atol=1e-5):
        raise AssertionError("the loaded retriever answers differently")
    out["ooc_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["tmp"] = tmp
    return out, retriever, ooc


def make_qwen_encoders(seed: int, dev):
    """(512-token encoder, 8,192-token encoder, model): two encoders over
    one QwenModel at the published Qwen3-Embedding-0.6B widths with seeded
    random bf16 weights (the HashTokenizer pads every batch to its
    encoder's max_length)."""
    import torch

    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer
    from cuvs_rag_tpu_torch.models.qwen_encoder import (
        QwenConfig, QwenEmbeddingEncoder, QwenModel)

    cfg = QwenConfig()
    with torch.device(dev):
        model = QwenModel(cfg)
    model.init_random_(torch.Generator(device=dev).manual_seed(seed))
    # ids = hash(word) % vocab_mod + 1 must stay below vocab_size
    tok = HashTokenizer(cfg.vocab_size - 1)
    return (QwenEmbeddingEncoder(cfg, model, tok, max_length=512, device=dev),
            QwenEmbeddingEncoder(cfg, model, tok, max_length=8192, device=dev),
            model)


def qwen_main_path(seed: int, dev):
    """The Qwen3 path at full width: QWEN_PLANTED instruct-formatted
    passages encoded 16 at a time at 512 tokens and QWEN_LONG passages of
    QWEN_LONG_WORDS words one at a time at 8,192 tokens, planted into a
    clustered QWEN_ROWS x 1024 bf16 corpus, a flat Retriever over it, every
    planted passage retrieved again from its text. Gates: each at top-1
    with distance < 0.05; a passage encoded alone and in its batch of 16
    agree within 2e-2 in every coordinate (the pad mask reaches K7); the
    encoder with the plain attention swapped in agrees at cosine >= 0.999
    at 16 x 512 and at 1 x 8,192; K7 launched once per layer and forward
    call, and K1 launched, and K1 within TOL of its plain version on this
    corpus at both query counts (launches that the counts leave out). Returns (fields, (encoder, long encoder, texts,
    long texts, launches of K7 by shape))."""
    import torch

    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.models import qwen_encoder
    from cuvs_rag_tpu_torch.models.encoder import get_detailed_instruct
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    rng = np.random.default_rng(seed + 3)
    t0 = time.perf_counter()
    enc, enc_long, model = make_qwen_encoders(seed, dev)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    cfg = enc.cfg
    # the same instruct-formatted text is planted and asked for
    texts = [get_detailed_instruct(QWEN_TASK, t)
             for t in synthetic_passages(QWEN_PLANTED, rng)]
    words = [f"w{i}" for i in range(5000)]
    long_texts = [get_detailed_instruct(
        QWEN_TASK, f"long passage {i} "
        + " ".join(rng.choice(words, size=QWEN_LONG_WORDS)))
        for i in range(QWEN_LONG)]
    shapes = []  # (B, S) of every forward call of the model
    hook = model.register_forward_hook(
        lambda mod, args, out: shapes.append(tuple(args[0].shape)))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    planted_emb = torch.cat([enc.encode_device(texts),
                             enc_long.encode_device(long_texts, batch_size=1)])
    planted = np.sort(rng.choice(QWEN_ROWS, size=len(planted_emb),
                                 replace=False))
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    centres = make_centres(gen, dev, cfg.hidden_size)
    emb = torch.empty((QWEN_ROWS, cfg.hidden_size), dtype=torch.bfloat16,
                      device=dev)
    for i in range(0, QWEN_ROWS, 1 << 18):
        n = min(1 << 18, QWEN_ROWS - i)
        emb[i:i + n] = clustered_rows(n, centres, gen, dev).to(torch.bfloat16)
    emb[torch.as_tensor(planted, device=dev)] = planted_emb.to(torch.bfloat16)
    passages = [""] * QWEN_ROWS
    for row, t in zip(planted.tolist(), texts + long_texts):
        passages[row] = t
    t0 = time.perf_counter()
    retriever = Retriever.build(Corpus(passages=passages, embeddings=emb), enc,
                                family="flat",
                                params=FlatParams(dtype="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if retriever.index.size <= flat._DENSE_THRESHOLD:
        raise AssertionError("corpus too small to reach the kernels")
    for b in range(0, QWEN_PLANTED, BATCH):
        check_top1(retriever.retrieve_batch(texts[b:b + BATCH], k=10),
                   planted[b:b + BATCH].tolist())
    long_r = Retriever(enc_long, retriever.index, retriever.corpus,
                       family="flat", params=retriever.params)
    for i, t in enumerate(long_texts):
        check_top1([long_r.retrieve(t, k=10)], [int(planted[QWEN_PLANTED + i])])
    launches = read_launches(ATTN_KERNELS + ("flat_topk_exact",))
    hook.remove()
    by_shape = {}
    for b, s in shapes:
        key = f"{b}x{s}"
        by_shape[key] = by_shape.get(key, 0) + cfg.num_layers
    if sum(by_shape.values()) != launches["flash_attention"]:
        raise AssertionError(f"K7 launched {launches['flash_attention']} "
                             f"times in {len(shapes)} forward calls of "
                             f"{cfg.num_layers} layers")

    # K1 vs its plain version at the shapes this path gave it (the flat
    # phases hold it at D = 384 only): the index's own arrays, a batch of
    # 16 planted embeddings and the one long query, k = 10
    ix = retriever.index
    k1_err = 0.0
    for queries in (planted_emb[:BATCH], planted_emb[QWEN_PLANTED:][:1]):
        args = (ix.vectors, ix.sqnorms, queries, ix.n_valid, ix.scales)
        kw = dict(k=10, metric=flat._kernel_metric(ix.metric))
        k1_err = max(k1_err, compare_topk(
            *fk.flat_topk_exact(*args, **kw),
            *fk.flat_topk_exact_plain(*args, **kw), **TOL))

    # a passage alone against the same passage inside its batch of 16
    alone = enc.encode_device(texts[3:4])[0]
    alone_diff = float((alone - planted_emb[3]).abs().max())
    # the same encodes with the plain attention in K7's place
    qwen_encoder.flash_attention = ak.flash_attention_plain
    try:
        plain_short = enc.encode_device(texts[:BATCH])
        plain_long = enc_long.encode_device(long_texts[:1])
    finally:
        qwen_encoder.flash_attention = ak.flash_attention
    cos_short = float((plain_short * planted_emb[:BATCH]).sum(1).min())
    cos_long = float((plain_long[0] * planted_emb[QWEN_PLANTED]).sum())
    if alone_diff >= 2e-2 or cos_short < 0.999 or cos_long < 0.999:
        raise AssertionError(
            f"alone vs batch {alone_diff}, kernel vs plain attention cosine "
            f"{cos_short} (16 x 512), {cos_long} (1 x 8192)")
    if not torch.isfinite(planted_emb).all():
        raise AssertionError("non-finite embeddings")
    pair = torch.cdist(planted_emb, planted_emb) ** 2
    off = ~torch.eye(len(planted_emb), dtype=torch.bool, device=dev)
    out = {
        "rows": QWEN_ROWS, "dim": cfg.hidden_size, "layers": cfg.num_layers,
        "planted": QWEN_PLANTED, "planted_long": QWEN_LONG,
        "long_tokens": int(np.asarray(enc_long.tokenizer(
            long_texts, max_length=8192)["attention_mask"]).sum(1).min()),
        "model_s": model_s, "build_s": build_s,
        "queries_checked": QWEN_PLANTED + QWEN_LONG,
        "forward_calls": len(shapes), "launches": launches,
        "launches_by_shape": by_shape,
        "flat_topk_exact_max_abs_err_dim1024": k1_err,
        "alone_vs_batch_max_abs_diff": alone_diff,
        "cosine_vs_plain_attention_16x512": cos_short,
        "cosine_vs_plain_attention_1x8192": cos_long,
        "planted_mean_pairwise_sqdist": float(pair[off].mean()),
        "planted_min_pairwise_sqdist": float(pair[off].min()),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return out, (enc, enc_long, texts, long_texts, by_shape)


# ---------------------------------------------------------------- timing ---


# The port's own kernels, as the profiler names them.
OWN_KERNELS = ("exact_scan_kernel", "ivf_scan_kernel", "merge_partials_kernel",
               "pq_adc_kernel", "flash_attn_kernel")


def profile_calls(fn, calls: int = 20, top: int = 6) -> dict:
    """torch.profiler over `calls` back-to-back fn(): host ms per call (wall
    clock, synchronized at the end), device-busy ms per call (the sum of the
    kernels' device times), kernels launched per call, the `top` kernels by
    device time, and the port's own kernels among them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / calls * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
                      for e in prof.key_averages()
                      # the kernels themselves, not the ops that launch them
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    return {"host_ms_per_call": host_ms,
            "device_ms_per_call": sum(r[1] for r in kernels),
            "device_kernels_per_call": sum(r[2] for r in kernels),
            "top_kernels_ms": {name[:60]: ms for name, ms, _ in kernels[:top]},
            "own_kernels_ms": {own: ms for name, ms, _ in kernels
                               for own in OWN_KERNELS if own in name}}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / H100_OPS_PER_S[kind]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "operations": int(n_ops)}


def flat_bound(vectors, sqnorms, q, n_valid, scales, *, k, **_):
    """A flat scan reads every stored row, its sqnorm and scale once and
    the queries, and writes (Q, k) scores and ids; 2·Q·N·D operations in
    the storage type."""
    kind = {2: "bf16", 1: "int8", 4: "fp32"}[vectors.element_size()]
    return bound(nbytes(vectors, sqnorms, scales, q) + q.shape[0] * k * 8,
                 2.0 * q.shape[0] * n_valid * vectors.shape[1], kind)


def ivf_bound(vectors, sqnorms, scales, q, offs, cnts, *, k, window, **_):
    """A probed scan reads this run's live window rows (each with its
    sqnorm and scale), the queries and the (Q, P) offsets and counts, and
    writes (Q, k) scores and positions; 2·D operations per live row."""
    live = int(cnts.clamp(max=window).sum())
    d = vectors.shape[1]
    kind = {2: "bf16", 1: "int8", 4: "fp32"}[vectors.element_size()]
    return bound(live * (d * vectors.element_size() + 8)
                 + nbytes(q, offs, cnts) + q.shape[0] * k * 8,
                 2.0 * live * d, kind)


def pq_bound(codes, row_ids, corr, luts, offs, cnts, coarse, *, window):
    """K6 reads this run's live slots (mb code bytes, an id and, when there
    is one, a correction each), the tables and the (Q, P) offsets, counts
    and coarse scores, and writes (Q, P, window) scores and ids; one fp32
    add per live slot and nibble stream."""
    live = int(cnts.clamp(max=window).sum())
    mb = codes.shape[0]
    return bound(live * (mb + 4 + (4 if corr is not None else 0))
                 + nbytes(luts, offs, cnts, coarse) + offs.numel() * window * 8,
                 2.0 * mb * live, "fp32")


def timing_phase(flat_r, ivf_r, pq_r, ooc_r, enc, texts, launches: dict):
    """Encode and search ms per batch of BATCH planted passages, then each
    kernel vs its plain version at the main paths' call shapes, beside its
    bound: K1 a batch of BATCH queries at k = 10 (and the library call
    that computes the same: one matmul + top-k over the corpus), K2 one
    query at k = 10 (approx retrieve), K3 one query at k = 2000; K4 BATCH
    queries at k = 10 and K5 one query at k = 2000, each over its queries'
    N_PROBES probed windows; K6 BATCH queries (and one) over theirs."""
    import torch

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms
    from cuvs_rag_tpu_torch.index import flat, ivf_flat, ivf_pq, refine
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.ops import pq as pq_ops
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.ops import topk as topk_ops
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import IVFPQSearchParams

    qtexts = texts[:BATCH]
    q = enc.encode_device(qtexts)
    q1 = enc.encode_device(texts[:1])
    pq_ix, ooc_ix = pq_r.index, ooc_r.index
    sp2 = IVFPQSearchParams(n_probes=N_PROBES, refine_ratio=2)
    sp64 = IVFPQSearchParams(n_probes=N_PROBES, refine_ratio=REFINE_TUNED)
    _, cand = ivf_pq.search(
        IVFPQSearchParams(n_probes=N_PROBES, refine_ratio=0), ooc_ix, q,
        ivf_pq._refine_pool(10, REFINE_TUNED))
    qp = ivf_pq._prep_queries(pq_ix, q)
    _, probes = ivf_ops.probe_lists(qp, pq_ix.centroids,
                                    pq_ix.centroid_sqnorms, N_PROBES,
                                    pq_ix.metric)
    store = ooc_r.corpus.embeddings
    t0 = time.perf_counter()
    for _ in range(5):
        refine.rerank_host(q, cand, 10, store.fetch_rows, metric=ooc_ix.metric)
    host_rerank_ms = (time.perf_counter() - t0) / 5 * 1e3
    e2e = {
        "encode_ms_per_batch": cuda_ms(lambda: enc.encode_device(qtexts), 20),
        "search_ms_per_batch": cuda_ms(
            lambda: flat.search(None, flat_r.index, q, 10), 20),
        "ivf_search_ms_per_batch": cuda_ms(
            lambda: ivf_flat.search(None, ivf_r.index, q, 10), 20),
        "pq_search_ms_per_batch_refine_2": cuda_ms(
            lambda: ivf_pq.search(sp2, pq_ix, q, 10), 20),
        "pq_search_ms_per_batch_refine_64": cuda_ms(
            lambda: ivf_pq.search(sp64, pq_ix, q, 10), 20),
        "pq_adc_lut_ms": cuda_ms(lambda: pq_ops.probe_luts(
            qp, probes, pq_ix.centroids, pq_ix.codebooks, pq_ix.metric,
            levels=pq_ix.levels), 20),
        "pq_host_rerank_ms_per_batch": host_rerank_ms,
        "pq_host_rerank_candidates": int(cand.shape[1]),
        "batch": BATCH,
    }

    e2e["profile"] = {
        "ivf_flat_search": profile_calls(
            lambda: ivf_flat.search(None, ivf_r.index, q, 10)),
        "ivf_pq_search_refine_2": profile_calls(
            lambda: ivf_pq.search(sp2, pq_ix, q, 10)),
        "ivf_pq_search_refine_64": profile_calls(
            lambda: ivf_pq.search(sp64, pq_ix, q, 10)),
    }

    ix = flat_r.index
    sq = "sqeuclidean"
    tile_c = min(ix.tile_n, 2048)
    k1_args = (ix.vectors, ix.sqnorms, q, ix.n_valid, ix.scales)
    cases = [
        ("flat_topk_exact", k1_args, dict(k=10, metric=sq), flat_bound),
        ("flat_topk_sketch", (ix.vectors, ix.sqnorms, q1, ix.n_valid, ix.scales),
         dict(k=10, metric=sq, tile_c=tile_c), flat_bound),
        ("flat_topk_large", (ix.vectors, ix.sqnorms, q1, ix.n_valid, ix.scales),
         dict(k=2000, metric=sq), flat_bound),
    ]
    iv = ivf_r.index
    n_sub, r_planes = ik.large_k_config(iv.max_list_size, D, K_LARGE)
    for name, qs, kw in (
            ("ivf_scan", q, dict(k=10)),
            ("ivf_scan_large", q1, dict(k=K_LARGE, n_sub=n_sub,
                                        r_planes=r_planes))):
        probes, _ = ivf_flat.probe(iv, qs, N_PROBES)
        p = probes.long()
        cases.append((name, (iv.vectors, iv.sqnorms, iv.scales, qs,
                             iv.list_offsets[p], iv.list_counts[p]),
                      dict(window=iv.max_list_size, metric=sq, **kw),
                      ivf_bound))
    fns = kernel_fns()
    rows = []
    for name, args, kw, bound_fn in cases:
        kern, plain = fns[name]
        got, want = kern(*args, **kw), plain(*args, **kw)
        if len(got) == 3 and not torch.equal(got[2], want[2]):
            raise AssertionError(f"{name} certificate differs from plain")
        err = compare_topk(got[0], got[1], want[0], want[1], **TOL)
        library_ms = None
        if name == "flat_topk_exact":
            # the one library route to K1's function: a (Q, N) matmul and a
            # top-k over it; timed here as a yardstick only
            lib = topk_ops.flat_topk_search_dense(*args, **kw)
            compare_topk(lib[0], lib[1], want[0], want[1], **TOL)
            library_ms = cuda_ms(
                lambda: topk_ops.flat_topk_search_dense(*args, **kw), 5, 1)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(*args, **kw), 10),
            "plain_ms": cuda_ms(lambda: plain(*args, **kw), 10),
            **bound_fn(*args, **kw), "library_ms": library_ms,
        })

    # K6 at the main path's probes: BATCH queries (its row of the kernels
    # line) and one query
    for qs in (q, q1):
        args = pq_scan_args(pq_ix, qs)
        kw = dict(window=pq_ix.max_list_size)
        s, i = pk.pq_adc_scores(*args, **kw)
        ps, pi = pk.pq_adc_scores_plain(*args, **kw)
        live = torch.isfinite(ps)
        if not torch.equal(i, pi) or not torch.equal(torch.isfinite(s), live):
            raise AssertionError("K6 ids or -inf pattern differ from plain")
        torch.testing.assert_close(s[live], ps[live], **PQ_TOL)
        row = {
            "name": "pq_adc_scores", "route": "cuda",
            "source": SOURCES["pq_adc_scores"],
            "replaces": REPLACES["pq_adc_scores"],
            "launches": launches["pq_adc_scores"],
            "max_abs_err": float((s[live] - ps[live]).abs().max()),
            "ms": cuda_ms(lambda: pk.pq_adc_scores(*args, **kw), 20),
            "plain_ms": cuda_ms(lambda: pk.pq_adc_scores_plain(*args, **kw), 10),
            **pq_bound(*args, **kw), "library_ms": None,
        }
        if qs is q:
            rows.append(row)
            e2e["pq_live_slots_per_batch"] = int(live.sum())
        else:
            e2e["pq_adc_one_query"] = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bytes", "max_abs_err")}
    return e2e, rows


def attn_bound(q, k, v, mask) -> dict:
    """K7 reads q, k, v and the mask once and writes the output; its
    operations are 4 hd per head and allowed (query, key) pair of this run's
    mask (two products): a segment of n tokens allows n (n + 1) / 2 pairs."""
    import torch

    _, _, nh, hd = q.shape
    real = mask.to(torch.int64).sum(1)
    pad = mask.shape[1] - real
    pairs = int((real * (real + 1) // 2 + pad * (pad + 1) // 2).sum())
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32"
    return bound(nbytes(q, k, v, mask) + nbytes(q), 4.0 * hd * nh * pairs, kind)


def qwen_timing(enc, enc_long, texts, long_texts, by_shape, seed: int):
    """Encode ms per batch (16 x 512 and 1 x 8,192 tokens) with a profile of
    each, and K7 per launch at both shapes (the masks the tokenizer gives
    those texts) vs its plain version, beside its bound and one library call
    (scaled_dot_product_attention on the same inputs, GQA heads repeated
    and the same mask, outside the timed region)."""
    import torch
    import torch.nn.functional as F

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak

    dev = enc.device
    cfg = enc.cfg
    batch = texts[:BATCH]
    e2e = {
        "qwen_encode_ms_per_batch_16x512": cuda_ms(
            lambda: enc.encode_device(batch), 5, 1),
        "qwen_encode_ms_1x8192": cuda_ms(
            lambda: enc_long.encode_device(long_texts[:1]), 3, 1),
        "qwen_profile": {
            "encode_16x512": profile_calls(
                lambda: enc.encode_device(batch), calls=3),
            "encode_1x8192": profile_calls(
                lambda: enc_long.encode_device(long_texts[:1]), calls=2),
        },
    }
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    rows = []
    for encoder, tx in ((enc, batch), (enc_long, long_texts[:1])):
        mask = torch.as_tensor(np.asarray(encoder.tokenizer(
            tx, max_length=encoder.max_length)["attention_mask"]),
            dtype=torch.int32, device=dev)
        b, s = mask.shape
        q, k, v = attn_inputs(b, s, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, torch.bfloat16, gen, dev)
        scale = cfg.head_dim ** -0.5
        err, want = attn_hold(ak.flash_attention(q, k, v, mask, scale),
                              q, k, v, mask, scale)
        # the library's attention: (B, H, S, hd), kv heads repeated, the
        # same mask as a boolean (B, 1, S, S) where there are pads
        rep = cfg.num_heads // cfg.num_kv_heads
        lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)))
        if bool(mask.all()):
            rule = dict(is_causal=True)
        else:
            allow = (mask[:, :, None] == mask[:, None, :]) & torch.tril(
                torch.ones((s, s), dtype=torch.bool, device=dev))
            rule = dict(attn_mask=allow[:, None])

        def lib():
            return F.scaled_dot_product_attention(lq, lk, lv, scale=scale,
                                                  **rule)

        torch.testing.assert_close(lib().transpose(1, 2).float(), want,
                                   **ATTN_LIBRARY_TOL)
        del want
        shape = f"{b}x{s}"
        rows.append({
            "name": "flash_attention", "shape": shape, "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"],
            "launches": by_shape[shape],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ak.flash_attention(q, k, v, mask, scale),
                          5, 1),
            "plain_ms": cuda_ms(
                lambda: ak.flash_attention_plain(q, k, v, mask, scale), 3, 1),
            **attn_bound(q, k, v, mask),
            "library_ms": cuda_ms(lib, 5, 1),
        })
        del lq, lk, lv
    return e2e, rows


def stream_timing(emb, seed: int):
    """The measurement path of eval/roofline.py on the flat corpus: M1's
    read rates over all of it; gather rates at the scripts' shapes (m =
    GATHER_M2 and GATHER_M4 ids into GATHER_ROWS rows of 768 bf16 or int8
    values) and at refine's (16 x 640 rows of the corpus itself). Each
    case is first held against its plain version (roofline's checks); then
    the kernels' launch counters are set to 0, the rates taken, and the
    counters read. Returns
    (fields, kernel rows, the best measured read rate in bytes/s)."""
    import torch

    from cuvs_rag_tpu_torch.eval import roofline
    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms
    from cuvs_rag_tpu_torch.ops import stream_kernels as sk

    gen = torch.Generator(device=emb.device).manual_seed(seed + 6)
    wide, as_int8 = gather_views(emb, GATHER_ROWS)
    cases = {"bf16_m2": (wide, GATHER_M2), "int8_m2": (as_int8, GATHER_M2),
             "bf16_m4": (wide, GATHER_M4),
             "refine_16x640": (emb, BATCH * (10 * REFINE_TUNED))}
    # every case against its plain version first; these launches are not
    # the path's, the counts are set to 0 after them
    sets, held = {}, {}
    for key, (vectors, m) in cases.items():
        sets[key] = roofline.gather_ids(vectors.shape[0], m, gen)
        held[key] = roofline.check_gathers(vectors, sets[key])
    held["read"] = roofline.check_read(emb)
    reset_launches()
    read = roofline.read_rates(emb)
    gathers = {}
    for key, (vectors, _) in cases.items():
        before = sk.gather_rows.launches
        gathers[key] = roofline.gather_rates(vectors, sets[key])
        gathers[key]["gather_rows_launches"] = sk.gather_rows.launches - before
    launches = read_launches(STREAM_KERNELS)
    fields = {"read": read, "gather": gathers, "launches": launches,
              "held_against_plain": held}

    def row(name, replaces, shape, n_launches, err, ms, plain, n_bytes, n_ops,
            library_ms):
        return {"name": name, "shape": shape, "route": "cuda",
                "source": SOURCES[name], "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": cuda_ms(plain, 5, 1),
                **bound(n_bytes, n_ops, "fp32"), "library_ms": library_ms}

    rows = [row("read_all", REPLACES["read_all"],
                f"{emb.shape[0]}x{emb.shape[1]} reduce", launches["read_all"],
                0.0, read["reduce"]["ms"],
                lambda: sk.read_all_plain(emb, True),
                read["bytes"] + 8 * 128 * 4, float(emb.numel()),
                read["torch_amax"]["ms"])]
    for key, m, replaces in (("bf16_m2", GATHER_M2, REPLACES["gather_rows"]),
                             ("bf16_m4", GATHER_M4, REPLACES_M4)):
        g, ids = gathers[key], sets[key]["rows"]
        rows.append(row(
            "gather_rows", replaces, f"{m} of {GATHER_ROWS}x768 bf16",
            g["gather_rows_launches"], 0.0, g["rows"]["ms"],
            lambda: sk.gather_rows_plain(wide, ids, check_ids=False),
            2 * m * g["row_bytes"] + 8 * m, 0.0,
            g["torch_index_select"]["ms"]))
    g, ids = gathers["bf16_m2"], sets["bf16_m2"]["rows"]
    # no one library call returns the fp32 sum of gathered bf16 rows:
    # embedding_bag, the nearest, rounds its sum to bf16, so it is reported
    # under its own name and library_ms stays null
    rows.append(dict(row(
        "gather_reduce", REPLACES["gather_reduce"],
        f"{GATHER_M2} of {GATHER_ROWS}x768 bf16", launches["gather_reduce"],
        held["bf16_m2"]["reduce_max_abs_err"]["rows"], g["reduce"]["ms"],
        lambda: sk.gather_reduce_plain(wide, ids, check_ids=False),
        GATHER_M2 * (g["row_bytes"] + 8) + 768 * 4, GATHER_M2 * 768.0, None),
        nearest_library="torch.nn.functional.embedding_bag(mode='sum'), "
                        "bf16 result",
        nearest_library_ms=g["torch_embedding_bag_sum"]["ms"]))
    return fields, rows, read["best_gb_per_s"] * 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from cuvs_rag_tpu_torch.eval.roofline import REDUCE_TOL, gpu_line
    from cuvs_rag_tpu_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    emit("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    sources = sorted({os.path.basename(src) for src in SOURCES.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    emit("build", sources=sources, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    parity = parity_phase(PARITY_ROWS, PARITY_RAGGED, args.seed)
    emit("parity", gpu=gpu, dim=D, rows=PARITY_ROWS,
         ragged_rows=PARITY_RAGGED, **TOL,
         max_abs_err=parity, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    ivf_parity = ivf_parity_phase(PARITY_ROWS, args.seed)
    emit("ivf_parity", gpu=gpu, dim=D, rows=PARITY_ROWS, n_probes=N_PROBES,
         k_large=K_LARGE, **TOL, max_abs_err=ivf_parity,
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    attn_parity = attn_parity_phase(args.seed)
    emit("attn_parity", gpu=gpu, tolerance=ATTN_TOL, **attn_parity,
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    enc = make_encoder(args.seed, dev)
    emb, passages, planted, texts = make_corpus(args.seed, enc, dev)
    rng = np.random.default_rng(args.seed + 2)
    main_out, flat_r, flat_ids = main_path(enc, emb, passages, planted, texts,
                                           rng)
    emit("main", gpu=gpu, seconds=time.perf_counter() - t0, **main_out)

    t0 = time.perf_counter()
    stream_parity = stream_parity_phase(emb, PARITY_RAGGED, args.seed)
    emit("stream_parity", gpu=gpu, rows=ROWS, dim=D,
         ragged_rows=PARITY_RAGGED, ids=GATHER_M2, reduce_tolerance=REDUCE_TOL,
         **stream_parity, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    ivf_out, ivf_r = ivf_main_path(enc, emb, passages, planted, texts,
                                   flat_ids, rng)
    emit("ivf_main", gpu=gpu, seconds=time.perf_counter() - t0, **ivf_out)

    t0 = time.perf_counter()
    pq_parity = pq_parity_phase(PARITY_ROWS, args.seed)
    emit("pq_parity", gpu=gpu, dim=D, rows=PARITY_ROWS, n_probes=N_PROBES,
         **PQ_TOL, max_abs_err=pq_parity, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    pq_out, pq_r, ooc_r = pq_main_path(enc, emb, passages, planted, texts,
                                       flat_ids, flat_r.index, rng)
    tmp = pq_out.pop("tmp")
    try:
        emit("pq_main", gpu=gpu, seconds=time.perf_counter() - t0, **pq_out)
        e2e, kernels = timing_phase(
            flat_r, ivf_r, pq_r, ooc_r, enc, texts,
            {**main_out["launches"], **ivf_out["launches"],
             **pq_out["launches"]})
    finally:
        tmp.cleanup()
    # the IVF retrievers and their stores are done: free them for what follows
    del ivf_r, pq_r, ooc_r, flat_r, passages
    torch.cuda.empty_cache()
    stream_out, stream_rows, read_rate = stream_timing(emb, args.seed)
    del emb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qwen_out, qwen_state = qwen_main_path(args.seed, dev)
    emit("qwen_main", gpu=gpu, seconds=time.perf_counter() - t0, **qwen_out)
    qwen_e2e, qwen_rows = qwen_timing(*qwen_state, args.seed)

    kernels += qwen_rows + stream_rows
    for row in kernels:
        # the same bytes over the streaming-read rate that M1 measured here
        row["measured_bound_ms"] = 1e3 * row["bytes"] / read_rate
    emit("timing", gpu=gpu, **e2e, **qwen_e2e, measured_read_bytes_per_s=read_rate,
         stream=stream_out)
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
