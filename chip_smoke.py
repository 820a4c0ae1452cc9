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
  7. timing  — each kernel against its plain version at the main paths'
               shapes (CUDA events), then the kernels JSON line.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
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
}
REPLACES = {
    "flat_topk_exact": "cuvs_rag_tpu/ops/pallas_flat.py:166",
    "flat_topk_sketch": "cuvs_rag_tpu/ops/pallas_flat.py:224",
    "flat_topk_large": "cuvs_rag_tpu/ops/pallas_flat.py:275",
    "ivf_scan": "cuvs_rag_tpu/ops/pallas_ivf.py:92",
    "ivf_scan_large": "cuvs_rag_tpu/ops/pallas_ivf.py:314",
}
FLAT_KERNELS = ("flat_topk_exact", "flat_topk_sketch", "flat_topk_large")
IVF_KERNELS = ("ivf_scan", "ivf_scan_large")
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def kernel_fns():
    """Each wrapper by name, with its plain version."""
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik

    mods = {**{n: fk for n in FLAT_KERNELS}, **{n: ik for n in IVF_KERNELS}}
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


def make_centres(gen, device):
    import torch

    return torch.nn.functional.normalize(make_rows(CENTRES, D, gen, device),
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


def ivf_main_path(enc, emb, passages, planted, texts, flat_ids, rng):
    """The IVF-Flat path at N_PROBES probes. A planted query's top-1 must be
    its row whenever that row's list is among the query's probed lists, and
    at least 99% of the planted queries must be so. Returns (fields,
    retriever)."""
    import torch

    from cuvs_rag_tpu_torch.eval.recall import recall_at_k
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.ops import ivf as ivf_ops
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    dev = emb.device
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    retriever = Retriever.build(
        Corpus(passages=list(passages), embeddings=emb), enc,
        family="ivf_flat", params=IVFFlatParams(dtype="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix = retriever.index
    slot_of, label_of_slot = ivf_ops.invert_layout(ix.row_ids,
                                                   ix.list_offsets, ROWS)
    planted_t = torch.as_tensor(planted, device=dev)
    list_of = label_of_slot[slot_of[planted_t.long()].long()]

    def probed(numbers):
        """Whether each planted query's row is in one of its probed lists."""
        q = enc.encode_device([texts[i] for i in numbers])
        probes, _ = ivf_flat.probe(ix, q, N_PROBES)
        sel = torch.as_tensor(list(numbers), device=dev)
        return (probes == list_of[sel][:, None]).any(dim=1).tolist()

    def check_reachable(results, numbers):
        hits = 0
        for res, i, ok in zip(results, numbers, probed(numbers)):
            if ok:
                check_top1([res], [int(planted[i])])
                hits += 1
        return hits

    reset_launches()
    reruns0 = counter("ivf_flat.certificate_reruns")
    reachable, ivf_ids = 0, []
    for sel in planted_batches():
        results = retriever.retrieve_batch([texts[i] for i in sel], k=10)
        reachable += check_reachable(results, sel)
        ivf_ids += [[p.index for p in r.passages]
                    + [-1] * (10 - len(r.passages)) for r in results]
    n_checked = BATCHES * BATCH
    if reachable < 0.99 * n_checked:
        raise AssertionError(f"only {reachable}/{n_checked} planted rows lie "
                             "in a probed list")
    recall = recall_at_k(np.asarray(ivf_ids), flat_ids, 10)
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
    # allow every id not divisible by 3, then exclude one planted row and
    # allow another
    allow = np.arange(len(retriever.corpus.passages)) % 3 != 0
    excluded, kept = int(planted[first[2]]), int(planted[first[3]])
    allow[excluded], allow[kept] = False, True

    def filtered_ids(i):
        ids = [p.index for p in retriever.retrieve(texts[i], k=10,
                                                   allow=allow).passages]
        if not ids or not allow[ids].all():
            raise AssertionError(f"filtered results {ids} leave the mask")
        return ids

    if excluded in filtered_ids(first[2]):
        raise AssertionError("a row the mask excludes came back")
    if filtered_ids(first[3])[0] != kept:
        raise AssertionError("an allowed planted row lost its top-1")
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


# ---------------------------------------------------------------- timing ---


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timing_phase(flat_r, ivf_r, enc, texts, launches: dict):
    """Encode and search ms per batch of BATCH planted passages, then each
    kernel vs its plain version at the main paths' call shapes: K1 a batch
    of BATCH queries at k = 10, K2 one query at k = 10 (approx retrieve),
    K3 one query at k = 2000; K4 BATCH queries at k = 10 and K5 one query
    at k = 2000, each over its queries' N_PROBES probed windows."""
    import torch

    from cuvs_rag_tpu_torch.index import flat, ivf_flat
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.compare import compare_topk

    qtexts = texts[:BATCH]
    q = enc.encode_device(qtexts)
    q1 = enc.encode_device(texts[:1])
    e2e = {
        "encode_ms_per_batch": cuda_ms(lambda: enc.encode_device(qtexts), 20),
        "search_ms_per_batch": cuda_ms(
            lambda: flat.search(None, flat_r.index, q, 10), 20),
        "ivf_search_ms_per_batch": cuda_ms(
            lambda: ivf_flat.search(None, ivf_r.index, q, 10), 20),
        "batch": BATCH,
    }

    ix = flat_r.index
    sq = "sqeuclidean"
    tile_c = min(ix.tile_n, 2048)
    cases = [
        ("flat_topk_exact", (ix.vectors, ix.sqnorms, q, ix.n_valid, ix.scales),
         dict(k=10, metric=sq)),
        ("flat_topk_sketch", (ix.vectors, ix.sqnorms, q1, ix.n_valid, ix.scales),
         dict(k=10, metric=sq, tile_c=tile_c)),
        ("flat_topk_large", (ix.vectors, ix.sqnorms, q1, ix.n_valid, ix.scales),
         dict(k=2000, metric=sq)),
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
                      dict(window=iv.max_list_size, metric=sq, **kw)))
    fns = kernel_fns()
    rows = []
    for name, args, kw in cases:
        kern, plain = fns[name]
        got, want = kern(*args, **kw), plain(*args, **kw)
        if len(got) == 3 and not torch.equal(got[2], want[2]):
            raise AssertionError(f"{name} certificate differs from plain")
        err = compare_topk(got[0], got[1], want[0], want[1], **TOL)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(*args, **kw), 10),
            "plain_ms": cuda_ms(lambda: plain(*args, **kw), 10),
        })
    return e2e, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
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
    sources = sorted({os.path.basename(s) for s in SOURCES.values()})
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
    dev = torch.device("cuda")
    enc = make_encoder(args.seed, dev)
    emb, passages, planted, texts = make_corpus(args.seed, enc, dev)
    rng = np.random.default_rng(args.seed + 2)
    main_out, flat_r, flat_ids = main_path(enc, emb, passages, planted, texts,
                                           rng)
    emit("main", gpu=gpu, seconds=time.perf_counter() - t0, **main_out)

    t0 = time.perf_counter()
    ivf_out, ivf_r = ivf_main_path(enc, emb, passages, planted, texts,
                                   flat_ids, rng)
    emit("ivf_main", gpu=gpu, seconds=time.perf_counter() - t0, **ivf_out)

    e2e, kernels = timing_phase(
        flat_r, ivf_r, enc, texts,
        {**main_out["launches"], **ivf_out["launches"]})
    emit("timing", gpu=gpu, **e2e)
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
