#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line (any failure raises and the exit code
is non-zero):
  1. device  — requires CUDA; the card's name and power limit (nvidia-smi).
  2. build   — builds the CUDA kernels from cuvs_rag_tpu_torch/csrc/.
  3. parity  — each kernel (K1 exact, K2 sketch, K3 large-k) against its
               plain PyTorch version at D = 384 on 1,048,576 rows, and on a
               ragged corpus with tombstoned rows.
  4. main    — the retrieval path at full width: a MiniLM-L6-shaped encoder
               with seeded random weights, a 6,290,000 x 384 bf16 corpus
               (the reference's FAISS Wikipedia deployment) with 4,096
               planted passages, Retriever.build / retrieve_batch /
               retrieve (k = 2000, approx) / delete / extend. The kernels'
               launch counters are reset before and read after this phase.
  5. timing  — each kernel against its plain version at the main path's
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

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "cuvs_rag_tpu_torch/csrc/flat_topk.cu"
# TPU kernel bodies the three CUDA kernels replace.
REPLACES = {
    "flat_topk_exact": "cuvs_rag_tpu/ops/pallas_flat.py:166",
    "flat_topk_sketch": "cuvs_rag_tpu/ops/pallas_flat.py:224",
    "flat_topk_large": "cuvs_rag_tpu/ops/pallas_flat.py:275",
}
D = 384
# The workload: the reference's FAISS Wikipedia corpus, 4,096 planted
# passages checked in 64 batches of 16, and the parity corpora.
ROWS = 6_290_000
PLANTED = 4096
BATCHES = 64
BATCH = 16
PARITY_ROWS = 1 << 20
PARITY_RAGGED = 1_000_003
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


# ---------------------------------------------------------------- parity ---


def make_rows(n, d, gen, device):
    import torch

    return torch.randn((n, d), generator=gen, device=device)


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


# ------------------------------------------------------------- main path ---


def synthetic_passages(n: int, rng) -> list:
    words = [f"w{i}" for i in range(5000)]
    return [
        f"passage {i} " + " ".join(rng.choice(words, size=int(rng.integers(20, 200))))
        for i in range(n)
    ]


def main_path(seed: int):
    import torch

    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.models.bert_encoder import (
        BertConfig, BertEncoderModel, TorchSentenceEncoder)
    from cuvs_rag_tpu_torch.models.encoder import HashTokenizer
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import FlatParams, FlatSearchParams
    from cuvs_rag_tpu_torch.utils.metrics import default_registry

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig.minilm_l6()
    model = BertEncoderModel(cfg).init_random_(torch.Generator().manual_seed(seed))
    # ids = hash(word) % vocab_mod + 1 must stay below vocab_size
    enc = TorchSentenceEncoder(cfg, model, HashTokenizer(cfg.vocab_size - 1),
                               max_length=256, device=dev)

    rng = np.random.default_rng(seed)
    texts = synthetic_passages(PLANTED, rng)
    planted = np.sort(rng.choice(ROWS, size=PLANTED, replace=False))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    emb = torch.empty((ROWS, cfg.hidden_size), dtype=torch.bfloat16, device=dev)
    for i in range(0, ROWS, 1 << 20):
        rows = make_rows(min(1 << 20, ROWS - i), cfg.hidden_size, gen, dev)
        emb[i : i + rows.shape[0]] = torch.nn.functional.normalize(rows, dim=1).to(torch.bfloat16)
    emb[torch.as_tensor(planted, device=dev)] = enc.encode_device(
        texts, batch_size=256).to(torch.bfloat16)
    passages = [""] * ROWS
    for row, t in zip(planted.tolist(), texts):
        passages[row] = t

    t0 = time.perf_counter()
    retriever = Retriever.build(Corpus(passages=passages, embeddings=emb), enc,
                                family="flat",
                                params=FlatParams(dtype="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if retriever.index.size <= flat._DENSE_THRESHOLD:
        raise AssertionError("corpus too small to reach the kernels")

    def check_top1(results, rows):
        for res, row in zip(results, rows):
            top = res.passages[0]
            if top.index != row or not top.distance < 0.05:
                raise AssertionError(f"planted row {row}: got {top.index} "
                                     f"at distance {top.distance}")

    fk.flat_topk_exact.launches = 0
    fk.flat_topk_sketch.launches = 0
    fk.flat_topk_large.launches = 0
    reruns0 = default_registry.snapshot()["counters"].get("flat.certificate_reruns", 0)
    n_checked = 0
    for b in range(BATCHES):
        sel = range((b * BATCH) % PLANTED, (b * BATCH) % PLANTED + BATCH)
        check_top1(retriever.retrieve_batch([texts[i] for i in sel], k=10),
                   [int(planted[i]) for i in sel])
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
    launches = {name: getattr(fk, name).launches for name in REPLACES}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    reruns = default_registry.snapshot()["counters"].get(
        "flat.certificate_reruns", 0) - reruns0
    out = {
        "rows": ROWS, "dim": cfg.hidden_size, "planted": PLANTED,
        "queries_checked": n_checked + 4, "build_s": build_s,
        "launches": launches, "certificate_reruns": reruns,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return out, retriever, enc, texts


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


def timing_phase(retriever, enc, texts, launches: dict):
    """Encode and search ms per batch of BATCH planted passages, then each
    kernel vs its plain version at the main path's call shapes: K1 a batch
    of BATCH queries at k = 10, K2 one query at k = 10 (approx retrieve),
    K3 one query at k = 2000."""
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.compare import compare_topk

    qtexts = texts[:BATCH]
    q = enc.encode_device(qtexts)
    e2e = {
        "encode_ms_per_batch": cuda_ms(lambda: enc.encode_device(qtexts), 20),
        "search_ms_per_batch": cuda_ms(
            lambda: flat.search(None, retriever.index, q, 10), 20),
        "batch": BATCH,
    }

    ix = retriever.index
    args_b = (ix.vectors, ix.sqnorms, enc.encode_device(texts[:BATCH]),
              ix.n_valid, ix.scales)
    args_1 = (ix.vectors, ix.sqnorms, enc.encode_device(texts[:1]),
              ix.n_valid, ix.scales)
    sq = "sqeuclidean"
    tile_c = min(ix.tile_n, 2048)
    cases = [
        ("flat_topk_exact", args_b, dict(k=10, metric=sq)),
        ("flat_topk_sketch", args_1, dict(k=10, metric=sq, tile_c=tile_c)),
        ("flat_topk_large", args_1, dict(k=2000, metric=sq)),
    ]
    rows = []
    for name, args, kw in cases:
        kern = getattr(fk, name)
        plain = getattr(fk, name + "_plain")
        got, want = kern(*args, **kw), plain(*args, **kw)
        err = compare_topk(got[0], got[1], want[0], want[1], **TOL)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    emit("device", gpu=gpu, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.load("flat_topk.cu")
    emit("build", source=SOURCE, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    parity = parity_phase(PARITY_ROWS, PARITY_RAGGED, args.seed)
    emit("parity", gpu=gpu, dim=D, rows=PARITY_ROWS,
         ragged_rows=PARITY_RAGGED, **TOL,
         max_abs_err=parity, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    main_out, retriever, enc, texts = main_path(args.seed)
    emit("main", gpu=gpu, seconds=time.perf_counter() - t0, **main_out)

    e2e, kernels = timing_phase(retriever, enc, texts,
                                main_out["launches"])
    emit("timing", gpu=gpu, **e2e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
