"""Benchmark harnesses: QPS/latency sweeps, scaling stress tests.

The counterpart of the JAX package's `eval/bench.py`. Times on a card come
from CUDA events around each call after a warm-up
(utils/profiling.call_seconds); on the CPU from the host clock.

Reference parity (SURVEY.md §2 #14-16):
  * batch-size sweep → QPS/latency table (faiss-main.ipynb#cell10:
    batches [1,5,10,20,50] × 5 iters, mean±std)
  * benchmark_method warmup protocol
    (VectorSearch_QuestionRetrieval.ipynb#cell33: 1 warmup, then timed runs)
  * scaling stress harness with breaking-point detection
    (cuVS_Scaling_Stress_Test.ipynb#cell12-14: loop sizes, break on first
    failure) — plus recall vs exact GT at every size, which the reference
    lacked.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from cuvs_rag_tpu_torch.eval import recall as recall_lib
from cuvs_rag_tpu_torch.index import base as index_base
from cuvs_rag_tpu_torch.parallel import search as psearch
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import Metric


@dataclasses.dataclass
class BenchResult:
    batch_size: int
    mean_s: float
    std_s: float
    qps: float
    latency_ms_per_query: float


def time_fn(fn: Callable[[], Any], iters: int = 5, warmup: int = 1):
    """Warmup-then-time protocol (reference #cell33): fn() returns tensors
    (a search's (distances, ids)). Returns (mean, std) seconds a call."""
    ts = profiling.call_seconds(fn, iters, warmup)
    return float(np.mean(ts)), float(np.std(ts))


def batch_size_sweep(
    search_fn: Callable[[torch.Tensor, int], Any],
    queries,
    k: int,
    batch_sizes: Sequence[int] = (1, 5, 10, 20, 50),
    iters: int = 5,
    device=None,
) -> List[BenchResult]:
    """QPS/latency vs batch size (faiss-main.ipynb#cell10 protocol).

    search_fn(query_batch, k) -> (distances, indices); each batch is put
    on `device` first (the card when None; a tensor keeps its device).
    """
    out = []
    for b in batch_sizes:
        qb = index_base.as_tensor(queries[:b], device)
        mean, std = time_fn(lambda: search_fn(qb, k), iters=iters)
        out.append(
            BenchResult(
                batch_size=b,
                mean_s=mean,
                std_s=std,
                qps=b / mean,
                latency_ms_per_query=mean / b * 1e3,
            )
        )
    return out


@dataclasses.dataclass
class StressRow:
    n_vectors: int
    build_s: float
    search_ms: float
    recall_at_10: Optional[float]
    ok: bool
    error: str = ""


def _size_seed(seed: int, n: int, chunk: int = 0) -> int:
    """A generator seed for one size (and one chunk of it)."""
    return (seed * 1_000_003 + n) * 65_537 + chunk


def device_corpus(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n, dim) bf16 N(0, 1) rows made on `device` from a generator seeded
    by (seed, n), written part by part into one buffer: a host-made fp32
    corpus would cost its copy to the card and twice the memory, and the
    harness would find its own breaking point, not the engine's."""
    gen = torch.Generator(device=device).manual_seed(_size_seed(seed, n))
    buf = torch.empty((n, dim), dtype=torch.bfloat16, device=device)
    chunk = max(1, n // 8)
    for start in range(0, n, chunk):
        r = min(chunk, n - start)
        buf[start:start + r] = torch.randn(
            (r, dim), generator=gen, device=device, dtype=torch.bfloat16)
    return buf


def chunk_plan(n: int, target: int = 262_144):
    """(n_chunks, chunk_rows): the smallest chunk count giving chunks <=
    target rows that still divides n."""
    n_chunks = max(1, -(-n // target))
    while n % n_chunks:
        n_chunks += 1
    return n_chunks, n // n_chunks


def chunk_maker(n: int, dim: int, seed: int, device):
    """(chunk_fn, n_chunks, chunk_rows): chunk_fn(i) makes chunk i of the
    size-n corpus anew on `device` from its own seed, so the build and the
    ground truth read the same rows without keeping them."""
    n_chunks, chunk_rows = chunk_plan(n)

    def chunk_fn(i):
        gen = torch.Generator(device=device).manual_seed(
            _size_seed(seed, n, i + 1))
        return torch.randn((chunk_rows, dim), generator=gen, device=device,
                           dtype=torch.bfloat16)

    return chunk_fn, n_chunks, chunk_rows


def scaling_stress(
    family: str,
    make_params: Callable[[int], Any],
    sizes: Sequence[int],
    dim: int,
    *,
    search_params_fn: Callable[[int], Any] = lambda n: None,
    n_queries: int = 5,
    k: int = 10,
    dmesh: Optional[DeviceMesh] = None,
    sharded: bool = False,
    chunked: bool = False,
    eval_recall: bool = True,
    seed: int = 42,
    device=None,
) -> List[StressRow]:
    """Breaking-point protocol: build+search at growing sizes, stop at first
    failure (cuVS_Scaling_Stress_Test.ipynb#cell12-14). Adds recall@10 vs
    exact GT per size (the reference's missing oracle).

    The corpus of each size is made on the device (`device`, the card when
    None; the mesh's first device when sharded). chunked=True is the
    memory-optimized protocol (the reference's
    cuVS_Scaling_Stress_Test_MEMORY_OPTIMIZED.ipynb#cell13 chunked variant):
    the corpus arrives as regenerated device chunks through
    `build_from_chunks`, so only the final index layout is ever resident —
    the breaking point probes the INDEX's footprint, not corpus+index.
    Ground truth streams over the same regenerated chunks."""
    if chunked and sharded:
        raise ValueError("chunked and sharded modes are mutually exclusive")
    mod = psearch.FAMILIES[family]
    if chunked and not hasattr(mod, "build_from_chunks"):
        raise ValueError(f"family {family!r} has no chunked build")
    rows: List[StressRow] = []
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((n_queries, dim)).astype(np.float32)
    if sharded:
        dmesh = dmesh or DeviceMesh()
        dev = dmesh.first
    else:
        dev = index_base.resolve_device(device)
    q = torch.from_numpy(queries).to(dev)

    index = do_search = corpus = None
    for n in sizes:
        # release the previous size's index BEFORE allocating this size's
        # corpus/layout — two resident layouts is a false breaking point
        index = do_search = corpus = None  # noqa: F841
        try:
            # inside the try: at breaking-point sizes the corpus itself
            # may exceed the device — that is a finding to record, not a
            # crash
            corpus = None if chunked else device_corpus(n, dim, seed, dev)
            params = make_params(n)
            t0 = time.perf_counter()
            if chunked:
                chunk_fn, n_chunks, chunk_rows = chunk_maker(
                    n, dim, seed, dev)
                index = mod.build_from_chunks(
                    params, chunk_fn, n, dim, n_chunks=n_chunks, device=dev)
            elif sharded:
                index = psearch.build_sharded(family, params, corpus, dmesh)
            else:
                index = mod.build(params, corpus)
            profiling.drain(dev)
            build_s = time.perf_counter() - t0

            if sharded:
                def do_search():
                    return psearch.search_sharded(
                        search_params_fn(n), index, q, k, dmesh)
            else:
                def do_search():
                    return mod.search(search_params_fn(n), index, q, k)

            mean, _ = time_fn(do_search, iters=3)
            r = None
            if eval_recall:
                _, idx = do_search()
                # device-streamed oracle: the corpus never crosses to host
                if chunked:
                    gt = recall_lib.exact_ground_truth_chunks(
                        chunk_fn, n_chunks, chunk_rows, queries, k,
                        Metric.SQEUCLIDEAN, device=dev,
                    )
                else:
                    gt = recall_lib.exact_ground_truth_streamed(
                        corpus, queries, k, Metric.SQEUCLIDEAN,
                    )
                r = recall_lib.recall_at_k(idx.cpu().numpy(), gt, k)
            rows.append(
                StressRow(
                    n_vectors=n,
                    build_s=build_s,
                    search_ms=mean * 1e3,
                    recall_at_10=r,
                    ok=True,
                )
            )
        except Exception as e:  # breaking point found: record it, stop
            rows.append(
                StressRow(
                    n_vectors=n, build_s=0.0, search_ms=0.0,
                    recall_at_10=None, ok=False, error=f"{type(e).__name__}: {e}",
                )
            )
            print(f"[stress] n={n}: {rows[-1].error}", flush=True)
            break
        print(f"[stress] n={n}: build {rows[-1].build_s:.1f}s "
              f"search {rows[-1].search_ms:.2f}ms", flush=True)
    return rows


def format_table(rows) -> str:
    """Markdown table for any dataclass row list (the reference's pandas
    summaries, cuVS_Scaling_Stress_Test.ipynb#cell17)."""
    rows = list(rows)
    if not rows:
        return "(no rows)"
    fields = [f.name for f in dataclasses.fields(rows[0])]
    lines = ["| " + " | ".join(fields) + " |",
             "|" + "|".join("---" for _ in fields) + "|"]
    for r in rows:
        vals = []
        for f in fields:
            v = getattr(r, f)
            vals.append(f"{v:.4g}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(vals) + " |")
    return "\n".join(lines)
