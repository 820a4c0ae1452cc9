"""What the measurement entry points share, as plain functions on tensors
with an explicit device and generator.

  * corpora: `make_chunk(seed, i, rows, geometry, device)` is chunk i of a
    corpus, drawn on `device` from a `torch.Generator` seeded by (seed,
    chunk) — the stand-in for `jax.random.fold_in(key, i)` — so chunk i is
    the same whenever and in whatever order it is made; `make_corpus`
    writes chunks into one bf16 buffer. A geometry (`Gaussian`,
    `Clustered`, `LowRank`) says how rows are drawn.
  * `streamed_ground_truth`: the exact top-k over chunks made anew, each
    searched by `index/flat.search` (ids offset by i * rows) and merged by
    `ops/topk.merge_topk`: nothing but the (Q, k) result is ever resident.
  * `recall`: the JAX package's `bench.py` `_recall`.
  * `time_batches`: seconds a call over distinct query batches, CUDA events
    after a warm-up (`utils/profiling.call_seconds`).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cuvs_rag_tpu_torch.index import base, flat
from cuvs_rag_tpu_torch.ops import topk as topk_ops
from cuvs_rag_tpu_torch.utils import profiling
from cuvs_rag_tpu_torch.utils.config import FlatParams, Metric

# the streams of one seed: chunk i, query set t, perturbation r, the
# geometry's own draws, time_batches' warm-up batch
CHUNK, QUERIES, PERTURB, GEOMETRY, WARMUP = 1, 2, 3, 4, 5


def fold(seed: int, *path: int) -> int:
    """One generator seed for the stream `path` of `seed`."""
    s = int(seed)
    for p in path:
        s = (s * 1_000_003 + int(p) + 1) % (1 << 62)
    return s


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold(seed, *path))


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card)")


def device_of(args) -> torch.device:
    """The device an entry point runs on: --device, else the card
    (index/base.resolve_device; no fallback to the CPU)."""
    return base.resolve_device(args.device)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's type where it is not a card."""
    if dev.type != "cuda":
        return str(dev)
    from cuvs_rag_tpu_torch.eval.roofline import gpu_line

    return gpu_line()


def sync(dev: torch.device) -> None:
    profiling.drain(dev)


def peak_memory_gb(dev: torch.device) -> Optional[float]:
    """torch.cuda.max_memory_allocated in GB; None off the card."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def reset_peak_memory(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def gb(x: Optional[float]) -> str:
    return "not measured" if x is None else f"{x:.2f} GB"


# --- corpus geometries ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gaussian:
    """N(0, 1) rows."""

    dim: int

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        return torch.randn((m, self.dim), generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True)
class Clustered:
    """centres[c] + sigma * N(0, 1), c uniform over the centres."""

    centres: torch.Tensor  # (n_centres, dim) fp32
    sigma: float

    @property
    def dim(self) -> int:
        return self.centres.shape[1]

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        idx = torch.randint(0, self.centres.shape[0], (m,), generator=gen,
                            device=gen.device)
        return self.centres[idx] + self.sigma * torch.randn(
            (m, self.dim), generator=gen, device=gen.device)


@dataclasses.dataclass(frozen=True)
class LowRank:
    """Rows near an r-dimensional subspace of R^dim: (z_c + sigma * N(0, 1))
    @ basis + jitter * N(0, 1), the subspace's centres z_c uniform (no
    centres: one Gaussian blob), as real text embeddings' spectra decay."""

    basis: torch.Tensor  # (r, dim) orthonormal rows
    centres: Optional[torch.Tensor]  # (n_centres, r) fp32
    sigma: float
    jitter: float = 0.02

    @property
    def dim(self) -> int:
        return self.basis.shape[1]

    def sample(self, gen: torch.Generator, m: int) -> torch.Tensor:
        r = self.basis.shape[0]
        z = self.sigma * torch.randn((m, r), generator=gen, device=gen.device)
        if self.centres is not None:
            z = z + self.centres[torch.randint(
                0, self.centres.shape[0], (m,), generator=gen,
                device=gen.device)]
        return z @ self.basis + self.jitter * torch.randn(
            (m, self.dim), generator=gen, device=gen.device)


def clustered(seed: int, n_centres: int, dim: int, sigma: float,
              device) -> Clustered:
    gen = generator(device, seed, GEOMETRY)
    return Clustered(torch.randn((n_centres, dim), generator=gen,
                                 device=gen.device), sigma)


def low_rank(seed: int, n_centres: int, dim: int, r: int, sigma: float,
             device) -> LowRank:
    """n_centres 0: no cluster structure; r is at most dim."""
    r = min(r, dim)
    gen = generator(device, seed, GEOMETRY)
    q, _ = torch.linalg.qr(torch.randn((dim, r), generator=gen,
                                       device=gen.device))
    centres = torch.randn((n_centres, r), generator=gen, device=gen.device) \
        if n_centres else None
    return LowRank(q.T.contiguous(), centres, sigma)


def make_chunk(seed: int, i: int, rows: int, geometry, device) -> torch.Tensor:
    """Chunk i (rows, dim) bf16 of the corpus `seed` draws from `geometry`,
    on `device`."""
    return geometry.sample(generator(device, seed, CHUNK, i),
                           rows).to(torch.bfloat16)


def make_corpus(seed: int, n: int, geometry, device,
                n_chunks: int = 8) -> torch.Tensor:
    """The (n, dim) bf16 corpus of `n_chunks` chunks, written into one
    buffer."""
    if n % n_chunks:
        raise ValueError(f"n ({n}) must divide into {n_chunks} chunks")
    rows = n // n_chunks
    out = torch.empty((n, geometry.dim), dtype=torch.bfloat16, device=device)
    for i in range(n_chunks):
        out[i * rows:(i + 1) * rows] = make_chunk(seed, i, rows, geometry,
                                                  device)
    return out


def make_queries(seed: int, tag: int, batch: int, geometry,
                 device) -> torch.Tensor:
    """(batch, dim) fp32 queries from the same geometry, stream `tag`."""
    return geometry.sample(generator(device, seed, QUERIES, tag), batch)


def perturbed(queries: torch.Tensor, seed: int, reps: int,
              scale: float = 0.01) -> list:
    """`reps` distinct copies of the queries, each moved by scale * N(0, 1):
    every timed batch is new to the device."""
    return [queries + scale * torch.randn(
        queries.shape, generator=generator(queries.device, seed, PERTURB, r),
        device=queries.device) for r in range(reps)]


def clustered_setup(n: int, d: int, n_centres: int, batch: int, reps: int,
                    device, seed: int = 42, sigma: float = 0.3):
    """(corpus, queries, timed batches) of the scripts' clustered corpus: n
    x d bf16 rows in 8 chunks around n_centres centres at `sigma`, `batch`
    fp32 queries around the same centres, and `reps` moved copies of them
    (`perturbed`)."""
    geo = clustered(seed, n_centres, d, sigma, device)
    corpus = make_corpus(seed, n, geo, device)
    queries = make_queries(seed, 0, batch, geo, device)
    return corpus, queries, perturbed(queries, seed, reps)


# --- exact ground truth, recall, timing ------------------------------------

def _scores(distances: torch.Tensor, metric: str) -> torch.Tensor:
    """A family's distances as larger-is-better scores."""
    return -distances if metric == Metric.SQEUCLIDEAN else distances


def streamed_ground_truth(chunk_fn: Callable[[int], torch.Tensor],
                          n_chunks: int, chunk_rows: int,
                          queries: torch.Tensor, k: int,
                          metric: str = Metric.SQEUCLIDEAN):
    """(distances, ids) numpy (Q, k): the exact top-k over the corpus whose
    chunk i is chunk_fn(i), (chunk_rows, D) rows (numpy or a tensor), put
    on the queries' device. Each
    chunk is searched by flat.search in its own storage dtype (the kernels
    above flat's dense threshold, one fp32 product below it) and merged
    into the running top-k."""
    best_s = torch.full((queries.shape[0], k), topk_ops.NEG_INF,
                        device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int32,
                        device=queries.device)
    for i in range(n_chunks):
        ix = flat.build(FlatParams(metric=metric), chunk_fn(i),
                        device=queries.device)
        d, ids = flat.search(None, ix, queries, k)
        ids = torch.where(ids >= 0, ids + i * chunk_rows, ids)
        best_s, best_i = topk_ops.merge_topk(
            torch.cat([best_s, _scores(d, metric)], dim=1),
            torch.cat([best_i, ids], dim=1), k)
    return _scores(best_s, metric).cpu().numpy(), best_i.cpu().numpy()


def recall(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Mean over queries of |ids[:k] & gt[:k]| / k (bench.py's _recall)."""
    return float(np.mean(
        [len(set(ids[r, :k]) & set(gt[r, :k])) / k
         for r in range(ids.shape[0])]
    ))


def time_batches(fn: Callable, batches: Sequence) -> float:
    """Mean seconds of fn(batch) over the batches, each timed once after a
    warm-up call on a batch of its own (the first moved by 0.01 * N(0, 1),
    so no timed batch re-reads what the warm-up fetched);
    utils/profiling.call_seconds: CUDA events where fn returns card
    tensors, else the host clock."""
    first = batches[0]
    warm = first + 0.01 * torch.randn(
        first.shape, generator=generator(first.device, 0, WARMUP),
        device=first.device)
    it = itertools.chain([warm], batches)
    ts = profiling.call_seconds(lambda: fn(next(it)), iters=len(batches),
                                warmup=1)
    return float(np.mean(ts))


def to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
