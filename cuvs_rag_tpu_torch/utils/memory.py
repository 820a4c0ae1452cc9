"""Device-memory budgeting and shard-size planning.

The counterpart of the JAX package's `utils/memory.py`: fit checks before
building, shard and chunk size calculators, and live memory accounting.
The arithmetic (`DeviceBudget`, `index_bytes_estimate`,
`max_rows_per_device`, `plan_shards`) is the JAX package's unchanged, so
both packages plan the same layout for the same budget. The budget and the
live numbers come from the CUDA caching allocator and
`torch.cuda.mem_get_info`.

Reference parity (SURVEY.md §2 #5, #9):
  * `GPUConfig.can_allocate` (improved_multi_gpu_rag.py:69-72) -> `fits`
  * `get_max_vectors_per_chunk` (MEMORY_OPTIMIZED#cell5) -> `max_rows_per_device`
  * `CUDAMemoryManager.managed_allocation` OOM context
    (improved_multi_gpu_rag.py:74-97) -> `managed_allocation` (catches
    torch.cuda.OutOfMemoryError, empties the allocator's cache, re-raises
    as MemoryError with context)
  * `get_memory_stats` / `print_memory_status` (:359-396) -> `memory_stats`
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import logging
from typing import Dict, Optional

import torch

logger = logging.getLogger("cuvs_rag_tpu_torch.memory")

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1}


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """Per-device memory budget (reference GPUConfig:50-72: 40 GB limit,
    2 GB reserve)."""

    limit_bytes: int
    reserve_bytes: int = 2 << 30

    @property
    def usable_bytes(self) -> int:
        return max(self.limit_bytes - self.reserve_bytes, 0)

    def fits(self, nbytes: int, in_use: int = 0) -> bool:
        """GPUConfig.can_allocate equivalent."""
        return in_use + nbytes <= self.usable_bytes


def detect_budget(device=None, cpu_limit: int = 16 << 30) -> DeviceBudget:
    """The budget of one device: a card's total memory from
    torch.cuda.mem_get_info (the card when `device` is None; without one
    that call raises). A CPU device reports no memory of its own, so the
    CPU's budget is `cpu_limit`, stated by the caller."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        return DeviceBudget(limit_bytes=int(total))
    return DeviceBudget(limit_bytes=cpu_limit)


def index_bytes_estimate(
    n: int,
    dim: int,
    family: str = "flat",
    dtype: str = "float32",
    pq_dim: int = 0,
    graph_degree: int = 64,
    store_raw: bool = True,
    pq_bits: int = 8,
) -> int:
    """Estimated device footprint of one index over n rows.

    flat: vectors + sqnorms. ivf_flat: + centroids/offsets (~same as flat;
    int8 adds a per-row dequant scale). ivf_pq: codes + per-row sidecars +
    codebooks, plus the raw refine store when store_raw (dtype = raw store
    dtype). cagra: vectors + graph.
    """
    b = _DTYPE_BYTES[dtype]
    if family in ("flat", "ivf_flat"):
        side = n * 8 if dtype == "int8" else n * 4  # sqnorms (+ scales)
        return n * dim * b + side
    if family == "ivf_pq":
        m = pq_dim or max(1, dim // 8)
        code_b = m if pq_bits == 8 else -(-m // 2)  # two-level 8b = m bytes
        est = n * code_b + n * 8 + 2 * 256 * dim * 4  # codes+sidecars+CBs
        if store_raw:
            est += n * dim * b + n * 4
        return est
    if family == "cagra":
        # score-augmented [v, hi, lo] rows rounded up to 128 columns
        # (ops/graph.augment_rows): 512 wide at 384-d, 896 at 768-d
        width = -(-(dim + 2) // 128) * 128
        return n * width * b + n * graph_degree * 4 + n * 4
    raise ValueError(f"unknown family {family!r}")


def max_rows_per_device(
    dim: int,
    budget: Optional[DeviceBudget] = None,
    family: str = "flat",
    dtype: str = "bfloat16",
    pq_dim: int = 0,
    working_factor: float = 1.5,
) -> int:
    """Largest shard that fits one device (the reference's
    get_max_vectors_per_chunk policy, MEMORY_OPTIMIZED#cell5), with
    `working_factor` headroom for build-time temporaries (sort buffers etc.)."""
    budget = budget or detect_budget()
    per_row = index_bytes_estimate(1_000_000, dim, family, dtype, pq_dim) / 1_000_000
    return int(budget.usable_bytes / (per_row * working_factor))


def plan_shards(
    n: int,
    dim: int,
    num_devices: int,
    budget: Optional[DeviceBudget] = None,
    family: str = "flat",
    dtype: str = "bfloat16",
    pq_dim: int = 0,
) -> Dict[str, object]:
    """Fit check + plan for sharding n rows over the mesh.

    Returns {'fits': bool, 'rows_per_device', 'max_rows_per_device',
    'est_bytes_per_device', 'suggestion'} — the decision the reference's
    stress notebooks made by trial-and-OOM (breaking-point protocol)."""
    budget = budget or detect_budget()
    per = -(-n // num_devices)
    cap = max_rows_per_device(dim, budget, family, dtype, pq_dim)
    est = index_bytes_estimate(per, dim, family, dtype, pq_dim)
    fits = per <= cap
    suggestion = ""
    if not fits:
        need = -(-n // cap)
        suggestion = (
            f"need >= {need} devices at this dtype, or switch to "
            f"{'ivf_pq' if family != 'ivf_pq' else 'smaller pq_dim'}"
        )
    return {
        "fits": fits,
        "rows_per_device": per,
        "max_rows_per_device": cap,
        "est_bytes_per_device": est,
        "suggestion": suggestion,
    }


@contextlib.contextmanager
def managed_allocation(operation: str = "operation"):
    """OOM-aware context (reference CUDAMemoryManager.managed_allocation,
    improved_multi_gpu_rag.py:74-97): on torch.cuda.OutOfMemoryError it
    logs, returns the caching allocator's free blocks to the card, collects
    host garbage and raises MemoryError with context. Other errors pass
    through."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        logger.error("OOM during %s: %s", operation, e)
        torch.cuda.empty_cache()
        gc.collect()
        raise MemoryError(f"device OOM during {operation}: {e}") from e


def memory_stats() -> Dict[int, Dict[str, int]]:
    """Per-card live memory (reference get_memory_stats :359-384): the
    caching allocator's allocated and reserved bytes and its peak, and the
    card's free and total bytes, for each visible card ({} without one)."""
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[i] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "bytes_reserved": torch.cuda.memory_reserved(i),
            "bytes_free": int(free),
            "bytes_limit": int(total),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
        }
    return out


def log_memory_status(label: str = "") -> None:
    """print_memory_status equivalent (reference :386-396)."""
    for i, s in memory_stats().items():
        logger.info(
            "[%s] device %d: allocated=%.2f GB reserved=%.2f GB free=%.2f GB "
            "limit=%.2f GB peak=%.2f GB",
            label, i, s["bytes_in_use"] / 1e9, s["bytes_reserved"] / 1e9,
            s["bytes_free"] / 1e9, s["bytes_limit"] / 1e9,
            s["peak_bytes_in_use"] / 1e9,
        )
