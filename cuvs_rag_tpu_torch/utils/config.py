"""Typed configuration dataclasses.

TPU-native re-design of the reference's config surface: `SearchConfig`
(improved_multi_gpu_rag.py:37-48), `IndexBuildConfig`
(index_building_coordinator.py:55-75), `GPUConfig`/`MultiGPUConfig`
(gpu_resource_manager.py:21-36).  The reference used plain dataclasses and no CLI;
we keep typed dataclasses but make every numeric knob static-shape-friendly so the
whole search path stays inside one jitted program.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


class Metric:
    """Distance metrics. SQEUCLIDEAN matches cuVS/FAISS L2 conventions
    (both return *squared* euclidean distances, ascending = better).
    INNER_PRODUCT and COSINE are descending = better."""

    SQEUCLIDEAN = "sqeuclidean"
    INNER_PRODUCT = "inner_product"
    COSINE = "cosine"

    ALL = (SQEUCLIDEAN, INNER_PRODUCT, COSINE)

    @staticmethod
    def validate(metric: str) -> str:
        if metric not in Metric.ALL:
            raise ValueError(f"unknown metric {metric!r}; expected one of {Metric.ALL}")
        return metric


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Global search configuration.

    Mirrors the reference's `SearchConfig` (improved_multi_gpu_rag.py:37-48):
    top_k=2000 default, batch_size=100, recall@K sweep list — plus the TPU knobs
    (over_fetch for approximate indexes, tile sizes are per-index).
    """

    top_k: int = 2000
    batch_size: int = 100
    recall_ks: Sequence[int] = (1, 5, 10, 50, 100, 500, 1000, 2000)
    # Per-shard over-fetch multiplier under sharding. The reference fetches
    # k*2 per shard (improved_multi_gpu_rag.py:247), but over-fetch provably
    # cannot change the merged result for ANY family — a candidate outside a
    # shard's local top-k has >= k better rows in that shard alone, hence
    # globally (parallel/search.search_sharded; measured identical ids at 2M,
    # PERF.md sharded-quality section) — so the default is 1.0.
    over_fetch: float = 1.0
    metric: str = Metric.SQEUCLIDEAN

    def __post_init__(self):
        if self.top_k <= 0:
            raise ValueError(f"top_k must be positive, got {self.top_k}")
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.over_fetch < 1.0:
            raise ValueError(f"over_fetch must be >= 1, got {self.over_fetch}")
        Metric.validate(self.metric)


@dataclasses.dataclass(frozen=True)
class FlatParams:
    """Brute-force exact index parameters (FAISS IndexFlatL2 equivalent)."""

    metric: str = Metric.SQEUCLIDEAN
    # Corpus tile size for the streaming distance+top-k kernel. Rows per tile;
    # must be a multiple of 8 (fp32 sublane). 2048 rows x 768 dims fp32 = 6 MB
    # per tile block — fits VMEM with double buffering.
    tile_n: int = 2048
    # Query tile: queries processed per kernel program.
    tile_q: int = 256
    # "auto" = store in the dataset's own dtype (cuVS parity): fp32 input
    # stays exact, bf16 input takes the halved-DMA path.
    dtype: str = "auto"  # auto | float32 | bfloat16 | int8

    def __post_init__(self):
        Metric.validate(self.metric)
        if self.tile_n % 8 != 0:
            raise ValueError(f"tile_n must be a multiple of 8, got {self.tile_n}")


@dataclasses.dataclass(frozen=True)
class FlatSearchParams:
    """Optional knobs for exact search. `approx=True` uses the TPU's
    PartialReduce top-k (jax.lax.approx_max_k) per tile — the
    hardware-native ANN selection op — trading exactness (recall_target)
    for throughput. approx=False (default) is the exact oracle."""

    approx: bool = False
    recall_target: float = 0.95


@dataclasses.dataclass(frozen=True)
class IVFFlatParams:
    """IVF-Flat parameters.

    Mirrors cuVS `ivf_flat.IndexParams(n_lists=...)` +
    `SearchParams(n_probes=...)` as used at index_building_coordinator.py:392-396
    and improved_multi_gpu_rag.py:126-130 (n_lists ≈ N/1000 heuristic).
    """

    n_lists: int = 0  # 0 → auto: max(1, N // 1000), reference heuristic
    metric: str = Metric.SQEUCLIDEAN
    kmeans_iters: int = 10
    kmeans_sample: int = 200_000  # train k-means on at most this many rows
    # "auto" = store in the dataset's own dtype (cuVS store-as-given
    # parity): fp32 corpora stay exact under full probe; bf16 corpora halve
    # probe-window DMA bytes AND stay inside the Pallas DMA-scan kernel's
    # VMEM budget (fp32 windows at 2048 x 768 fall back to the XLA scan —
    # 0.33 vs 0.08 ms/query measured at 2M). "int8" is residual SQ8.
    dtype: str = "auto"
    # Capacity-bounded assignment: lists are capped at balance_factor x the
    # mean size; overflow rows spill to their next-nearest list. Bounds the
    # probe-window gather (skewed lists measured 10x mean on clustered data,
    # a ~10x search slowdown). 0 disables.
    balance_factor: float = 2.0

    def __post_init__(self):
        Metric.validate(self.metric)


@dataclasses.dataclass(frozen=True)
class IVFFlatSearchParams:
    n_probes: int = 20


@dataclasses.dataclass(frozen=True)
class IVFPQParams:
    """IVF-PQ parameters.

    Mirrors cuVS `ivf_pq.IndexParams(n_lists, pq_dim, pq_bits)` as used at
    index_building_coordinator.py:398-404 and
    VectorSearch_QuestionRetrieval.ipynb#cell6 (n_lists=150, pq_dim=96, 8-bit).
    """

    n_lists: int = 0  # 0 → auto: max(1, N // 500), reference heuristic
    pq_dim: int = 0  # number of subquantizers; 0 → auto: D // 8
    # codebook size = 2**pq_bits. 4 is the TPU fast path ("fastscan"):
    # nibble-packed codes + gather-free select-sum ADC, ~140x faster than
    # 8-bit at 2M x 768 (see PERF.md); pair with refine_ratio 64-100
    # (recall@10 0.98-0.99 at 2M, +0.08 ms/query over refine=16).
    # 8 matches the reference's default and has better ADC-only recall.
    pq_bits: int = 8
    metric: str = Metric.SQEUCLIDEAN
    kmeans_iters: int = 10
    pq_kmeans_iters: int = 10
    kmeans_sample: int = 200_000
    # Codebook-training sample cap: (sample, ds=8) subspace arrays pad 16x
    # under TPU (8,128) tiling and training runs m-way vmapped, so memory is
    # ~16 * 4 * m * sample * ds bytes; 50k rows is plenty for 256-entry
    # codebooks.
    pq_train_sample: int = 50_000
    # Looser than IVF-Flat's 2.0: spilled rows encode residuals against a
    # farther centroid, so PQ trades a bit more window size for quantization
    # quality (measured refine-recall 0.95 -> 0.9375 at factor 2.0 on
    # cluster-mismatched data).
    balance_factor: float = 2.5
    # Keep the raw vectors alongside the codes for exact refine re-ranking.
    # Costs a full-corpus copy in HBM; disable for max capacity (refine then
    # silently turns off).
    store_raw: bool = True
    # OPQ: learn an orthogonal rotation before quantization (Ge et al.) —
    # reduces ADC error substantially on correlated dims, at the cost of one
    # (D, D) matmul per (query, probe) at search time.
    opq: bool = False
    opq_iters: int = 3
    # pq_bits=8 realization. True (default): two-level additive nibble PQ —
    # each subspace residual is CB1[c1] + CB2[c2] (16+16 entries, exact
    # scoring via a stored per-row cross term), so the ADC scan is the
    # 4-bit fastscan select-sum (32 passes) at identical code memory
    # (m bytes/vector). False: flat 256-entry codebooks scored by a 256-pass
    # select-sum — ADC-optimal but ~50x slower on the gather-less VPU
    # (29.6 ms/query at 2M x 768, PERF.md round 1).
    two_level: bool = True

    def __post_init__(self):
        Metric.validate(self.metric)
        if self.pq_bits not in (4, 8):
            raise ValueError(f"pq_bits must be 4 or 8, got {self.pq_bits}")


@dataclasses.dataclass(frozen=True)
class IVFPQSearchParams:
    n_probes: int = 20
    # Exact re-rank: fetch refine_ratio*k ADC candidates, recompute exact
    # distances against the raw corpus, return true top-k. 0 disables
    # (and then no raw corpus copy is needed at search time).
    refine_ratio: int = 2


@dataclasses.dataclass(frozen=True)
class CagraParams:
    """CAGRA-style graph index parameters.

    Mirrors cuVS `cagra.IndexParams(intermediate_graph_degree=128,
    graph_degree=64)` as used at index_building_coordinator.py:406-414.
    """

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    metric: str = Metric.SQEUCLIDEAN
    # vector storage: "auto" = the dataset's own dtype; bf16 halves HBM
    # for the beam gathers (scores still accumulate fp32)
    dtype: str = "auto"
    # Graph construction: 'exact' brute-force kNN graph (O(N^2 D), best
    # quality, fine to ~10^5 rows/shard on MXU), 'ivf' IVF-bootstrapped
    # approximate graph (~1% of exact cost), 'auto' switches on size.
    build_algo: str = "auto"
    # IVF bootstrap knobs (used when the ivf path is taken): each list's
    # rows take their graph neighborhood from the union of the list and its
    # build_nprobes-1 nearest sibling lists (list-centric build — see
    # ops/graph.build_knn_graph_ivf). Cost scales linearly in build_nprobes.
    build_nlists: int = 0  # 0 -> N/1000 heuristic
    build_nprobes: int = 4
    # Forward edges kept out of graph_degree; the rest are reverse-edge
    # slots (0 -> graph_degree/2, the cuVS split). Swept on a 50k uniform
    # corpus: flat within noise, so this is a corpus-specific tuning knob.
    forward_edges: int = 0

    def __post_init__(self):
        Metric.validate(self.metric)
        if self.build_algo not in ("auto", "exact", "ivf"):
            raise ValueError(f"unknown build_algo {self.build_algo!r}")
        if self.forward_edges < 0 or self.forward_edges > self.graph_degree:
            raise ValueError(
                "forward_edges must be in [0, graph_degree]; got "
                f"{self.forward_edges}"
            )


@dataclasses.dataclass(frozen=True)
class CagraSearchParams:
    itopk_size: int = 64  # beam width
    max_iterations: int = 0  # 0 → auto from itopk_size
    # Entry points bound worst-case recall on weakly-connected graphs
    # (a cluster no entry point lands in is unreachable by greedy descent),
    # so the default is generous; scoring entries is one cheap batched matmul.
    num_entry_points: int = 128
    # Candidates expanded per iteration (cuVS search_width equivalent).
    # The auto iteration count is 2*ceil(itopk/search_width) (floor 8), so
    # total expanded candidates stay ~2*itopk while wider expansion batches
    # the neighbor gathers into fewer sequential sort/top_k rounds. Measured
    # strictly dominant at 16 on 2M x 768 (scripts/bench_cagra_sw.py):
    # itopk=64 0.365->0.355 ms/q with recall 0.956->0.964, itopk=128
    # 0.96->0.75 ms/q at equal recall 0.982.
    search_width: int = 16


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Placement policy over the device mesh.

    Replaces the reference's `MultiGPUConfig.distribution_strategy`
    (gpu_resource_manager.py:31-36) and the FAISS shard-vs-replicate switch
    (faiss-main.ipynb#cell8,#cell11).
    """

    mode: str = "shard"  # "shard" (corpus split across devices) | "replicate"
    axis_name: str = "shard"

    def __post_init__(self):
        if self.mode not in ("shard", "replicate"):
            raise ValueError(f"mode must be 'shard' or 'replicate', got {self.mode!r}")
