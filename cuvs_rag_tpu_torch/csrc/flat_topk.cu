// Fused score tile + top-k selection for exact flat search on Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernel paths of cuvs_rag_tpu/ops/pallas_flat.py:
//   K1  flat_topk_pallas(mode="exact")   -> exact_scan_kernel (or exact_scan_cores_kernel)
//                                           + merge_partials_kernel
//   K2  flat_topk_pallas(mode="sketch")  -> sketch_ring_kernel (or sketch_scan_kernel)
//                                           + sketch_merge_kernel
//   K3  flat_topk_large                  -> topr_ring_kernel (or topr_scan_kernel)
//                                           + topr_merge_kernel (topk_common.cuh)
//
// The TPU walked the corpus axis in order and kept its running selection in
// VMEM from one grid step to the next. Hopper blocks run in parallel and in no
// order, so every kernel here is two passes: blocks over (query tile x corpus
// split) emit partial results, and a merge pass reduces them per query.
//
// What bounds them on the H100: at the main path's batch (16 queries) each
// corpus byte feeds only ~16 multiply-adds, so the floor is reading the
// corpus from HBM once (4.8 GB of bf16 at 6.29M x 384, 1.4 ms). The design
// keeps everything else off HBM: the pad and tombstone penalties ride the
// one epilogue FMA (no mask passes), the running selections stay in
// registers (K1/K2) or shared memory (K3), and partials are small.
//
// K1 has four routes, chosen by the wrapper from the storage type, the depth
// and the number of queries (ops/flat_kernels.exact_plan):
// - bf16 and int8 rows whose rows are a multiple of 32 bytes, at most 16
//   queries: exact_scan_kernel, the tensor-core route of 16-query tiles
//   (each tile reads the whole corpus; more queries take the wide route
//   below). Reading 4.88 GB in 1.6 ms needs 48 TFLOP/s of
//   multiply-adds, beyond CUDA cores fed from shared memory and 5% of the
//   tensor cores' bf16 rate, so the product is the easy part and feeding it
//   is the design:
//   * The product is mma.sync m16n8k16 (bf16 x bf16 -> fp32) with the 16
//     queries of the block's tile as M: the query tile is exactly one M, so
//     one-query calls cost what 16 cost and no accumulator row is wasted
//     above 16; wgmma's 64-row M would put corpus rows there and buys
//     nothing at 5% of the peak. Products of bf16 values are exact and the
//     sum stays fp32, so the scores are still exact scores up to the order
//     and rounding of fp32 adds (ops/flat_kernels.flat_rounding_bound).
//     int8 rows are widened to bf16 in registers (exact) after ldmatrix and
//     take the same product; their depth order inside a 16-step is permuted
//     the same way in the staged queries.
//   * The corpus comes by cp.async, 16 bytes a thread, into a ring of three
//     stages in dynamic shared memory; a stage is 128 rows x one depth
//     chunk of 128 bytes a row (one cache line; six chunks a tile at D = 384
//     bf16), two stages are always in flight and one __syncthreads() a
//     chunk is all the block waits on. Two blocks an SM (77 KB each at D =
//     384), one split a block: one block's products and selection run under
//     the other's copies. Measured on 6.29M x 384 bf16 rows, 16 queries
//     (NVIDIA H100 80GB HBM3, 700 W; eval/ring_sweep.py, which rebuilds
//     this file with other sizes; one streaming read of the corpus takes
//     1.55-1.57 ms on such a card): this ring 1.84-1.89 ms; chunks of 64 bytes
//     2.66, 96 bytes 2.19, 160 bytes 1.92, 192 bytes 1.90; four stages
//     1.91, two stages 2.03 (two stages of 256 bytes 1.77); one block an SM
//     with three stages of 384-byte chunks (100 KB an SM in flight) 2.13,
//     with four stages (150 KB) 2.29. More bytes in flight than ~70 KB an
//     SM cost time instead of hiding it, and chunks that are whole
//     128-byte lines beat every other width. With the products left out
//     this ring takes 1.80, with the selection left out 1.84, with both
//     1.77: the copies bound it.
//   * Rows sit at a pitch of chunk bytes + 16, an odd number of 16-byte
//     units, so the eight rows of every ldmatrix fall in eight different
//     bank groups (at a pitch of 128 or 768 bytes they would share one).
//   * Selection is unchanged: the 16 x 128 fp32 score tile goes through
//     shared memory once and is read back as (warp = query, lane = row) into
//     WarpTopK::offer in ascending row order; sqnorms and scales of a
//     tile's rows are plain loads started before the tile's products.
// - the same rows at more than 16 queries: exact_scan_wide_kernel. A tile of
//   16 queries streams the whole corpus through its own ring, so 100
//   queries read it 7 times (12.3 ms at 6.29M x 384 bf16 against the 1.45
//   ms bound). The wide kernel reads it once a pass of up to 128 queries:
//   each landed chunk feeds every query of the pass. At ~130 multiply-adds
//   a byte the product now needs ~0.5 ms of the tensor cores' bf16 rate,
//   and mma.sync would re-read every staged query for every chunk, so:
//   * The product is wgmma with corpus rows as M (the stage's two 64-row
//     blocks) and the pass's queries as N, staged once a block as 128-byte-
//     swizzled K-major panels. The query slots (a multiple of 16) are split
//     between two warpgroups: each multiplies all 128 rows of a tile for its
//     own N / 2 queries and selects for them alone, with named barriers of
//     its own 128 threads, so one warpgroup's selection runs under the
//     other's products (splitting the rows between them instead, where every
//     selection waits for both: 2.45-2.50 ms against 2.04-2.06 at 100
//     queries, each with the selection below in its first form).
//     bf16 rows are read by the tensor cores straight from the ring (both
//     operands in shared memory), one product group in flight across
//     chunks; int8 rows go through ldmatrix and are widened to bf16 in
//     registers, one 64-row block at a time (their depth order staged as
//     above). bf16 x bf16 products, fp32 sums: flat_rounding_bound holds.
//   * The ring is copied by TMA from a warp of its own: one box of 128 rows
//     x 128 bytes a stage (the 128-byte swizzle wgmma reads; zeros past
//     the corpus), five stages, mbarriers for landed and released stages; a
//     stage is released when the products that read it are done. Measured
//     (the row-split kernel, 100 queries): a cp.async ring copied by every
//     thread with a barrier a chunk 2.78 ms, TMA 2.65; copies alone 1.67
//     and 1.59 (one streaming read 1.55). Four stages 2.08, six 2.16, five
//     2.03 ms (the selection's first form).
//   * Selection computes what the 16-query kernel's does: a WarpTopK a
//     query, fed in ascending row order within a split. A 64-row block's
//     scores pass through shared memory as [query][row]; a query is flagged
//     where one of them beats its k-th best (kept in shared memory: what
//     does not beat it cannot enter), and only a flagged query is read back
//     (~6% of blocks over a split at 100 queries), as (warp = query, lane =
//     row) into its WarpTopK. Each query's top-k waits in shared memory
//     between its turns, so the warpgroup deals its flagged queries to its
//     four warps in turn and no warp waits for a busier one by more than a
//     query (each warp keeping its own queries' top-k in registers left the
//     warpgroup waiting on its busiest warp at every block: 2.04-2.06 ms
//     against 1.89-1.90 at 100 queries). It costs 0.19 ms of 1.89 at 100
//     queries (1.70 without it), most of it the inserts each split makes,
//     about k (1 + ln(rows / k)) a query.
//   * Shared memory decides the width: at 128 queries, k = 10 and D = 384,
//     96 KB of queries, 80 KB of ring, 36 KB of scores and flags and 10 KB
//     of top-k, one block an SM; the wrapper cuts the query axis into as
//     few passes as fit (at k = 10: 128 queries a pass at D <= 384, 64 at
//     768, 48 at 1,024, 32 at 2,048) and the corpus into one split an SM
//     over the passes.
//   Measured (NVIDIA H100 80GB HBM3, 700 W, 6.29M x 384 bf16, k = 10): 100
//   queries 1.89 ms (7 tiles of the 16-query kernel: 12.28), 128 queries
//   1.96-2.00, 25 queries 1.65 (two tiles: 2.87-2.95). The fp32 route and the
//   "cores" route below stay 16 queries wide: no deployment the benchmark
//   measures runs them.
// - fp32 rows of a multiple of 16 bytes: the same kernel and ring, but fp32
//   storage means fp32 math (no TF32, no bf16 split), so the product stays
//   on the CUDA cores: each thread keeps 2 queries x 4 rows in the
//   selection's own layout and reads queries and rows as float4 along the
//   depth (6 shared-memory loads per 32 FMAs, conflict-free at the ring's
//   pitch), adding in depth order. No score tile passes through shared
//   memory. It is bound by those FMAs and loads, not by the read.
// - every other depth: exact_scan_cores_kernel, which multiplies on the
//   CUDA cores in fp32 through score_tile (scalar loads, 6 shared-memory
//   loads per 8 FMAs, two barriers a 32-deep chunk) and is bound by that
//   inner loop, at about a sixth of the read floor. So do the "cores"
//   routes of K2 and K3.
//
// K2 (ops/flat_kernels.sketch_route) streams the same ring with its own row
// walk (a block's tiles are W rows apart) and its own selection (a running
// best per (query, class) in registers): bf16 and int8 rows on the tensor
// cores as K1's, int8 rows with int8 queries through mma.sync m16n8k32
// (exact int32 sums, so bit-equal to the plain version), fp32 rows with fp32
// FMAs; other depths keep sketch_scan_kernel on score_tile. The ring
// helpers live in ring.cuh, which ivf_scan.cu's K4 and K5 share.
//
// K3 (ops/flat_kernels.topr_plan) walks the ring exactly as K2 does
// (class_ring_walk is the one body of both) and differs only in what it
// keeps of each score: each (query, class) keeps its R best rows in planes
// in the block's shared memory behind the ring, plane R-1 and rej in
// registers, and runs the insertion chain only for a score above plane R-1
// (about R (1 + ln(T / R)) of a class's T tiles: 87 of 6,143 at R = 12), so
// the selection hides under the copies as K2's does. The planes decide the
// occupancy: one query's (9 KB at R = 12 with 16-bit tile numbers as ids)
// leave two blocks an SM, 16 queries' (144 KB) one, and the plan takes
// whichever reads the corpus fewer times. The splits' planes are merged by
// topr_merge_kernel, which ivf_scan.cu's K5 shares.
//
// Plain C ABI (built with nvcc, loaded with ctypes): every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "ring.cuh"
#include "topk_common.cuh"

namespace {

constexpr int DK = 32;            // depth chunk staged in shared memory
constexpr float PAD_PENALTY = 1e30f;

template <bool INT8C>
struct Stage {
  using T = typename std::conditional<INT8C, int, float>::type;
  T q[TQ][DK + 1];
  T x[TC][DK + 1];  // pitch DK + 1: lanes reading 32 consecutive rows hit 32 banks
};

// One (TQ x TC) tile of scores, larger is better:
//   mult * (q . x) * scale - csq                (float / int8 storage)
//   (mult * qscale) * ((q8 . x8) * scale) - csq (int8 x int8, INT8C)
// with csq = sqnorm + pad (sqeuclidean) or pad + deletion_penalty(sqnorm)
// (inner product), pad = 1e30 for rows >= n_valid. Rows at or past n_live
// (outside the tile's range) score -inf and are never selected.
// Thread (warp w, lane l) returns out[i][j] for query q0 + w + 8 i and row
// row0 + l + 32 j.
template <typename QT, typename XT, bool INT8C>
__device__ __forceinline__ void score_tile(
    Stage<INT8C>& st, const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const float* __restrict__ qscales, int n_q, int q0, int d, long long row0,
    int n_live, int n_valid, int metric_sq, float out[QPT][CPT]) {
  using T = typename Stage<INT8C>::T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T acc[QPT][CPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < d; k0 += DK) {
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < TQ * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, qq = q0 + r, dd = k0 + c;
      T v = T(0);
      if (qq < n_q && dd < d) {
        if constexpr (INT8C) v = (int)q[(long long)qq * d + dd];
        else v = load_f(q + (long long)qq * d + dd);
      }
      st.q[r][c] = v;
    }
    for (int e = tid; e < TC * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, dd = k0 + c;
      T v = T(0);
      if (r < n_live && dd < d) {
        const XT* p = x + (row0 + r) * (long long)d + dd;
        if constexpr (INT8C) v = (int)*p;
        else v = load_f(p);
      }
      st.x[r][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      T a[QPT], b[CPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) a[i] = st.q[warp + 8 * i][c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = st.x[lane + 32 * j][c];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] += a[i] * b[j];
    }
  }

  const float mult = metric_sq ? 2.0f : 1.0f;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int r = lane + 32 * j;
    const bool live = r < n_live;
    const long long row = row0 + r;
    float scale = 1.0f, csq = 0.0f;
    if (live) {
      scale = scales[row];
      const float s = sqn[row];
      const float pen = row < n_valid ? 0.0f : PAD_PENALTY;
      csq = metric_sq ? s + pen : pen + fmaxf(s - DELETED_THRESHOLD, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      float v;
      if constexpr (INT8C) {
        const int qq = q0 + warp + 8 * i;
        const float qs = qq < n_q ? qscales[qq] : 1.0f;
        // no contraction into an FMA: the plain version rounds each step
        v = __fsub_rn(__fmul_rn(mult * qs, __fmul_rn((float)acc[i][j], scale)), csq);
      } else {
        v = mult * (acc[i][j] * scale) - csq;
      }
      out[i][j] = live ? v : neg_inf();
    }
  }
}

// ---------------------------------------------------------------- K1 -----
// grid (ceil(n_q / TQ), n_splits); split s covers rows
// [s * rows_per_split, min(n_rows, (s + 1) * rows_per_split)). Warp w keeps
// the running top-k of queries w and w + 8 in registers. Partials:
// (n_q, S, k).
//
// The CUDA-core route: the score tile the warp selects from is already in
// its own registers.
template <typename QT, typename XT>
__global__ void __launch_bounds__(THREADS) exact_scan_cores_kernel(
    const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales, int n_q,
    int d, long long n_rows, int n_valid, int metric_sq, int k,
    long long rows_per_split, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  __shared__ Stage<false> st;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, n_splits = gridDim.y;
  const long long start = (long long)split * rows_per_split;
  const long long stop = min(n_rows, start + rows_per_split);
  WarpTopK top[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) top[i].init();

  for (long long row0 = start; row0 < stop; row0 += TC) {
    const int n_live = (int)min((long long)TC, stop - row0);
    float v[QPT][CPT];
    score_tile<QT, XT, false>(st, q, x, sqn, scales, nullptr, n_q, q0, d, row0,
                              n_live, n_valid, metric_sq, v);
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        top[i].offer(v[i][j], (int)(row0 + lane + 32 * j), k, lane);
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qq = q0 + warp + 8 * i;
    if (qq < n_q && lane < k) {
      const long long o = ((long long)qq * n_splits + split) * k + lane;
      part_s[o] = top[i].s;
      part_i[o] = top[i].id;
    }
  }
}

// The ring-fed routes (see the note at the top of the file).
constexpr int RING_STAGES = 3;
constexpr int RING_CHUNK = 128;  // a stage's bytes a row: one cache line
// MODE 0: bf16 rows; 1: int8 rows (widened to bf16 in registers), both with
// bf16 queries on the tensor cores: warp w multiplies the 16 queries with
// rows [16 w, 16 w + 16) of each tile (two 8-row mma tiles), then selects
// for queries w and w + 8 over the whole tile. MODE 2: fp32 rows and
// queries, fp32 multiply-adds on the CUDA cores (fp32 storage means fp32
// math): thread (warp w, lane l) keeps queries w, w + 8 x rows l + 32 j,
// the selection's own layout, reads queries and rows as float4 along the
// depth (6 shared-memory loads per 32 FMAs) and adds in depth order, as the
// CUDA-core kernel above does. `chunk_bytes` (a multiple of 32; of 16 in
// MODE 2) is a stage's bytes a row; the last chunk of a row may be shorter.
// No mode spills (the registers are in chip_smoke.py's `build` line).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) exact_scan_kernel(
    const void* __restrict__ q, const unsigned char* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales, int n_q,
    int d, long long n_rows, int n_valid, int metric_sq, int k,
    long long rows_per_split, int n_dc, int chunk_bytes,
    float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  constexpr bool INT8 = MODE == 1, FP32 = MODE == 2;
  constexpr int QS = FP32 ? 4 : 2;  // bytes of a staged query value
  const int row_bytes = FP32 ? 4 * d : INT8 ? d : 2 * d;
  const int pitch = chunk_bytes + 16;
  const int q_pitch = QS * d + 16;
  const int stage_bytes = TC * pitch;
  unsigned char* s_q = ring_smem;                                   // [TQ][q_pitch]
  float* s_sc = reinterpret_cast<float*>(s_q + TQ * q_pitch);       // [TQ][SCORE_PITCH]
  // [STAGES][TC][pitch]; MODE 2 has no score tile in front of it
  unsigned char* s_ring = reinterpret_cast<unsigned char*>(s_sc + (FP32 ? 0 : TQ * SCORE_PITCH));
  const uint32_t q_a = smem_u32(s_q);
  const uint32_t ring_a = smem_u32(s_ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, n_splits = gridDim.y;
  const long long start = (long long)split * rows_per_split;
  const long long stop = min(n_rows, start + rows_per_split);
  const int n_tiles = (int)((stop - start + TC - 1) / TC);
  const int n_chunks = n_tiles * n_dc;

  RingLoader loader;
  loader.init(chunk_bytes);
  int ld_tile = 0, ld_dc = 0;  // the next chunk to load
  auto load_next = [&](int chunk) {
    if (chunk < n_chunks) {
      const long long first = start + (long long)ld_tile * TC;
      const int byte0 = ld_dc * chunk_bytes;
      loader.load(ring_a + (chunk % RING_STAGES) * stage_bytes, pitch, x, row_bytes,
                  first, (int)min((long long)TC, stop - first), byte0,
                  min(chunk_bytes, row_bytes - byte0));
      if (++ld_dc == n_dc) {
        ld_dc = 0;
        ++ld_tile;
      }
    }
    // one commit group a call, also where no chunk is left: the waits count groups
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int c = 0; c < RING_STAGES - 1; ++c) load_next(c);

  // the query tile, once a block: zeros past n_q. With int8 rows a thread's
  // ldmatrix register holds depths 4t .. 4t + 3 of a 16-step (t = lane % 4)
  // where the mma wants 2t, 2t + 1, 8 + 2t, 9 + 2t: the queries are staged in
  // that order instead, and a dot product does not mind.
  for (int e = tid; e < TQ * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const bool live = q0 + r < n_q;
    const long long src = (long long)(q0 + r) * d + c;
    if constexpr (FP32) {
      reinterpret_cast<float*>(s_q + r * q_pitch)[c] =
          live ? static_cast<const float*>(q)[src] : 0.f;
    } else {
      int col = c;
      if (INT8) {
        const int t = (c & 15) >> 2, j = c & 3;
        col = (c & ~15) | (j < 2 ? 2 * t + j : 8 + 2 * t + (j - 2));
      }
      reinterpret_cast<__nv_bfloat16*>(s_q + r * q_pitch)[col] =
          live ? static_cast<const __nv_bfloat16*>(q)[src] : __float2bfloat16(0.f);
    }
  }

  // ldmatrix addresses: A's four 8 x 8 blocks are (queries 0-7 | 8-15) x
  // (depth 0-7 | 8-15) of a 16-step; B's are (rows 0-7 | 8-15 of the warp's
  // 16) x (bytes 0-15 | 16-31) of a 32-byte unit.
  const int mat = lane >> 3;
  const uint32_t a_lane = q_a + ((lane & 7) + (mat & 1) * 8) * q_pitch + (mat >> 1) * 16;
  const uint32_t b_lane =
      (warp * 16 + (lane & 7) + (mat >> 1) * 8) * pitch + (mat & 1) * 16;

  WarpTopK top[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) top[i].init();
  const float mult = metric_sq ? 2.0f : 1.0f;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float scale[CPT], csq[CPT];
  int tile = 0, dc = 0;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    asm volatile("cp.async.wait_group %0;" ::"n"(RING_STAGES - 2) : "memory");
    __syncthreads();  // the chunk has landed; every warp is done with the one before
    load_next(chunk + RING_STAGES - 1);

    const long long row0 = start + (long long)tile * TC;
    const int n_live = (int)min((long long)TC, stop - row0);
    if (dc == 0) {
      // this thread's rows of the selection (lane + 32 j): loaded before the
      // products, used after them
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = lane + 32 * j;
        scale[j] = 1.0f;
        csq[j] = 0.0f;
        if (r < n_live) {
          const long long row = row0 + r;
          scale[j] = scales[row];
          const float s = sqn[row];
          const float pen = row < n_valid ? 0.0f : PAD_PENALTY;
          csq[j] = metric_sq ? s + pen : pen + fmaxf(s - DELETED_THRESHOLD, 0.0f);
        }
      }
    }

    const int byte0 = dc * chunk_bytes;
    const int width = min(chunk_bytes, row_bytes - byte0);
    if constexpr (FP32) {
      const unsigned char* rows = s_ring + (chunk % RING_STAGES) * stage_bytes + lane * pitch;
      const unsigned char* qs = s_q + warp * q_pitch + byte0;
#pragma unroll 2
      for (int u = 0; u < width; u += 16) {
        float4 a[QPT], b[CPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + 8 * i * q_pitch + u);
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          b[j] = *reinterpret_cast<const float4*>(rows + 32 * j * pitch + u);
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
    } else {
      const int units = width >> 5;
      const uint32_t b_addr = ring_a + (chunk % RING_STAGES) * stage_bytes + b_lane;
      // the chunk's first value in the staged queries (2 bytes a value)
      const uint32_t a_addr = a_lane + (INT8 ? 2 * byte0 : byte0);
#pragma unroll 4
      for (int u = 0; u < units; ++u) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr + u * 32);
        if (INT8) {
          uint32_t a0[4], a1[4], lo, hi;
          ldmatrix_x4(a0, a_addr + u * 64);
          ldmatrix_x4(a1, a_addr + u * 64 + 32);
          widen_int8(b[0], lo, hi);
          mma_16x8x16(acc[0], a0, lo, hi);
          widen_int8(b[2], lo, hi);
          mma_16x8x16(acc[1], a0, lo, hi);
          widen_int8(b[1], lo, hi);
          mma_16x8x16(acc[0], a1, lo, hi);
          widen_int8(b[3], lo, hi);
          mma_16x8x16(acc[1], a1, lo, hi);
        } else {
          uint32_t a[4];
          ldmatrix_x4(a, a_addr + u * 32);
          mma_16x8x16(acc[0], a, b[0], b[1]);
          mma_16x8x16(acc[1], a, b[2], b[3]);
        }
      }
    }
    if (++dc < n_dc) continue;
    dc = 0;
    ++tile;

    if constexpr (!FP32) {
      // the tile's scores: fragments (query lane / 4 (+ 8), rows 2 (lane % 4),
      // + 1 of each 8) -> shared memory -> (warp = query, lane = row); the
      // next tile's are written after its chunks' barriers
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* dst = s_sc + (lane >> 2) * SCORE_PITCH + warp * 16 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + 8 * SCORE_PITCH) = make_float2(acc[nt][2], acc[nt][3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const bool dead = q0 + warp + 8 * i >= n_q;  // the same for the whole warp
      if constexpr (!FP32) {
        if (dead) continue;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = lane + 32 * j;
        float dot;
        if constexpr (FP32) {
          dot = acc[i][j];
          acc[i][j] = 0.f;
          if (dead) continue;
        } else {
          dot = s_sc[(warp + 8 * i) * SCORE_PITCH + r];
        }
        const float v = mult * (dot * scale[j]) - csq[j];
        top[i].offer(r < n_live ? v : neg_inf(), (int)(row0 + r), k, lane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qq = q0 + warp + 8 * i;
    if (qq < n_q && lane < k) {
      const long long o = ((long long)qq * n_splits + split) * k + lane;
      part_s[o] = top[i].s;
      part_i[o] = top[i].id;
    }
  }
}

// ------------------------------------------------------------ K1, wide ---
// exact_scan_wide_kernel: K1 for calls of more than 16 queries, bf16 rows
// or int8 rows widened to bf16 (the note at the top of the file says why).
// grid (passes, n_splits): block (p, s) takes queries [p * width, min(n_q,
// (p + 1) * width)) over the rows of split s, as exact_scan_kernel does.
// Partials: (n_q, S, k), for merge_partials_kernel.
constexpr int WIDE_CONSUMERS = 256;   // two warpgroups of products and selection
constexpr int WIDE_THREADS = WIDE_CONSUMERS + 32;  // and a warp that copies
constexpr int WIDE_ROWS = 128;        // corpus rows a tile: two wgmma M of 64
constexpr int WIDE_STAGES = 5;
constexpr int WIDE_CHUNK = 128;       // a stage's bytes a row: one 128-byte swizzle row
constexpr int WIDE_STAGE_BYTES = WIDE_ROWS * WIDE_CHUNK;
constexpr int WIDE_MAX_N = 128;       // query slots a pass: N / 2 accumulators a thread
constexpr int WIDE_SCORE_PITCH = 68;  // [query][64 rows]: the fragments' stores hit 32 banks
constexpr int WIDE_ALIGN = 1024;      // the swizzle lives in the address bits

// Dynamic shared memory of the wide kernel at n query slots (a multiple of
// 16), `panels` query panels of 64 values and k: the alignment slack, the
// staged queries, the ring, the half-tile of scores, a threshold and a
// flag a query for each 64-row block, the ring's two barriers a stage,
// and each query's top-k.
__host__ __device__ inline int wide_smem_bytes(int n, int panels, int k) {
  return WIDE_ALIGN + panels * n * 128 + WIDE_STAGES * WIDE_STAGE_BYTES +
         n * (WIDE_SCORE_PITCH + 3) * 4 + WIDE_STAGES * 2 * 8 + n * k * 8;
}

// A K-major wgmma operand in 128-byte-swizzled panels: rows of 128 bytes,
// 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t wide_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 rows x N queries, fp32) = or += a (64 x 16 bf16, registers) .
// b (16 x N bf16, shared, K-major), for N = 8, 16, .., 64: a warpgroup's
// queries. The operands that do not depend on N come first, so the
// accumulators are %6 onwards.
template <int N>
__device__ __forceinline__ void wgmma_wide(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int accumulate);

#define WIDE_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WIDE_REGS1 "%6, %7, %8, %9"
#define WIDE_REGS2 WIDE_REGS1 ", %10, %11, %12, %13"
#define WIDE_REGS3 WIDE_REGS2 ", %14, %15, %16, %17"
#define WIDE_REGS4 WIDE_REGS3 ", %18, %19, %20, %21"
#define WIDE_REGS5 WIDE_REGS4 ", %22, %23, %24, %25"
#define WIDE_REGS6 WIDE_REGS5 ", %26, %27, %28, %29"
#define WIDE_REGS7 WIDE_REGS6 ", %30, %31, %32, %33"
#define WIDE_REGS8 WIDE_REGS7 ", %34, %35, %36, %37"
#define WIDE_OUTS1 WIDE_D4(0)
#define WIDE_OUTS2 WIDE_OUTS1, WIDE_D4(4)
#define WIDE_OUTS3 WIDE_OUTS2, WIDE_D4(8)
#define WIDE_OUTS4 WIDE_OUTS3, WIDE_D4(12)
#define WIDE_OUTS5 WIDE_OUTS4, WIDE_D4(16)
#define WIDE_OUTS6 WIDE_OUTS5, WIDE_D4(20)
#define WIDE_OUTS7 WIDE_OUTS6, WIDE_D4(24)
#define WIDE_OUTS8 WIDE_OUTS7, WIDE_D4(28)
// M = N / 8 groups of four accumulators
#define WIDE_MMA(M, N)                                                        \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_wide<N>(                              \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) { \
    uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];                      \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "           \
        "{" WIDE_REGS##M "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"           \
        : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(db), "+r"(accumulate), \
          WIDE_OUTS##M);                                                      \
  }
WIDE_MMA(1, 8)
WIDE_MMA(2, 16)
WIDE_MMA(3, 24)
WIDE_MMA(4, 32)
WIDE_MMA(5, 40)
WIDE_MMA(6, 48)
WIDE_MMA(7, 56)
WIDE_MMA(8, 64)
#undef WIDE_MMA

// d (64 x N) = or += a (64 x 16 bf16, shared, K-major) . b (as above): the
// same operand numbers as wgmma_wide, %1 - %3 unused.
template <int N>
__device__ __forceinline__ void wgmma_wide_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int accumulate);
#define WIDE_MMA_SS(M, N)                                                     \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_wide_ss<N>(                           \
      float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {          \
    uint32_t u1 = 0, u2 = 0, u3 = 0;                                          \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "           \
        "{" WIDE_REGS##M "}, %0, %4, p, 1, 1, 0, 0;\n}\n"                      \
        : "+l"(da), "+r"(u1), "+r"(u2), "+r"(u3), "+l"(db), "+r"(accumulate), \
          WIDE_OUTS##M);                                                      \
  }
WIDE_MMA_SS(1, 8)
WIDE_MMA_SS(2, 16)
WIDE_MMA_SS(3, 24)
WIDE_MMA_SS(4, 32)
WIDE_MMA_SS(5, 40)
WIDE_MMA_SS(6, 48)
WIDE_MMA_SS(7, 56)
WIDE_MMA_SS(8, 64)
#undef WIDE_MMA_SS

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N of this warpgroup's committed product groups run
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// The compiler may not move a use of these registers across this point: an
// asynchronous wgmma reads or writes them from its start to its wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int S>
__device__ __forceinline__ void keep(uint32_t (&r)[S][4]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The ring's barriers (mbarrier objects in shared memory) and its copies.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// arrives and expects `bytes` more of copies before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// One TMA copy of the box at (column c0, row c1) of `map` into shared memory
// at `dst`; its bytes complete a phase of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// A named barrier of one warpgroup's 128 threads (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
// An arrival on `bar` by lane 0 of the warp alone, without a branch (a
// branch between products and their wait makes ptxas serialize them).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(bar), "r"(lane) : "memory");
}

// MODE 0: bf16 rows, multiplied from the ring in shared memory; 1: int8
// rows, widened to bf16 in registers. `rows`: the corpus as a 2-D tensor of
// bytes (row_bytes x n_rows) whose box is one stage, 128-byte swizzled. N:
// the pass's query slots, a multiple of 16: warpgroup w takes slots
// [w N / 2, (w + 1) N / 2) over all 128 rows of each tile, as two 64-row
// products of N / 2 queries; `width` <= N queries a pass; `panels` query
// panels of 64 values (every chunk's depth, zeros past d); `n_dc` chunks a
// row.
template <int MODE, int N>
__global__ void __launch_bounds__(WIDE_THREADS, 1) exact_scan_wide_kernel(
    const __grid_constant__ CUtensorMap rows, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ sqn, const float* __restrict__ scales, int n_q,
    int d, long long n_rows, int n_valid, int metric_sq, int k, int width,
    long long rows_per_split, int n_dc, int panels,
    float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char wide_smem[];
  constexpr bool INT8 = MODE == 1;
  constexpr int KSTEPS = INT8 ? 8 : 4;  // 16-deep steps a chunk
  constexpr int NH = N / 2;             // a warpgroup's queries: its products' N
  unsigned char* base =
      wide_smem + ((WIDE_ALIGN - (smem_u32(wide_smem) & (WIDE_ALIGN - 1))) & (WIDE_ALIGN - 1));
  unsigned char* s_q = base;                               // [panels][N][128]
  unsigned char* s_ring = s_q + panels * N * 128;          // [STAGES][ROWS][128]
  float* s_sc = reinterpret_cast<float*>(s_ring + WIDE_STAGES * WIDE_STAGE_BYTES);
  float* s_thr = s_sc + N * WIDE_SCORE_PITCH;              // [N]: each query's k-th best
  // [2][N]: a score above it, by 64-row block (one block's flags are
  // cleared while the other's are set)
  int* s_flag = reinterpret_cast<int*>(s_thr + N);
  const uint32_t q_a = smem_u32(s_q), ring_a = smem_u32(s_ring);
  const uint32_t full_a = smem_u32(s_flag + 2 * N);        // [STAGES] mbarriers
  const uint32_t empty_a = full_a + 8 * WIDE_STAGES;       // [STAGES] mbarriers
  // [N][k] each query's top-k between its turns in the selection
  float* s_top = reinterpret_cast<float*>(s_flag + 2 * N + 4 * WIDE_STAGES);
  int* s_top_id = reinterpret_cast<int*>(s_top + N * k);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's number by a broadcast: what is decided from it is then the
  // same in every lane, and wgmma runs unfenced
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  const int wg = warp >> 2, wq = warp & 3;
  const int q0 = blockIdx.x * width, split = blockIdx.y, n_splits = gridDim.y;
  const int nq = min(width, n_q - q0);  // this block's queries
  const long long start = (long long)split * rows_per_split;
  const long long stop = min(n_rows, start + rows_per_split);
  const int n_tiles = (int)((stop - start + WIDE_ROWS - 1) / WIDE_ROWS);
  const int n_chunks = n_tiles * n_dc;

  // The ring: the last warp copies chunk after chunk by TMA, a stage a box
  // of 128 rows x 128 bytes (piece c of row r lands at c ^ (r % 8): the
  // 128-byte swizzle; zeros past the corpus). full[s] completes when a
  // stage's bytes have landed, empty[s] when the 8 product warps are done
  // with it.
  if (tid == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, WIDE_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < N; i += WIDE_THREADS) {
    s_thr[i] = neg_inf();
    s_flag[i] = s_flag[N + i] = 0;
  }
  for (int i = tid; i < N * k; i += WIDE_THREADS) {
    s_top[i] = neg_inf();
    s_top_id[i] = -1;
  }

  // The pass's queries, once a block, as bf16 panels of 64 values (one
  // 128-byte row a query, 16-byte pieces XORed with query % 8): zeros past
  // d and past the pass. With int8 rows a thread's widened registers hold
  // depths 4t .. 4t + 3 of a 16-step (t = lane % 4) where the product wants
  // 2t, 2t + 1, 8 + 2t, 9 + 2t: the 32-bit pairs of each 16 values are
  // staged in that order instead (pair w at (w >> 1) + 4 (w & 1)).
  const int groups = panels * 4;  // 16-value groups a query row
  for (int e = tid; e < N * groups; e += WIDE_THREADS) {
    const int r = e / groups, v0 = (e % groups) * 16;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (r < nq && v0 < d) {
      const uint4* src = reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * d + v0);
      lo = src[0];
      hi = src[1];
    }
    if (INT8) {
      const uint4 a = lo, b = hi;
      lo = make_uint4(a.x, a.z, b.x, b.z);
      hi = make_uint4(a.y, a.w, b.y, b.w);
    }
    const int c = (v0 & 63) >> 3;
    unsigned char* row = s_q + (v0 >> 6) * N * 128 + r * 128;
    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) = hi;
  }
  // the products read the staged queries through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // the last block-wide barrier: the warpgroups go their own ways

  if (warp == WIDE_CONSUMERS / 32) {
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % WIDE_STAGES;
        // the stage's chunk before this one, c - STAGES, has been read
        if (c >= WIDE_STAGES) mbar_wait(empty_a + 8 * s, ((c / WIDE_STAGES) - 1) & 1);
        mbar_expect(full_a + 8 * s, WIDE_STAGE_BYTES);
        tma_load(ring_a + s * WIDE_STAGE_BYTES, &rows, (c % n_dc) * WIDE_CHUNK,
                 (int)(start + (long long)(c / n_dc) * WIDE_ROWS), full_a + 8 * s);
      }
    }
    return;
  }

  // int8 rows: warp (wg, wq)'s ldmatrix address of each 32-byte unit u of
  // a chunk, rows 16 wq .. + 15 of the 64-row block (matrices: rows 0-7 |
  // 8-15 x bytes 0-15 | 16-31 of the unit, the A fragment's order)
  uint32_t a_off[4];
  {
    const int r = 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a_off[u] = r * WIDE_CHUNK + (((2 * u + (lane >> 4)) ^ (lane & 7)) << 4);
  }
  // this thread's accumulators: rows my_row and my_row + 8 of each 64-row
  // block, the warpgroup's queries 8 j + 2 (lane % 4) (+ 1)
  const int my_row = 16 * wq + (lane >> 2), my_q = 2 * (lane & 3);
  const int qw = wg * NH;  // the warpgroup's first query slot
  const int nq_wg = max(0, min(NH, nq - qw));  // its live queries

  const float mult = metric_sq ? 2.0f : 1.0f;
  float acc[2][NH / 2];  // by 64-row block
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[b][i] = 0.f;
  uint32_t af[INT8 ? KSTEPS : 1][4];  // int8 rows: the widened A fragments
#pragma unroll
  for (int i = 0; i < (INT8 ? KSTEPS : 1); ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) af[i][j] = 0u;
  float scale[4], csq[4];  // rows my_row + 8 h of block b: [2 b + h]
  int tile = 0, dc = 0;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const long long row0 = start + (long long)tile * WIDE_ROWS;
    const int n_live = (int)min((long long)WIDE_ROWS, stop - row0);
    if (dc == 0) {
      // this thread's four rows: loaded before the products, used after them
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 64 * (e >> 1) + my_row + 8 * (e & 1);
        scale[e] = 1.0f;
        csq[e] = 0.0f;
        if (r < n_live) {
          const long long row = row0 + r;
          scale[e] = scales[row];
          const float s = sqn[row];
          const float pen = row < n_valid ? 0.0f : PAD_PENALTY;
          csq[e] = metric_sq ? s + pen : pen + fmaxf(s - DELETED_THRESHOLD, 0.0f);
        }
      }
    }

    const int stage_i = chunk % WIDE_STAGES;
    mbar_wait(full_a + 8 * stage_i, (chunk / WIDE_STAGES) & 1);
    const uint32_t stage = ring_a + stage_i * WIDE_STAGE_BYTES;
    // the chunk's depths in the warpgroup's staged queries: panel dc (bf16)
    // or 2 dc, 2 dc + 1 (int8)
    const uint32_t b0 = q_a + dc * (INT8 ? 2 : 1) * N * 128 + qw * 128;
    if constexpr (INT8) {
      // widened in registers, one 64-row block at a time: the products of
      // the block before must have read af first
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wg_wait<0>();
        keep(af);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t m[4];
          ldmatrix_x4(m, stage + 64 * b * WIDE_CHUNK + a_off[u]);
          widen_int8(m[0], af[2 * u][0], af[2 * u][2]);
          widen_int8(m[1], af[2 * u][1], af[2 * u][3]);
          widen_int8(m[2], af[2 * u + 1][0], af[2 * u + 1][2]);
          widen_int8(m[3], af[2 * u + 1][1], af[2 * u + 1][3]);
        }
        keep(af);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_wide<NH>(acc[b], af[ks], wide_desc(b0 + (ks >> 2) * N * 128 + (ks & 3) * 32),
                         dc > 0 || ks > 0);
        wg_commit();
      }
      mbar_arrive_lane0(empty_a + 8 * stage_i, lane);  // read by ldmatrix
    } else {
      // both operands from shared memory: the stage's two 64-row blocks
      wg_fence();
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_wide_ss<NH>(acc[b], wide_desc(stage + 64 * b * WIDE_CHUNK + ks * 32),
                            wide_desc(b0 + ks * 32), dc > 0 || ks > 0);
      wg_commit();
      wg_wait<1>();  // the chunk before's products are done with its stage
      if (chunk > 0)
        mbar_arrive_lane0(empty_a + 8 * ((chunk - 1) % WIDE_STAGES), lane);
    }
    if (++dc < n_dc) continue;
    dc = 0;
    ++tile;

    wg_wait<0>();
    keep(acc[0]);
    keep(acc[1]);
    // The tile's scores, one 64-row block at a time: fragments -> shared
    // memory as [query][row]. A query is flagged where one of its scores
    // beats its k-th best as of the last block (s_thr, which only rises:
    // what does not beat it cannot enter), and only a flagged query's warp
    // reads the block back as (warp = query, lane = row) into the
    // selection, in ascending row order, and leaves its new k-th best. The
    // warpgroup waits only for its own four warps.
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      int* flag = s_flag + b * N;
      // the other block's flags, read by every warp before the last barrier
      if (tid - 128 * wg < NH) s_flag[(1 - b) * N + qw + tid - 128 * wg] = 0;
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int qj = qw + 8 * j + my_q;
        const float2 thr = *reinterpret_cast<const float2*>(s_thr + qj);
        bool hit0 = false, hit1 = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = my_row + 8 * (e >> 1);
          const int h = 2 * b + (e >> 1);
          float v = mult * (acc[b][4 * j + e] * scale[h]) - csq[h];
          if (64 * b + rr >= n_live) v = neg_inf();
          s_sc[(qj + (e & 1)) * WIDE_SCORE_PITCH + rr] = v;
          if (e & 1) hit1 |= v > thr.y;
          else hit0 |= v > thr.x;
        }
        if (hit0) flag[qj] = 1;
        if (hit1) flag[qj + 1] = 1;
      }
      wg_sync(1 + wg);
      // The flagged queries are dealt to the warpgroup's four warps in
      // turn (the r-th to warp r % 4), so no warp waits for a busier one by
      // more than one query; a query's top-k comes from shared memory into
      // the warp's WarpTopK and goes back.
      const unsigned flags_lo = __ballot_sync(FULL, lane < nq_wg && flag[qw + lane]);
      const unsigned flags_hi = __ballot_sync(
          FULL, 32 + lane < nq_wg && flag[min(qw + 32 + lane, N - 1)]);
      int turn = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned todo = half ? flags_hi : flags_lo;
        while (todo) {  // the same for the whole warp
          const int qi = qw + 32 * half + __ffs(todo) - 1;
          todo &= todo - 1;
          if ((turn++ & 3) != wq) continue;
          WarpTopK t;
          t.s = lane < k ? s_top[qi * k + lane] : neg_inf();
          t.id = lane < k ? s_top_id[qi * k + lane] : -1;
          t.thresh = s_thr[qi];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 32 * hh + lane;
            t.offer(s_sc[qi * WIDE_SCORE_PITCH + r], (int)(row0 + 64 * b + r), k, lane);
          }
          if (lane < k) {
            s_top[qi * k + lane] = t.s;
            s_top_id[qi * k + lane] = t.id;
          }
          if (lane == 0) s_thr[qi] = t.thresh;
        }
      }
      wg_sync(1 + wg);  // the block is read before the next one is written
    }
  }
  // the last selection's top-k are in place (the barrier after it)
  for (int qi = qw + wq; qi < qw + nq_wg; qi += 4) {
    if (lane < k) {
      const long long o = ((long long)(q0 + qi) * n_splits + split) * k + lane;
      part_s[o] = s_top[qi * k + lane];
      part_i[o] = s_top_id[qi * k + lane];
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, found through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or null where the driver has none.
EncodeTiled find_encode_tiled() {
  void* found = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found,
                                                cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(found);
}

// The corpus as the wide kernel's TMA reads it: row_bytes x n_rows bytes,
// one box a stage (WIDE_CHUNK bytes x WIDE_ROWS rows), 128-byte swizzle,
// zeros past either edge.
cudaError_t wide_rows_map(CUtensorMap* map, const void* x, int row_bytes,
                          long long n_rows) {
  // looked up once a process; C++ makes the first call the only one
  static const EncodeTiled encode = find_encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {WIDE_CHUNK, WIDE_ROWS};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MODE, int N>
cudaError_t launch_wide(const CUtensorMap& map, const void* q, const float* sqn,
                        const float* scales, int n_q, int d, long long n_rows,
                        int n_valid, int metric_sq, int k, int width,
                        int passes, long long rows_per_split, int n_splits,
                        int n_dc, int panels, float* part_s, int* part_i,
                        cudaStream_t stream) {
  const int smem = wide_smem_bytes(N, panels, k);
  static int allowed[MAX_DEVICES] = {};  // this instance's, by device
  const cudaError_t e = allow_smem(allowed, exact_scan_wide_kernel<MODE, N>, smem);
  if (e != cudaSuccess) return e;
  exact_scan_wide_kernel<MODE, N><<<dim3(passes, n_splits), WIDE_THREADS, smem, stream>>>(
      map, (const __nv_bfloat16*)q, sqn, scales, n_q, d, n_rows, n_valid, metric_sq, k,
      width, rows_per_split, n_dc, panels, part_s, part_i);
  return cudaGetLastError();
}

// ------------------------------------------------------------- K2 / K3 ---
// Column classes: row r belongs to class r mod W. grid (ceil(n_q / TQ),
// ceil(W / TC), n_splits); block (bx, by, s) owns classes [by*TC, by*TC+TC)
// and corpus tiles j in [s * tiles_per_split, (s+1) * tiles_per_split), each
// tile being rows j * W + class. Classes never straddle blocks of one split,
// so the per-class state of a block is private to it.

struct ClassTile {
  long long row0;
  int n_live;
};

__device__ __forceinline__ ClassTile class_tile(long long j, int c0, int w,
                                                long long n_rows) {
  ClassTile t;
  t.row0 = j * w + c0;
  t.n_live = (int)min((long long)min(TC, w - c0), max(0LL, n_rows - t.row0));
  return t;
}

// K2: per-(query, class) running best (score, row) in registers; a strict >
// keeps the earliest row. Partials: (S, n_q, W).
template <typename QT, typename XT, bool INT8C>
__global__ void __launch_bounds__(THREADS) sketch_scan_kernel(
    const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const float* __restrict__ qscales, int n_q, int d, long long n_rows,
    int n_valid, int metric_sq, int w, long long tiles_per_split,
    float* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ Stage<INT8C> st;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * TQ, c0 = blockIdx.y * TC, split = blockIdx.z;
  const long long n_tiles = (n_rows + w - 1) / w;
  const long long j0 = (long long)split * tiles_per_split;
  const long long j1 = min(n_tiles, j0 + tiles_per_split);
  float best[QPT][CPT];
  int best_r[QPT][CPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      best[i][j] = neg_inf();
      best_r[i][j] = -1;
    }
  for (long long jt = j0; jt < j1; ++jt) {
    const ClassTile t = class_tile(jt, c0, w, n_rows);
    if (t.n_live <= 0) break;  // past the last row (uniform across the block)
    float v[QPT][CPT];
    score_tile<QT, XT, INT8C>(st, q, x, sqn, scales, qscales, n_q, q0, d,
                              t.row0, t.n_live, n_valid, metric_sq, v);
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (v[i][j] > best[i][j]) {
          best[i][j] = v[i][j];
          best_r[i][j] = (int)(t.row0 + lane + 32 * j);
        }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int qq = q0 + warp + 8 * i, c = c0 + lane + 32 * j;
      if (qq < n_q && c < w) {
        const long long o = ((long long)split * n_q + qq) * w + c;
        part_s[o] = best[i][j];
        part_i[o] = best_r[i][j];
      }
    }
}

// The products of one ring chunk on the tensor cores: warp w multiplies the
// TQ staged queries (A, from `a_addr`) with rows [16 w, 16 w + 16) of the
// stage (B, from `b_addr`: two 8-row mma tiles) over `units` 32-byte units
// of the rows. MODE 0: bf16 rows and queries; 1: int8 rows widened to bf16
// in registers, the queries staged in the matching depth order (see
// stage_query_tile; 64 bytes of queries a unit); 3: int8 rows and int8
// queries, exact int32 sums.
template <int MODE, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[2][4], uint32_t a_addr,
                                          uint32_t b_addr, int units) {
#pragma unroll 4
  for (int u = 0; u < units; ++u) {
    uint32_t b[4];
    ldmatrix_x4(b, b_addr + u * 32);
    if constexpr (MODE == 1) {
      uint32_t a0[4], a1[4], lo, hi;
      ldmatrix_x4(a0, a_addr + u * 64);
      ldmatrix_x4(a1, a_addr + u * 64 + 32);
      widen_int8(b[0], lo, hi);
      mma_16x8x16(acc[0], a0, lo, hi);
      widen_int8(b[2], lo, hi);
      mma_16x8x16(acc[1], a0, lo, hi);
      widen_int8(b[1], lo, hi);
      mma_16x8x16(acc[0], a1, lo, hi);
      widen_int8(b[3], lo, hi);
      mma_16x8x16(acc[1], a1, lo, hi);
    } else {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + u * 32);
      if constexpr (MODE == 3) {
        mma_16x8x32_s8(acc[0], a, b[0], b[1]);
        mma_16x8x32_s8(acc[1], a, b[2], b[3]);
      } else {
        mma_16x8x16(acc[0], a, b[0], b[1]);
        mma_16x8x16(acc[1], a, b[2], b[3]);
      }
    }
  }
}

// Stage the query tile [q0, q0 + TQ) (zeros from q_end) at `s_q`, `q_pitch`
// bytes a query, in the layout mma_chunk<MODE> reads: MODE 0 bf16, 2 fp32
// and 3 int8 as they are; MODE 1 bf16 with each 16-step's depths permuted,
// since an ldmatrix register of int8 rows holds depths 4t .. 4t + 3 of a
// 16-step (t = lane % 4) where the bf16 mma wants 2t, 2t + 1, 8 + 2t,
// 9 + 2t (a dot product does not mind the order).
template <int MODE>
__device__ __forceinline__ void stage_query_tile(unsigned char* s_q, int q_pitch,
                                                 const void* q, int q0, int q_end,
                                                 int d) {
  for (int e = threadIdx.x; e < TQ * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const bool live = q0 + r < q_end;
    const long long src = (long long)(q0 + r) * d + c;
    if constexpr (MODE == 2) {
      reinterpret_cast<float*>(s_q + r * q_pitch)[c] =
          live ? static_cast<const float*>(q)[src] : 0.f;
    } else if constexpr (MODE == 3) {
      reinterpret_cast<int8_t*>(s_q + r * q_pitch)[c] =
          live ? static_cast<const int8_t*>(q)[src] : (int8_t)0;
    } else {
      int col = c;
      if (MODE == 1) {
        const int t = (c & 15) >> 2, j = c & 3;
        col = (c & ~15) | (j < 2 ? 2 * t + j : 8 + 2 * t + (j - 2));
      }
      reinterpret_cast<__nv_bfloat16*>(s_q + r * q_pitch)[col] =
          live ? static_cast<const __nv_bfloat16*>(q)[src] : __float2bfloat16(0.f);
    }
  }
}

// K2's and K3's walk of the ring (the routes of ops/flat_kernels.sketch_route
// and topr_plan other than "cores"). Block (query block, 128-class chunk
// from c0, split s) takes queries [q0, q_end), q0 = blockIdx.x * qpb (qpb <=
// TQ; the staged tile's other rows are zeros), and streams, for each tile
// jt of its split in ascending order, the rows jt * w + c0 .. + min(TC, w -
// c0) (fewer past n_rows) through K1's ring, one depth chunk at a time, and
// multiplies them as exact_scan_kernel does: MODE 0 bf16 rows, 1 int8 rows
// with bf16 queries (mma.sync m16n8k16, fp32 sums), 3 int8 rows with int8
// queries (m16n8k32, exact int32 sums: the integer dot of the plain
// version, so this route's scores are bit-equal to it), 2 fp32 rows on the
// CUDA cores (fp32 FMAs in the selection's own layout). At a tile's end
// thread (warp w, lane l) hands the selection `sel` the score of each live
// (query q0 + w + 8 i < q_end, row jt * w + c0 + l + 32 j) as
// sel.offer(i, j, score, jt, row): the selection is the one thing K2 and K3
// do differently.
template <int MODE, typename Sel>
__device__ __forceinline__ void class_ring_walk(
    unsigned char* ring_smem, const void* __restrict__ q,
    const unsigned char* __restrict__ x, const float* __restrict__ sqn,
    const float* __restrict__ scales, const float* __restrict__ qscales,
    int n_q, int qpb, int d, long long n_rows, int n_valid, int metric_sq,
    int w, long long tiles_per_split, int n_dc, int chunk_bytes, Sel& sel) {
  constexpr bool FP32 = MODE == 2, I8Q = MODE == 3;
  using Acc = typename std::conditional<I8Q, int, float>::type;
  constexpr int QS = FP32 ? 4 : I8Q ? 1 : 2;  // bytes of a staged query value
  const int row_bytes = FP32 ? 4 * d : MODE == 0 ? 2 * d : d;
  const int pitch = chunk_bytes + 16;
  const int q_pitch = QS * d + 16;
  const int stage_bytes = TC * pitch;
  unsigned char* s_q = ring_smem;                                   // [TQ][q_pitch]
  float* s_sc = reinterpret_cast<float*>(s_q + TQ * q_pitch);       // [TQ][SCORE_PITCH]
  unsigned char* s_ring = reinterpret_cast<unsigned char*>(s_sc + (FP32 ? 0 : TQ * SCORE_PITCH));
  const uint32_t ring_a = smem_u32(s_ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * qpb, c0 = blockIdx.y * TC, split = blockIdx.z;
  const int q_end = min(n_q, q0 + qpb);
  const int n_class = min(TC, w - c0);  // this block's classes
  // the tiles whose first row of this chunk lies before n_rows
  const long long tiles_all = n_rows > c0 ? (n_rows - c0 + w - 1) / w : 0;
  const long long j0 = (long long)split * tiles_per_split;
  const int n_tiles = (int)max(0LL, min(tiles_all, j0 + tiles_per_split) - j0);
  const int n_chunks = n_tiles * n_dc;

  RingLoader loader;
  loader.init(chunk_bytes);
  int ld_tile = 0, ld_dc = 0;  // the next chunk to load
  auto load_next = [&](int chunk) {
    if (chunk < n_chunks) {
      const long long first = (j0 + ld_tile) * w + c0;
      const int byte0 = ld_dc * chunk_bytes;
      loader.load(ring_a + (chunk % RING_STAGES) * stage_bytes, pitch, x, row_bytes,
                  first, (int)min((long long)n_class, n_rows - first), byte0,
                  min(chunk_bytes, row_bytes - byte0));
      if (++ld_dc == n_dc) {
        ld_dc = 0;
        ++ld_tile;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");  // one group a call
  };
#pragma unroll
  for (int c = 0; c < RING_STAGES - 1; ++c) load_next(c);
  stage_query_tile<MODE>(s_q, q_pitch, q, q0, q_end, d);

  const int mat = lane >> 3;
  const uint32_t a_lane =
      smem_u32(s_q) + ((lane & 7) + (mat & 1) * 8) * q_pitch + (mat >> 1) * 16;
  const uint32_t b_lane =
      (warp * 16 + (lane & 7) + (mat >> 1) * 8) * pitch + (mat & 1) * 16;

  const float mult = metric_sq ? 2.0f : 1.0f;
  float qmul[QPT];  // mult x the query's scale (int8 queries), exact
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qq = q0 + warp + 8 * i;
    qmul[i] = I8Q && qq < q_end ? mult * qscales[qq] : mult;
  }
  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);
  float scale[CPT], csq[CPT];
  int tile = 0, dc = 0;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    asm volatile("cp.async.wait_group %0;" ::"n"(RING_STAGES - 2) : "memory");
    __syncthreads();  // the chunk has landed; every warp is done with the one before
    load_next(chunk + RING_STAGES - 1);

    const long long jt = j0 + tile;
    const long long row0 = jt * w + c0;
    const int n_live = (int)min((long long)n_class, n_rows - row0);
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = lane + 32 * j;
        scale[j] = 1.0f;
        csq[j] = 0.0f;
        if (r < n_live) {
          const long long row = row0 + r;
          scale[j] = scales[row];
          const float s = sqn[row];
          const float pen = row < n_valid ? 0.0f : PAD_PENALTY;
          csq[j] = metric_sq ? s + pen : pen + fmaxf(s - DELETED_THRESHOLD, 0.0f);
        }
      }
    }

    const int byte0 = dc * chunk_bytes;
    const int width = min(chunk_bytes, row_bytes - byte0);
    if constexpr (FP32) {
      const unsigned char* rows = s_ring + (chunk % RING_STAGES) * stage_bytes + lane * pitch;
      const unsigned char* qs = s_q + warp * q_pitch + byte0;
#pragma unroll 2
      for (int u = 0; u < width; u += 16) {
        float4 a[QPT], b[CPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + 8 * i * q_pitch + u);
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          b[j] = *reinterpret_cast<const float4*>(rows + 32 * j * pitch + u);
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
    } else {
      // the chunk's first value in the staged queries: 2 bytes a value for
      // bf16 queries over int8 rows, as many bytes as the rows otherwise
      mma_chunk<MODE>(acc, a_lane + (MODE == 1 ? 2 * byte0 : byte0),
                      ring_a + (chunk % RING_STAGES) * stage_bytes + b_lane,
                      width >> 5);
    }
    if (++dc < n_dc) continue;
    dc = 0;
    ++tile;

    if constexpr (!FP32) {
      // fragments -> shared memory -> (warp = query, lane = row), as in K1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* dst = s_sc + (lane >> 2) * SCORE_PITCH + warp * 16 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dst) = make_float2((float)acc[nt][0], (float)acc[nt][1]);
        *reinterpret_cast<float2*>(dst + 8 * SCORE_PITCH) =
            make_float2((float)acc[nt][2], (float)acc[nt][3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = Acc(0);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const bool dead = q0 + warp + 8 * i >= q_end;  // the same for the whole warp
      if constexpr (!FP32) {
        if (dead) continue;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = lane + 32 * j;
        float dot;
        if constexpr (FP32) {
          dot = acc[i][j];
          acc[i][j] = 0.f;
          if (dead) continue;
        } else {
          dot = s_sc[(warp + 8 * i) * SCORE_PITCH + r];
        }
        // int8 queries: every step rounded as the plain version rounds it
        // (no FMA contraction), so the scores are bit-equal
        const float v = I8Q ? __fsub_rn(__fmul_rn(qmul[i], __fmul_rn(dot, scale[j])), csq[j])
                            : mult * (dot * scale[j]) - csq[j];
        if (r < n_live) sel.offer(i, j, v, jt, row0 + r);
      }
    }
  }
}

// K2's selection: the best (score, row) of each of the thread's (query,
// class) in registers; a strict > over tiles in ascending order keeps the
// earliest row of a tie.
struct ClassBest {
  float best[QPT][CPT];
  int best_r[QPT][CPT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        best[i][j] = neg_inf();
        best_r[i][j] = -1;
      }
  }

  __device__ __forceinline__ void offer(int i, int j, float v, long long,
                                        long long row) {
    if (v > best[i][j]) {
      best[i][j] = v;
      best_r[i][j] = (int)row;
    }
  }
};

// K2 on the ring: class_ring_walk with a block of TQ queries and ClassBest.
// Partials: (S, n_q, W), as sketch_scan_kernel's.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) sketch_ring_kernel(
    const void* __restrict__ q, const unsigned char* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const float* __restrict__ qscales, int n_q, int d, long long n_rows,
    int n_valid, int metric_sq, int w, long long tiles_per_split, int n_dc,
    int chunk_bytes, float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  ClassBest sel;
  sel.init();
  class_ring_walk<MODE>(ring_smem, q, x, sqn, scales, qscales, n_q, TQ, d,
                        n_rows, n_valid, metric_sq, w, tiles_per_split, n_dc,
                        chunk_bytes, sel);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * TQ, c0 = blockIdx.y * TC, split = blockIdx.z;
  const int n_class = min(TC, w - c0);
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int qq = q0 + warp + 8 * i, cl = lane + 32 * j;
      if (qq < n_q && cl < n_class) {
        const long long o = ((long long)split * n_q + qq) * w + c0 + cl;
        part_s[o] = sel.best[i][j];
        part_i[o] = sel.best_r[i][j];
      }
    }
}

// One block per query: per-class max over splits in split (= row) order with
// a strict >, then warp 0 takes the top-k of the W class winners in class
// order (ties keep the lower class, as the TPU kernel's argmax rounds did).
constexpr int MAX_SKETCH_W = 2048;

__global__ void __launch_bounds__(THREADS) sketch_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int n_q,
    int n_splits, int w, int k, float* __restrict__ out_s,
    int* __restrict__ out_i) {
  __shared__ float ws[MAX_SKETCH_W];
  __shared__ int wi[MAX_SKETCH_W];
  const int qq = blockIdx.x, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    float b = neg_inf();
    int bi = -1;
    for (int s = 0; s < n_splits; ++s) {
      const long long o = ((long long)s * n_q + qq) * w + c;
      const float v = part_s[o];
      if (v > b) {
        b = v;
        bi = part_i[o];
      }
    }
    ws[c] = b;
    wi[c] = bi;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  WarpTopK top;
  top.init();
  for (int c0 = 0; c0 < w; c0 += 32) {
    const int c = c0 + lane;
    top.offer(c < w ? ws[c] : neg_inf(), c < w ? wi[c] : -1, k, lane);
  }
  if (lane < k) {
    const bool ok = top.s > VALID_MIN;
    out_s[(long long)qq * k + lane] = ok ? top.s : neg_inf();
    out_i[(long long)qq * k + lane] = ok ? top.id : -1;
  }
}

// K3: per-(query, class) top-R planes + `rej`, the best value the class ever
// rejected (= its (R+1)-th best). A block's planes are private to it and
// live in its shared memory ([qpb][R][TC] scores, then ids), for the qpb
// queries it owns (q0 = blockIdx.x * qpb; the score tile's other rows are
// unused). Plane R-1 and rej stay in registers, and the chain runs only for
// a candidate that beats plane R-1. At the end each thread copies its own
// planes out. Partials: planes (S, n_q, R, W), rej (S, n_q, W).
//
// topr_scan_kernel is the "cores" route of ops/flat_kernels.topr_plan
// (depths the ring does not take, and planes that do not fit beside it):
// score_tile's CUDA-core loop.

template <typename QT, typename XT>
__global__ void __launch_bounds__(THREADS) topr_scan_kernel(
    const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales, int n_q,
    int d, long long n_rows, int n_valid, int metric_sq, int w, int r_planes,
    int qpb, long long tiles_per_split, float* __restrict__ part_s,
    int* __restrict__ part_i, float* __restrict__ part_rej) {
  __shared__ Stage<false> st;
  extern __shared__ float planes[];
  float* ps = planes;
  int* pi = reinterpret_cast<int*>(planes + qpb * r_planes * TC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * qpb, c0 = blockIdx.y * TC, split = blockIdx.z;
  const int q_end = min(n_q, q0 + qpb);
  const long long n_tiles = (n_rows + w - 1) / w;
  const long long j0 = (long long)split * tiles_per_split;
  const long long j1 = min(n_tiles, j0 + tiles_per_split);
  for (int e = threadIdx.x; e < qpb * r_planes * TC; e += THREADS) {
    ps[e] = neg_inf();
    pi[e] = -1;
  }
  __syncthreads();
  float last[QPT][CPT], rej[QPT][CPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      last[i][j] = neg_inf();
      rej[i][j] = neg_inf();
    }
  for (long long jt = j0; jt < j1; ++jt) {
    const ClassTile t = class_tile(jt, c0, w, n_rows);
    if (t.n_live <= 0) break;
    float v[QPT][CPT];
    score_tile<QT, XT, false>(st, q, x, sqn, scales, nullptr, q_end, q0, d,
                              t.row0, t.n_live, n_valid, metric_sq, v);
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int qi = warp + 8 * i, cl = lane + 32 * j;
        if (q0 + qi >= q_end || c0 + cl >= w) continue;
        float out = v[i][j];
        if (out > last[i][j]) {
          const int o = qi * r_planes * TC + cl;
          out = chain_insert(ps + o, pi + o, TC, r_planes, v[i][j],
                             (int)(t.row0 + cl), last[i][j]);
        }
        rej[i][j] = fmaxf(rej[i][j], out);
      }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int qi = warp + 8 * i, cl = lane + 32 * j, c = c0 + cl;
      if (q0 + qi >= q_end || c >= w) continue;
      const long long o = ((long long)split * n_q + q0 + qi) * r_planes * w + c;
      for (int r = 0; r < r_planes; ++r) {
        part_s[o + (long long)r * w] = ps[(qi * r_planes + r) * TC + cl];
        part_i[o + (long long)r * w] = pi[(qi * r_planes + r) * TC + cl];
      }
      part_rej[((long long)split * n_q + q0 + qi) * w + c] = rej[i][j];
    }
}

// K3 on the ring: the same planes and chain, fed by class_ring_walk. Each
// thread keeps plane R-1 (`last`) and rej of its (query, class) pairs in
// registers; a score that beats `last` runs the chain through the planes
// in shared memory, which lie behind the ring ([qpb][R][TC] scores, then
// [qpb][R][TC] ids). Ids are rows (ID_BYTES 4) or, while the corpus has at
// most 65,535 tiles, the 16-bit tile number jt of row jt * w + c (ID_BYTES
// 2): 6 bytes an entry, so all 16 queries' planes of R = 12 fit beside the
// ring at D = 384 (ops/flat_kernels.topr_plan). Each candidate is offered
// in ascending row order, as topr_scan_kernel offers it. Partials (S, n_q,
// R, W) and (S, n_q, W); with one split (gridDim.z = 1) they are the
// outputs, and the validity rule is applied here instead of in the merge.
template <typename IDT>
struct ClassPlanes {
  float last[QPT][CPT], rej[QPT][CPT];
  float* ps;
  IDT* pi;
  int r_planes;

  __device__ __forceinline__ void init(float* ps_, IDT* pi_, int r, int qpb) {
    ps = ps_;
    pi = pi_;
    r_planes = r;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        last[i][j] = neg_inf();
        rej[i][j] = neg_inf();
        const int qi = warp + 8 * i;
        if (qi >= qpb) continue;
        // this thread's own planes: nobody else reads or writes them
        for (int rr = 0; rr < r; ++rr) {
          const int o = (qi * r + rr) * TC + lane + 32 * j;
          ps[o] = neg_inf();
          pi[o] = IDT(-1);
        }
      }
  }

  __device__ __forceinline__ void offer(int i, int j, float v, long long jt,
                                        long long row) {
    float out = v;
    if (v > last[i][j]) {
      const int qi = (threadIdx.x >> 5) + 8 * i, cl = (threadIdx.x & 31) + 32 * j;
      const int o = qi * r_planes * TC + cl;
      out = chain_insert(ps + o, pi + o, TC, r_planes, v,
                         (IDT)(sizeof(IDT) == 2 ? jt : row), last[i][j]);
    }
    rej[i][j] = fmaxf(rej[i][j], out);
  }
};

// Bytes of class_ring_walk's shared memory (query tile, score tile, ring)
// before whatever its selection keeps behind it; a multiple of 16.
__host__ __device__ inline int class_ring_bytes(int q_bytes, bool score_tile,
                                                int d, int chunk_bytes) {
  return TQ * (q_bytes * d + 16) + (score_tile ? TQ * SCORE_PITCH * 4 : 0) +
         RING_STAGES * TC * (chunk_bytes + 16);
}

template <int MODE, int ID_BYTES>
__global__ void __launch_bounds__(THREADS, 2) topr_ring_kernel(
    const void* __restrict__ q, const unsigned char* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales, int n_q,
    int qpb, int d, long long n_rows, int n_valid, int metric_sq, int w,
    int r_planes, long long tiles_per_split, int n_dc, int chunk_bytes,
    float* __restrict__ part_s, int* __restrict__ part_i,
    float* __restrict__ part_rej) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  using IDT = typename std::conditional<ID_BYTES == 2, uint16_t, int>::type;
  constexpr bool FP32 = MODE == 2;
  float* ps = reinterpret_cast<float*>(
      ring_smem + class_ring_bytes(FP32 ? 4 : 2, !FP32, d, chunk_bytes));
  IDT* pi = reinterpret_cast<IDT*>(ps + qpb * r_planes * TC);
  ClassPlanes<IDT> sel;
  sel.init(ps, pi, r_planes, qpb);
  class_ring_walk<MODE>(ring_smem, q, x, sqn, scales, nullptr, n_q, qpb, d,
                        n_rows, n_valid, metric_sq, w, tiles_per_split, n_dc,
                        chunk_bytes, sel);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * qpb, c0 = blockIdx.y * TC, split = blockIdx.z;
  const int n_class = min(TC, w - c0);
  const bool single = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int qi = warp + 8 * i, cl = lane + 32 * j, qq = q0 + qi;
      if (qi >= qpb || qq >= n_q || cl >= n_class) continue;
      const long long o = ((long long)split * n_q + qq) * r_planes * w + c0 + cl;
      for (int r = 0; r < r_planes; ++r) {
        float s = ps[(qi * r_planes + r) * TC + cl];
        const IDT id = pi[(qi * r_planes + r) * TC + cl];
        int row = id == IDT(-1) ? -1
                  : ID_BYTES == 2 ? (int)((long long)id * w + c0 + cl) : (int)id;
        if (single && !(s > VALID_MIN)) {
          s = neg_inf();
          row = -1;
        }
        part_s[o + (long long)r * w] = s;
        part_i[o + (long long)r * w] = row;
      }
      part_rej[((long long)split * n_q + qq) * w + c0 + cl] = sel.rej[i][j];
    }
}

// Storage/query type combinations: 0 fp32/fp32, 1 bf16/bf16, 2 bf16 queries
// over int8 rows (bf16 scoring), 3 int8 x int8 (sketch only).
enum Combo { F32 = 0, BF16 = 1, I8_BF16 = 2, I8_I8 = 3 };

// K1's merge of the (n_q, n_splits, k) partials of either route.
inline cudaError_t launch_merge(const float* part_s, const int* part_i, int n_q,
                                int n_splits, int k, float* out_s, int* out_i,
                                cudaStream_t stream) {
  const int warps = 8;
  merge_partials_kernel<<<(n_q + warps - 1) / warps, 32 * warps, 0, stream>>>(
      part_s, part_i, n_q, n_splits, k, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ring = 1 takes the ring-fed kernel (bf16 or int8 rows of a multiple of 32
// bytes on the tensor cores, fp32 rows of a multiple of 16 bytes on the
// CUDA cores; the corpus 16-byte aligned, two blocks an SM), 0 the older
// CUDA-core kernel; the wrapper chooses and sizes the splits to match.
int flat_exact_topk(int combo, int ring, const void* q, const void* x,
                    const float* sqn, const float* scales, int n_q, int d,
                    long long n_rows, int n_valid, int metric_sq, int k,
                    long long rows_per_split, int n_splits, float* part_s,
                    int* part_i, float* out_s, int* out_i, cudaStream_t stream) {
  if (k < 1 || k > 32 || n_q < 1 || n_rows < 1 || rows_per_split % TC != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + TQ - 1) / TQ, n_splits);
  if (ring) {
    const bool fp32 = combo == F32;
    const int row_bytes = fp32 ? 4 * d : combo == I8_BF16 ? d : 2 * d;
    if ((!fp32 && combo != BF16 && combo != I8_BF16) ||
        row_bytes % (fp32 ? 16 : 32) != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int chunk_bytes = std::min(RING_CHUNK, row_bytes);
    const int n_dc = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    // the staged queries, the score tile (tensor-core modes) and the ring
    const int smem = TQ * ((fp32 ? 4 : 2) * d + 16) +
                     (fp32 ? 0 : TQ * SCORE_PITCH * (int)sizeof(float)) +
                     RING_STAGES * TC * (chunk_bytes + 16);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
#define LAUNCH_RING(I8)                                                      \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, exact_scan_kernel<I8>, smem);        \
    if (e != cudaSuccess) return (int)e;                                     \
    exact_scan_kernel<I8><<<grid, THREADS, smem, stream>>>(                  \
        q, (const unsigned char*)x, sqn, scales, n_q, d, n_rows, n_valid,    \
        metric_sq, k, rows_per_split, n_dc, chunk_bytes, part_s, part_i);    \
  }
    if (fp32) LAUNCH_RING(2) else if (combo == I8_BF16) LAUNCH_RING(1) else LAUNCH_RING(0)
#undef LAUNCH_RING
  } else {
#define LAUNCH_EXACT(QT, XT)                                                 \
  exact_scan_cores_kernel<QT, XT><<<grid, THREADS, 0, stream>>>(             \
      (const QT*)q, (const XT*)x, sqn, scales, n_q, d, n_rows, n_valid,      \
      metric_sq, k, rows_per_split, part_s, part_i)
    switch (combo) {
      case F32: LAUNCH_EXACT(float, float); break;
      case BF16: LAUNCH_EXACT(__nv_bfloat16, __nv_bfloat16); break;
      case I8_BF16: LAUNCH_EXACT(__nv_bfloat16, int8_t); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef LAUNCH_EXACT
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_q, n_splits, k, out_s, out_i, stream);
}

// K1's wide route (bf16 rows, or int8 rows widened to bf16, of a multiple
// of 32 bytes; corpus and queries 16-byte aligned): `passes` blocks of
// `width` <= WIDE_MAX_N queries (the last one shorter) over `n_splits`
// splits, one block an SM; the wrapper plans both (ops/flat_kernels.exact_plan).
int flat_exact_wide_topk(int combo, const void* q, const void* x,
                         const float* sqn, const float* scales, int n_q, int d,
                         long long n_rows, int n_valid, int metric_sq, int k,
                         int width, int passes, long long rows_per_split,
                         int n_splits, float* part_s, int* part_i, float* out_s,
                         int* out_i, cudaStream_t stream) {
  const int row_bytes = combo == I8_BF16 ? d : 2 * d;
  if (k < 1 || k > 32 || n_q < 1 || n_rows < 1 || rows_per_split % WIDE_ROWS != 0 ||
      (combo != BF16 && combo != I8_BF16) || row_bytes % 32 != 0 ||
      width < 1 || width > WIDE_MAX_N || (long long)passes * width < n_q ||
      (long long)(passes - 1) * width >= n_q || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)q % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_dc = (row_bytes + WIDE_CHUNK - 1) / WIDE_CHUNK;
  const int panels = n_dc * (combo == I8_BF16 ? 2 : 1);
  const int n = (width + 15) / 16 * 16;
  if (wide_smem_bytes(n, panels, k) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = wide_rows_map(&map, x, row_bytes, n_rows);
  if (err != cudaSuccess) return (int)err;
  err = cudaErrorInvalidValue;
#define WIDE_CASE(N)                                                         \
  case N:                                                                    \
    err = combo == BF16                                                      \
              ? launch_wide<0, N>(map, q, sqn, scales, n_q, d, n_rows,       \
                                  n_valid, metric_sq, k, width, passes,      \
                                  rows_per_split, n_splits, n_dc, panels,    \
                                  part_s, part_i, stream)                    \
              : launch_wide<1, N>(map, q, sqn, scales, n_q, d, n_rows,       \
                                  n_valid, metric_sq, k, width, passes,      \
                                  rows_per_split, n_splits, n_dc, panels,    \
                                  part_s, part_i, stream);                   \
    break;
  switch (n) {
    WIDE_CASE(16) WIDE_CASE(32) WIDE_CASE(48) WIDE_CASE(64) WIDE_CASE(80)
    WIDE_CASE(96) WIDE_CASE(112) WIDE_CASE(128)
  }
#undef WIDE_CASE
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_s, part_i, n_q, n_splits, k, out_s, out_i, stream);
}

// ring = 1 takes sketch_ring_kernel (bf16 and int8 rows of a multiple of 32
// bytes, with bf16 or int8 queries, and fp32 rows of a multiple of 16 bytes;
// the corpus 16-byte aligned, two blocks an SM), 0 sketch_scan_kernel.
int flat_sketch_topk(int combo, int ring, const void* q, const void* x,
                     const float* sqn, const float* scales, const float* qscales,
                     int n_q, int d, long long n_rows, int n_valid, int metric_sq,
                     int w, int k, long long tiles_per_split, int n_splits,
                     float* part_s, int* part_i, float* out_s, int* out_i,
                     cudaStream_t stream) {
  if (k < 1 || k > 32 || w < 1 || w > MAX_SKETCH_W || n_q < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + TQ - 1) / TQ, (w + TC - 1) / TC, n_splits);
  if (ring) {
    const bool fp32 = combo == F32;
    const int row_bytes = fp32 ? 4 * d : combo == BF16 ? 2 * d : d;
    if (combo < F32 || combo > I8_I8 || row_bytes % (fp32 ? 16 : 32) != 0 ||
        (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int chunk_bytes = std::min(RING_CHUNK, row_bytes);
    const int n_dc = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    const int q_bytes = fp32 ? 4 : combo == I8_I8 ? 1 : 2;
    // the staged queries, the score tile (tensor-core modes) and the ring
    const int smem = TQ * (q_bytes * d + 16) +
                     (fp32 ? 0 : TQ * SCORE_PITCH * (int)sizeof(float)) +
                     RING_STAGES * TC * (chunk_bytes + 16);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
#define LAUNCH_SKETCH_RING(MODE)                                             \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, sketch_ring_kernel<MODE>, smem);     \
    if (e != cudaSuccess) return (int)e;                                     \
    sketch_ring_kernel<MODE><<<grid, THREADS, smem, stream>>>(               \
        q, (const unsigned char*)x, sqn, scales, qscales, n_q, d, n_rows,    \
        n_valid, metric_sq, w, tiles_per_split, n_dc, chunk_bytes, part_s,   \
        part_i);                                                             \
  }
    switch (combo) {
      case F32: LAUNCH_SKETCH_RING(2) break;
      case BF16: LAUNCH_SKETCH_RING(0) break;
      case I8_BF16: LAUNCH_SKETCH_RING(1) break;
      default: LAUNCH_SKETCH_RING(3) break;
    }
#undef LAUNCH_SKETCH_RING
  } else {
#define LAUNCH_SKETCH(QT, XT, I8C)                                           \
  sketch_scan_kernel<QT, XT, I8C><<<grid, THREADS, 0, stream>>>(             \
      (const QT*)q, (const XT*)x, sqn, scales, qscales, n_q, d, n_rows,      \
      n_valid, metric_sq, w, tiles_per_split, part_s, part_i)
    switch (combo) {
      case F32: LAUNCH_SKETCH(float, float, false); break;
      case BF16: LAUNCH_SKETCH(__nv_bfloat16, __nv_bfloat16, false); break;
      case I8_BF16: LAUNCH_SKETCH(__nv_bfloat16, int8_t, false); break;
      case I8_I8: LAUNCH_SKETCH(int8_t, int8_t, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef LAUNCH_SKETCH
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sketch_merge_kernel<<<n_q, THREADS, 0, stream>>>(part_s, part_i, n_q,
                                                   n_splits, w, k, out_s, out_i);
  return (int)cudaGetLastError();
}

// ring = 1 takes topr_ring_kernel (bf16 and int8 rows of a multiple of 32
// bytes, fp32 rows of a multiple of 16; the corpus 16-byte aligned), 0
// topr_scan_kernel; `qpb` queries a block and `id_bytes` (2: tile numbers,
// ring only; 4: rows) as ops/flat_kernels.topr_plan chose them. With one
// split the ring kernel writes the outputs itself and no merge runs.
int flat_topr(int combo, int ring, int qpb, int id_bytes, const void* q,
              const void* x, const float* sqn, const float* scales, int n_q,
              int d, long long n_rows, int n_valid, int metric_sq, int w,
              int r_planes, long long tiles_per_split, int n_splits,
              float* part_s, int* part_i, float* part_rej, float* out_s,
              int* out_i, float* out_rej, cudaStream_t stream) {
  if (r_planes < 1 || w < 1 || n_q < 1 || n_rows < 1 || qpb < 1 || qpb > TQ ||
      n_splits < 1 || combo < F32 || combo > I8_BF16 ||
      (id_bytes != 4 && !(ring && id_bytes == 2 && (n_rows + w - 1) / w <= 65535)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + qpb - 1) / qpb, (w + TC - 1) / TC, n_splits);
  const long long planes = (long long)qpb * r_planes * TC * (4 + id_bytes);
  if (ring) {
    const bool fp32 = combo == F32;
    const int row_bytes = fp32 ? 4 * d : combo == I8_BF16 ? d : 2 * d;
    if (row_bytes % (fp32 ? 16 : 32) != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int chunk_bytes = std::min(RING_CHUNK, row_bytes);
    const int n_dc = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    // the ring, then the planes
    const long long smem = class_ring_bytes(fp32 ? 4 : 2, !fp32, d, chunk_bytes) + planes;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (n_splits == 1) {  // the kernel's partials are the outputs
      part_s = out_s;
      part_i = out_i;
      part_rej = out_rej;
    }
#define LAUNCH_TOPR_RING(MODE, IDB)                                          \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, topr_ring_kernel<MODE, IDB>, (int)smem); \
    if (e != cudaSuccess) return (int)e;                                     \
    topr_ring_kernel<MODE, IDB><<<grid, THREADS, (int)smem, stream>>>(       \
        q, (const unsigned char*)x, sqn, scales, n_q, qpb, d, n_rows,        \
        n_valid, metric_sq, w, r_planes, tiles_per_split, n_dc, chunk_bytes, \
        part_s, part_i, part_rej);                                           \
  }
    const int mode = fp32 ? 2 : combo == I8_BF16 ? 1 : 0;
    if (id_bytes == 2) {
      if (mode == 2) LAUNCH_TOPR_RING(2, 2) else if (mode == 1) LAUNCH_TOPR_RING(1, 2) else LAUNCH_TOPR_RING(0, 2)
    } else {
      if (mode == 2) LAUNCH_TOPR_RING(2, 4) else if (mode == 1) LAUNCH_TOPR_RING(1, 4) else LAUNCH_TOPR_RING(0, 4)
    }
#undef LAUNCH_TOPR_RING
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return (int)err;
  } else {
    // beside score_tile's stage in static shared memory
    if (planes + (long long)sizeof(Stage<false>) > MAX_SMEM) return (int)cudaErrorInvalidValue;
    const int smem = (int)planes;
#define LAUNCH_TOPR(QT, XT)                                                  \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, topr_scan_kernel<QT, XT>, smem);     \
    if (e != cudaSuccess) return (int)e;                                     \
    topr_scan_kernel<QT, XT><<<grid, THREADS, smem, stream>>>(               \
        (const QT*)q, (const XT*)x, sqn, scales, n_q, d, n_rows, n_valid,    \
        metric_sq, w, r_planes, qpb, tiles_per_split, part_s, part_i,        \
        part_rej);                                                           \
  }
    switch (combo) {
      case F32: LAUNCH_TOPR(float, float) break;
      case BF16: LAUNCH_TOPR(__nv_bfloat16, __nv_bfloat16) break;
      default: LAUNCH_TOPR(__nv_bfloat16, int8_t) break;
    }
#undef LAUNCH_TOPR
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_topr_merge(part_s, part_i, part_rej, n_q, n_splits, w,
                                r_planes, out_s, out_i, out_rej, stream);
}

}  // extern "C"
