// Fused score tile + top-k selection for exact flat search on Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernel paths of cuvs_rag_tpu/ops/pallas_flat.py:
//   K1  flat_topk_pallas(mode="exact")   -> exact_scan_kernel + merge_partials_kernel
//   K2  flat_topk_pallas(mode="sketch")  -> sketch_scan_kernel + sketch_merge_kernel
//   K3  flat_topk_large                  -> topr_scan_kernel + topr_merge_kernel
//
// The TPU walked the corpus axis in order and kept its running selection in
// VMEM from one grid step to the next. Hopper blocks run in parallel and in no
// order, so every kernel here is two passes: blocks over (query tile x corpus
// split) emit partial results, and a merge pass reduces them per query.
//
// What bounds them on the H100: at the main path's batch (16 queries) each
// corpus byte feeds only ~16 multiply-adds, so the floor is reading the
// corpus from HBM once (4.8 GB of bf16 at 6.29M x 384, 1.4 ms). The design
// keeps everything else off HBM: the score tile lives in registers, the pad
// and tombstone penalties ride the one epilogue FMA (no mask passes), the
// running selections stay in registers (K1/K2) or shared memory (K3), and
// partials are small. This first version multiplies on the CUDA cores in
// fp32 (exact products of bf16/int8 operands, fp32 accumulation, no TF32)
// with 6 shared-memory loads per 8 FMAs, which bounds it instead: ~16% of
// the read floor. Tensor cores (mma/wgmma), 16-byte loads and TMA
// pipelining are later work.
//
// Plain C ABI (built with nvcc, loaded with ctypes): every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "topk_common.cuh"

namespace {

constexpr int TQ = 16;            // queries per block
constexpr int TC = 128;           // corpus rows per tile
constexpr int DK = 32;            // depth chunk staged in shared memory
constexpr int THREADS = 256;      // 8 warps
constexpr int QPT = TQ / 8;       // queries per thread (warp w: w, w + 8)
constexpr int CPT = TC / 32;      // rows per thread (lane l: l + 32 j)
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
        v = (mult * qs) * ((float)acc[i][j] * scale) - csq;
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
// the running top-k of queries w and w + 8 in registers; the score tile it
// selects from is already in its own registers. Partials: (n_q, S, k).
template <typename QT, typename XT>
__global__ void __launch_bounds__(THREADS) exact_scan_kernel(
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
constexpr int PLANE_SMEM = 88 * 1024;  // leaves room for two blocks per SM

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

// One thread per (query, class): each class keeps the R best of the union of
// the splits' planes, and its rej becomes the max of the splits' rej values
// and of every value the merge displaced — so max(rej) < tau still proves
// the collected top-k exact. Each split's planes are sorted, so the first
// value that cannot enter ends that split (it is the best of the rest).
// Output planes (n_q, R, W) with the validity rule applied; rej (n_q, W).
__global__ void topr_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i,
                                  const float* __restrict__ part_rej, int n_q,
                                  int n_splits, int w, int r_planes,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i,
                                  float* __restrict__ out_rej) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n_q * w) return;
  const int qq = (int)(e / w), c = (int)(e % w);
  const int plane_stride = w;
  float* ps = out_s + (long long)qq * r_planes * w + c;
  int* pi = out_i + (long long)qq * r_planes * w + c;
  for (int r = 0; r < r_planes; ++r) {
    ps[r * plane_stride] = neg_inf();
    pi[r * plane_stride] = -1;
  }
  float last = neg_inf(), rej = neg_inf();
  for (int s = 0; s < n_splits; ++s) {
    rej = fmaxf(rej, part_rej[((long long)s * n_q + qq) * w + c]);
    const long long o = ((long long)s * n_q + qq) * r_planes * w + c;
    for (int r = 0; r < r_planes; ++r) {
      const float v = part_s[o + r * plane_stride];
      if (!(v > last)) {
        rej = fmaxf(rej, v);
        break;
      }
      rej = fmaxf(rej, chain_insert(ps, pi, plane_stride, r_planes, v,
                                    part_i[o + r * plane_stride], last));
    }
  }
  for (int r = 0; r < r_planes; ++r) {
    if (!(ps[r * plane_stride] > VALID_MIN)) {
      ps[r * plane_stride] = neg_inf();
      pi[r * plane_stride] = -1;
    }
  }
  out_rej[e] = rej;
}

// Storage/query type combinations: 0 fp32/fp32, 1 bf16/bf16, 2 bf16 queries
// over int8 rows (bf16 scoring), 3 int8 x int8 (sketch only).
enum Combo { F32 = 0, BF16 = 1, I8_BF16 = 2, I8_I8 = 3 };

}  // namespace

extern "C" {

int flat_exact_topk(int combo, const void* q, const void* x, const float* sqn,
                    const float* scales, int n_q, int d, long long n_rows,
                    int n_valid, int metric_sq, int k, long long rows_per_split,
                    int n_splits, float* part_s, int* part_i, float* out_s,
                    int* out_i, cudaStream_t stream) {
  if (k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + TQ - 1) / TQ, n_splits);
#define LAUNCH_EXACT(QT, XT)                                                 \
  exact_scan_kernel<QT, XT><<<grid, THREADS, 0, stream>>>(                   \
      (const QT*)q, (const XT*)x, sqn, scales, n_q, d, n_rows, n_valid,      \
      metric_sq, k, rows_per_split, part_s, part_i)
  switch (combo) {
    case F32: LAUNCH_EXACT(float, float); break;
    case BF16: LAUNCH_EXACT(__nv_bfloat16, __nv_bfloat16); break;
    case I8_BF16: LAUNCH_EXACT(__nv_bfloat16, int8_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_EXACT
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 8;
  merge_partials_kernel<<<(n_q + warps - 1) / warps, 32 * warps, 0, stream>>>(
      part_s, part_i, n_q, n_splits, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int flat_sketch_topk(int combo, const void* q, const void* x, const float* sqn,
                     const float* scales, const float* qscales, int n_q, int d,
                     long long n_rows, int n_valid, int metric_sq, int w, int k,
                     long long tiles_per_split, int n_splits, float* part_s,
                     int* part_i, float* out_s, int* out_i, cudaStream_t stream) {
  if (k < 1 || k > 32 || w < 1 || w > MAX_SKETCH_W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_q + TQ - 1) / TQ, (w + TC - 1) / TC, n_splits);
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sketch_merge_kernel<<<n_q, THREADS, 0, stream>>>(part_s, part_i, n_q,
                                                   n_splits, w, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int flat_topr(int combo, const void* q, const void* x, const float* sqn,
              const float* scales, int n_q, int d, long long n_rows,
              int n_valid, int metric_sq, int w, int r_planes,
              long long tiles_per_split, int n_splits, float* part_s,
              int* part_i, float* part_rej, float* out_s, int* out_i,
              float* out_rej, cudaStream_t stream) {
  if (r_planes < 1 || w < 1) return (int)cudaErrorInvalidValue;
  // queries per block: as many as the plane budget holds, at most TQ
  const int qpb = std::min(std::min(TQ, n_q), PLANE_SMEM / (r_planes * TC * 8));
  if (qpb < 1) return (int)cudaErrorInvalidValue;
  const int smem = 2 * qpb * r_planes * TC * 4;
  const dim3 grid((n_q + qpb - 1) / qpb, (w + TC - 1) / TC, n_splits);
#define LAUNCH_TOPR(QT, XT)                                                  \
  cudaFuncSetAttribute(topr_scan_kernel<QT, XT>,                             \
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   \
  topr_scan_kernel<QT, XT><<<grid, THREADS, smem, stream>>>(                 \
      (const QT*)q, (const XT*)x, sqn, scales, n_q, d, n_rows, n_valid,      \
      metric_sq, w, r_planes, qpb, tiles_per_split, part_s, part_i, part_rej)
  switch (combo) {
    case F32: LAUNCH_TOPR(float, float); break;
    case BF16: LAUNCH_TOPR(__nv_bfloat16, __nv_bfloat16); break;
    case I8_BF16: LAUNCH_TOPR(__nv_bfloat16, int8_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_TOPR
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)n_q * w;
  topr_merge_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(part_s, part_i, part_rej, n_q, n_splits, w,
                                r_planes, out_s, out_i, out_rej);
  return (int)cudaGetLastError();
}

}  // extern "C"
