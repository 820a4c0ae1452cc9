// Probed sorted-CSR window scans for IVF-Flat on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of cuvs_rag_tpu/ops/pallas_ivf.py:
//   K4  ivf_scan_pallas        (k <= 32)  -> ivf_scan_kernel + merge_partials_kernel
//   K5  ivf_scan_pallas_large  (k > 32)   -> ivf_topr_kernel (certified top-R)
//
// Both score what `_window_scores` scores over each query's probed windows
// [offset, offset + count) of the sorted layout, larger is better:
//   sqeuclidean   2 (q.w) - sqn            (+ coarse, int8)
//   inner product (q.w) - max(sqn - 1e29, 0)  (+ coarse, int8)
// where q.w is an fp32 sum of exact products (never TF32) and, for int8
// residual storage, q.w is first multiplied by the row's scale and the
// probe's coarse inner product is added. Deleted and filtered-out rows are
// masked only through their sqnorm slot, as on the TPU. Outputs are
// positions in the sorted layout; the caller maps them to corpus ids.
//
// The TPU walked (8-query tile x probe x sub-window) in order, scored all
// 8 queries against each DMA'd window and masked 7 away, and skipped dead
// sub-windows at 512-row granularity. Here a window's count is the loop
// bound, so no row past it is ever read, and every block scores one query.
//
// What bounds them on the H100: the bytes of the probed windows (16
// queries x 20 probes x <= 2,048 rows x 384 x 2 B <= 0.5 GB per batch at
// the main path's shape, about half that at the usual fill). A warp scores
// 32 consecutive rows, 4 at a time, its lanes reading 32 consecutive
// elements of each row (coalesced) against the query held in shared memory
// as fp32, then reduces each row by shuffles. This first version reads 2-
// or 4-byte elements per lane; 16-byte loads and cp.async/TMA pipelining
// are later work, as is L2 reuse across queries probing the same list.
//
// Plain C ABI (built with nvcc, loaded with ctypes): every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int CHUNK = 256;       // window rows per K4 block (8 warps x 32)
constexpr int K4_THREADS = 256;
constexpr int CLASSES = 128;     // sub-window columns per K5 block
constexpr int K5_THREADS = 128;  // one thread per class
constexpr int RB = 4;            // rows a warp scores at once
constexpr int MAX_SMEM = 227 * 1024;

// Scores of the n_rows (<= 32) consecutive layout rows [row0, row0 + n_rows)
// against the query `qs` (fp32, shared memory); lane l returns row row0 + l,
// -inf for lanes past n_rows. Rows past n_rows are never read.
template <typename XT>
__device__ __forceinline__ float warp_rows_score(
    const float* __restrict__ qs, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales, int d,
    long long row0, int n_rows, int metric_sq, int scaled, float coarse,
    int lane) {
  float mine = neg_inf();
  for (int r0 = 0; r0 < n_rows; r0 += RB) {
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float qv = qs[c];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (r0 + i < n_rows)
          acc[i] = fmaf(qv, load_f(x + (row0 + r0 + i) * (long long)d + c), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float v = acc[i];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (lane == r0 + i && r0 + i < n_rows) {
        const long long row = row0 + r0 + i;
        const float aux0 = sqn[row];
        const float ip = scaled ? __fmul_rn(v, scales[row]) : v;
        const float del = fmaxf(aux0 - DELETED_THRESHOLD, 0.0f);
        if (metric_sq)
          mine = scaled ? (2.0f * ip - aux0) + coarse : 2.0f * ip - aux0;
        else
          mine = scaled ? (ip + coarse) - del : ip - del;
      }
    }
  }
  return mine;
}

template <typename QT>
__device__ __forceinline__ void load_query(float* qs, const QT* q, int qq, int d) {
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    qs[c] = load_f(q + (long long)qq * d + c);
}

// ---------------------------------------------------------------- K4 -----
// grid (n_q, n_probe, n_chunks): block (q, p, c) scores window columns
// [c * CHUNK, min(count, (c + 1) * CHUNK)) of query q's probe p; warp w takes
// 32 of them and keeps its top-k in its lanes, warp 0 merges the 8 warps'.
// Partials (n_q, n_probe * n_chunks, k); a chunk past the count writes
// -inf / -1 without reading anything.
template <typename QT, typename XT>
__global__ void __launch_bounds__(K4_THREADS) ivf_scan_kernel(
    const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const int* __restrict__ offs, const int* __restrict__ cnts,
    const float* __restrict__ coarse, int n_probe, int d, int window,
    int metric_sq, int scaled, int k, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  extern __shared__ float qs[];
  __shared__ float ws[K4_THREADS / 32][32];
  __shared__ int wi[K4_THREADS / 32][32];
  const int qq = blockIdx.x, chunk = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long pidx = (long long)qq * n_probe + blockIdx.y;
  const long long off = offs[pidx];
  const int cnt = min(cnts[pidx], window);
  const int c0 = chunk * CHUNK;
  const long long o = (pidx * gridDim.z + chunk) * k;
  if (c0 >= cnt) {  // uniform across the block
    if (threadIdx.x < k) {
      part_s[o + threadIdx.x] = neg_inf();
      part_i[o + threadIdx.x] = -1;
    }
    return;
  }
  load_query(qs, q, qq, d);
  __syncthreads();
  const int w0 = c0 + warp * 32;  // this warp's first window column
  float v = neg_inf();
  if (w0 < cnt)
    v = warp_rows_score(qs, x, sqn, scales, d, off + w0, min(32, cnt - w0),
                        metric_sq, scaled, coarse[pidx], lane);
  WarpTopK top;
  top.init();
  top.offer(v, (int)(off + w0 + lane), k, lane);
  if (lane < k) {
    ws[warp][lane] = top.s;
    wi[warp][lane] = top.id;
  }
  __syncthreads();
  if (warp != 0) return;
  WarpTopK best;
  best.init();
  for (int w = 0; w < K4_THREADS / 32; ++w)
    best.offer(lane < k ? ws[w][lane] : neg_inf(), lane < k ? wi[w][lane] : -1,
               k, lane);
  if (lane < k) {
    part_s[o + lane] = best.s;
    part_i[o + lane] = best.id;
  }
}

// ---------------------------------------------------------------- K5 -----
// A class is (query, column c of the sub-window): row off + u * subwin + c
// of every probed sub-window u. grid (n_q, ceil(subwin / CLASSES)): block
// (q, b) owns classes [b * CLASSES, b * CLASSES + CLASSES) of query q and
// walks all of its probes and sub-windows, reading its 128 contiguous rows
// of each, so each class lives in exactly one block and the certificate of
// `_topr_kernel` carries over with no cross-block merge. Each class keeps
// its R best (score, position) in the block's shared memory through the
// insertion chain, and `rej`, the best value it ever displaced (= its
// (R+1)-th best). Plane R-1 stays in a register and the chain runs only for
// a candidate that beats it. Dead sub-windows (past the count) are skipped,
// as on the TPU. Outputs: planes (n_q, R, subwin) with the validity rule
// applied, rej (n_q, subwin).
template <typename QT, typename XT>
__global__ void __launch_bounds__(K5_THREADS) ivf_topr_kernel(
    const QT* __restrict__ q, const XT* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const int* __restrict__ offs, const int* __restrict__ cnts,
    const float* __restrict__ coarse, int n_probe, int d, int window,
    int n_sub, int metric_sq, int scaled, int r_planes,
    float* __restrict__ planes_s, int* __restrict__ planes_i,
    float* __restrict__ out_rej) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ps = smem + d;
  int* pi = reinterpret_cast<int*>(ps + r_planes * CLASSES);
  const int qq = blockIdx.x, c0 = blockIdx.y * CLASSES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = threadIdx.x, col = c0 + cl;
  const int subwin = window / n_sub;
  for (int e = threadIdx.x; e < r_planes * CLASSES; e += blockDim.x) {
    ps[e] = neg_inf();
    pi[e] = -1;
  }
  load_query(qs, q, qq, d);
  __syncthreads();
  // from here on a thread touches only its own class's planes
  const int w0 = c0 + warp * 32;  // class of this warp's lane 0
  float last = neg_inf(), rej = neg_inf();
  for (int p = 0; p < n_probe; ++p) {
    const long long pidx = (long long)qq * n_probe + p;
    const long long off = offs[pidx];
    const int cnt = min(cnts[pidx], window);
    const float cf = coarse[pidx];
    for (int u = 0; u < n_sub; ++u) {
      const int base = u * subwin;
      if (base >= cnt) break;  // dead sub-window
      const int n_live = min(32, min(subwin - w0, cnt - base - w0));
      float v = neg_inf();
      if (n_live > 0)
        v = warp_rows_score(qs, x, sqn, scales, d, off + base + w0, n_live,
                            metric_sq, scaled, cf, lane);
      if (col < subwin && v > last)
        v = chain_insert(ps + cl, pi + cl, CLASSES, r_planes, v,
                         (int)(off + base + col), last);
      rej = fmaxf(rej, v);
    }
  }
  if (col >= subwin) return;
  for (int r = 0; r < r_planes; ++r) {
    const float s = ps[r * CLASSES + cl];
    const bool ok = s > VALID_MIN;
    const long long o = ((long long)qq * r_planes + r) * subwin + col;
    planes_s[o] = ok ? s : neg_inf();
    planes_i[o] = ok ? pi[r * CLASSES + cl] : -1;
  }
  out_rej[(long long)qq * subwin + col] = rej;
}

// Storage/query type combinations: 0 fp32/fp32, 1 bf16/bf16, 2 bf16
// queries over int8 residual rows.
enum Combo { F32 = 0, BF16 = 1, I8_BF16 = 2 };

}  // namespace

extern "C" {

int ivf_scan_topk(int combo, const void* q, const void* x, const float* sqn,
                  const float* scales, const int* offs, const int* cnts,
                  const float* coarse, int n_q, int n_probe, int d, int window,
                  int metric_sq, int scaled, int k, int n_chunks,
                  float* part_s, int* part_i, float* out_s, int* out_i,
                  cudaStream_t stream) {
  const int smem = d * (int)sizeof(float);
  if (k < 1 || k > 32 || n_q < 1 || n_probe < 1 || n_probe > 65535 ||
      n_chunks < 1 || n_chunks > 65535 ||
      (long long)n_chunks * CHUNK < window || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_q, n_probe, n_chunks);
#define LAUNCH_SCAN(QT, XT)                                                  \
  cudaFuncSetAttribute(ivf_scan_kernel<QT, XT>,                              \
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   \
  ivf_scan_kernel<QT, XT><<<grid, K4_THREADS, smem, stream>>>(               \
      (const QT*)q, (const XT*)x, sqn, scales, offs, cnts, coarse, n_probe,  \
      d, window, metric_sq, scaled, k, part_s, part_i)
  switch (combo) {
    case F32: LAUNCH_SCAN(float, float); break;
    case BF16: LAUNCH_SCAN(__nv_bfloat16, __nv_bfloat16); break;
    case I8_BF16: LAUNCH_SCAN(__nv_bfloat16, int8_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_SCAN
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 8;
  merge_partials_kernel<<<(n_q + warps - 1) / warps, 32 * warps, 0, stream>>>(
      part_s, part_i, n_q, n_probe * n_chunks, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int ivf_scan_topr(int combo, const void* q, const void* x, const float* sqn,
                  const float* scales, const int* offs, const int* cnts,
                  const float* coarse, int n_q, int n_probe, int d, int window,
                  int n_sub, int metric_sq, int scaled, int r_planes,
                  float* planes_s, int* planes_i, float* out_rej,
                  cudaStream_t stream) {
  const long long smem = (long long)d * 4 + (long long)r_planes * CLASSES * 8;
  if (n_q < 1 || n_probe < 1 || n_sub < 1 || window % n_sub != 0 ||
      r_planes < 1 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int subwin = window / n_sub;
  const dim3 grid(n_q, (subwin + CLASSES - 1) / CLASSES);
#define LAUNCH_TOPR(QT, XT)                                                  \
  cudaFuncSetAttribute(ivf_topr_kernel<QT, XT>,                              \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                       (int)smem);                                           \
  ivf_topr_kernel<QT, XT><<<grid, K5_THREADS, (int)smem, stream>>>(          \
      (const QT*)q, (const XT*)x, sqn, scales, offs, cnts, coarse, n_probe,  \
      d, window, n_sub, metric_sq, scaled, r_planes, planes_s, planes_i,     \
      out_rej)
  switch (combo) {
    case F32: LAUNCH_TOPR(float, float); break;
    case BF16: LAUNCH_TOPR(__nv_bfloat16, __nv_bfloat16); break;
    case I8_BF16: LAUNCH_TOPR(__nv_bfloat16, int8_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_TOPR
  return (int)cudaGetLastError();
}

}  // extern "C"
