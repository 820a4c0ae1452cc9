// Probed sorted-CSR window scans for IVF-Flat on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of cuvs_rag_tpu/ops/pallas_ivf.py:
//   K4  ivf_scan_pallas        (k <= 32)  -> ivf_ring_kernel (or ivf_scan_kernel)
//                                            + merge_partials_kernel
//   K5  ivf_scan_pallas_large  (k > 32)   -> ivf_topr_ring_kernel (or
//                                            ivf_topr_kernel), certified top-R,
//                                            + topr_merge_kernel (topk_common.cuh)
//
// Both score what `_window_scores` scores over each query's probed windows
// [offset, offset + count) of the sorted layout, larger is better:
//   sqeuclidean   2 (q.w) - sqn            (+ coarse, int8)
//   inner product (q.w) - max(sqn - 1e29, 0)  (+ coarse, int8)
// where q.w is an fp32 sum of exact products (never TF32) and, for int8
// residual storage, q.w is first multiplied by the row's scale and the
// probe's coarse inner product is added (window_score). Deleted and
// filtered-out rows are masked only through their sqnorm slot, as on the
// TPU. Outputs are positions in the sorted layout; the caller maps them to
// corpus ids.
//
// The TPU walked (8-query tile x probe x sub-window) in order, scored all
// 8 queries against each DMA'd window and masked 7 away, and skipped dead
// sub-windows at 512-row granularity. Here a window's count is the loop
// bound, so no row past it is ever read, and every block scores one query.
//
// What bounds them on the H100: the bytes of the probed windows (16
// queries x 20 probes x <= 2,048 rows x 384 x 2 B <= 0.5 GB per batch at
// the main path's shape, about half that at the usual fill). A window is
// consecutive rows of the sorted layout, which is what flat_topk.cu's copy
// ring streams, so K4's main route (ops/ivf_kernels.ivf_route "ring": rows
// of a multiple of 16 bytes) is that ring: block (query, probe, piece)
// streams rows [piece start, min(count, window, piece end)) of the window
// by 16-byte cp.async copies into three stages of 128 rows x 128 bytes,
// and two threads a row multiply each stage's row with the query (fp32 in
// shared memory) on the CUDA cores, in fp32, half a chunk each; a warp
// keeps the top-k of its 16 rows of every tile. Other depths keep
// ivf_scan_kernel, which reads 2- or 4-byte elements a lane, 32 rows a
// warp, 4 at a time, each reduced by shuffles (1.5 TB/s at the main path's
// shape).
//
// K5's class is a column of the window, so a 128-class chunk of one probed
// window is 128 consecutive layout rows: one tile of the same ring. Its
// ring route (ops/ivf_kernels.k5_plan) streams one tile a probe through K4's
// ring and product, keeps each class's R best in shared memory through K3's
// plane selection, and splits the probes across blocks so that even one
// query fills the card (16 chunks x 10 splits at window 2,048 and 20
// probes, where one block a chunk gave 16 blocks on 132 SMs); K3's merge
// folds the splits together. Other depths keep ivf_topr_kernel on the warp
// loop, one block a (query, chunk) walking every probe.
//
// Plain C ABI (built with nvcc, loaded with ctypes): every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

#include "ring.cuh"
#include "topk_common.cuh"

namespace {

constexpr int CHUNK = 256;       // window rows per ivf_scan_kernel block (8 warps x 32)
constexpr int K4_THREADS = 256;
constexpr int CLASSES = 128;     // sub-window columns per K5 block
constexpr int K5_THREADS = 128;  // one thread per class
constexpr int RB = 4;            // rows a warp scores at once
// K4's ring: K1's sizes (flat_topk.cu RING_STAGES, RING_CHUNK)
constexpr int IVF_STAGES = 3;
constexpr int IVF_CHUNK = 128;

// A window row's score from its dot product with the query, its sqnorm
// slot and its scale, exactly as `_window_scores_plain` forms it: the row
// scale by a rounded product and the coarse term added for int8 residual
// rows, the deletion penalty for inner product.
__device__ __forceinline__ float window_score(float dot, float aux0, float scale,
                                              int metric_sq, int scaled,
                                              float coarse) {
  const float ip = scaled ? __fmul_rn(dot, scale) : dot;
  const float del = fmaxf(aux0 - DELETED_THRESHOLD, 0.0f);
  if (metric_sq) return scaled ? (2.0f * ip - aux0) + coarse : 2.0f * ip - aux0;
  return scaled ? (ip + coarse) - del : ip - del;
}

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
        mine = window_score(v, sqn[row], scales[row], metric_sq, scaled, coarse);
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

// K4's and K5's product of one ring chunk: the stage row `row` (`width`
// bytes from byte `byte0` of the layout row) times the query `s_q` (fp32,
// shared memory), added into `acc` in fp32, by one of the row's two threads:
// `half` 0 takes the first half of the chunk's 16-byte pieces, 1 the second
// (conflict-free at the ring's pitch). MODE 0: bf16 rows; 1: int8 rows; 2:
// fp32 rows.
template <int MODE>
__device__ __forceinline__ float row_chunk_dot(const unsigned char* row,
                                               const float* s_q, int byte0,
                                               int width, int half, float acc) {
  constexpr int ESIZE = MODE == 2 ? 4 : MODE == 0 ? 2 : 1;  // bytes a row value
  const int pieces = width >> 4, mid = (pieces + 1) >> 1;
  const int p1 = half ? pieces : mid;
  for (int p = half ? mid : 0; p < p1; ++p) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + p * 16);
    const float* qv = s_q + (byte0 + p * 16) / ESIZE;
    if constexpr (MODE == 2) {
      const float4 a = *reinterpret_cast<const float4*>(qv);
      acc = fmaf(a.x, __uint_as_float(v.x), acc);
      acc = fmaf(a.y, __uint_as_float(v.y), acc);
      acc = fmaf(a.z, __uint_as_float(v.z), acc);
      acc = fmaf(a.w, __uint_as_float(v.w), acc);
    } else {
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      if constexpr (MODE == 0) {  // two bf16 a word
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(qv + 4 * h);
          acc = fmaf(a.x, __uint_as_float(words[2 * h] << 16), acc);
          acc = fmaf(a.y, __uint_as_float(words[2 * h] & 0xffff0000u), acc);
          acc = fmaf(a.z, __uint_as_float(words[2 * h + 1] << 16), acc);
          acc = fmaf(a.w, __uint_as_float(words[2 * h + 1] & 0xffff0000u), acc);
        }
      } else {  // four int8 a word
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(qv + 4 * h);
          const uint32_t u = words[h] ^ 0x80808080u;
          acc = fmaf(a.x, int8_lane(u, 0), acc);
          acc = fmaf(a.y, int8_lane(u, 1), acc);
          acc = fmaf(a.z, int8_lane(u, 2), acc);
          acc = fmaf(a.w, int8_lane(u, 3), acc);
        }
      }
    }
  }
  return acc;
}

// K4 on the ring. grid (n_q, n_probe, n_pieces): block (q, p, c) streams
// rows [c * piece, min(count, window, (c + 1) * piece)) of query q's probe p
// window, tiles of TC consecutive layout rows from off + c * piece, through
// a ring of IVF_STAGES stages (rows at or past the count are zero-filled,
// never read). Thread t takes row t / 2 of each tile and half of each
// chunk's 16-byte pieces (the first or the second half: conflict-free at
// the ring's pitch), multiplies it with the query held as fp32 in shared
// memory and adds in fp32; at a tile's end the two halves add up, and warp
// w offers its 16 rows to its warp-held top-k. Warp 0 merges the 8 warps'.
// MODE 0: bf16 rows; 1: int8 rows (bf16 queries); 2: fp32 rows. (K1's
// tensor-core step with the query as the one live row of M = 16 was
// measured slower at every piece size: PERF.md.) Partials (n_q, n_probe *
// n_pieces, k); a piece past the count writes -inf / -1 without reading
// anything.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) ivf_ring_kernel(
    const void* __restrict__ q, const unsigned char* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const int* __restrict__ offs, const int* __restrict__ cnts,
    const float* __restrict__ coarse, int n_probe, int d, int window,
    int metric_sq, int scaled, int k, int piece, int n_dc, int chunk_bytes,
    float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ float ws[THREADS / 32][32];
  __shared__ int wi[THREADS / 32][32];
  constexpr int ESIZE = MODE == 2 ? 4 : MODE == 0 ? 2 : 1;  // bytes a row value
  const int row_bytes = ESIZE * d;
  const int pitch = chunk_bytes + 16;
  const int stage_bytes = TC * pitch;
  float* s_q = reinterpret_cast<float*>(ring_smem);  // the query, fp32 [d]
  unsigned char* s_ring = ring_smem + (4 * d + 127) / 128 * 128;
  const uint32_t ring_a = smem_u32(s_ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qq = blockIdx.x, pc = blockIdx.z;
  const long long pidx = (long long)qq * n_probe + blockIdx.y;
  const long long o = (pidx * gridDim.z + pc) * k;
  const int cnt = min(cnts[pidx], window);
  const int r0 = pc * piece;
  if (r0 >= cnt) {  // uniform across the block
    if (tid < k) {
      part_s[o + tid] = neg_inf();
      part_i[o + tid] = -1;
    }
    return;
  }
  const int n_rows = min(piece, cnt - r0);
  const long long first = offs[pidx] + r0;
  const int n_chunks = (n_rows + TC - 1) / TC * n_dc;

  RingLoader loader;
  loader.init(chunk_bytes);
  int ld_tile = 0, ld_dc = 0;  // the next chunk to load
  auto load_next = [&](int chunk) {
    if (chunk < n_chunks) {
      const int byte0 = ld_dc * chunk_bytes;
      loader.load(ring_a + (chunk % IVF_STAGES) * stage_bytes, pitch, x, row_bytes,
                  first + ld_tile * TC, min(TC, n_rows - ld_tile * TC), byte0,
                  min(chunk_bytes, row_bytes - byte0));
      if (++ld_dc == n_dc) {
        ld_dc = 0;
        ++ld_tile;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");  // one group a call
  };
#pragma unroll
  for (int c = 0; c < IVF_STAGES - 1; ++c) load_next(c);
  using QT = typename std::conditional<MODE == 2, float, __nv_bfloat16>::type;
  for (int c = tid; c < d; c += THREADS)
    s_q[c] = load_f(static_cast<const QT*>(q) + (long long)qq * d + c);

  const float cf = coarse[pidx];
  const int r = tid >> 1, half = tid & 1;  // this thread's row of a tile
  float aux0 = 0.f, rscale = 1.f;          // its sqnorm slot and scale
  float acc = 0.f;
  WarpTopK top;
  top.init();
  int tile = 0, dc = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    asm volatile("cp.async.wait_group %0;" ::"n"(IVF_STAGES - 2) : "memory");
    __syncthreads();  // the chunk has landed; every warp is done with the one before
    load_next(chunk + IVF_STAGES - 1);

    const int row_in = tile * TC + r;  // this thread's row of the piece
    if (dc == 0 && row_in < n_rows) {
      // loaded before the tile's products, used after them
      aux0 = sqn[first + row_in];
      rscale = scales[first + row_in];
    }
    const int byte0 = dc * chunk_bytes;
    acc = row_chunk_dot<MODE>(
        s_ring + (chunk % IVF_STAGES) * stage_bytes + r * pitch, s_q, byte0,
        min(chunk_bytes, row_bytes - byte0), half, acc);
    if (++dc < n_dc) continue;
    dc = 0;

    const float dot = acc + __shfl_xor_sync(FULL, acc, 1);  // the same sum in both lanes
    acc = 0.f;
    float v = neg_inf();
    if (half == 0 && row_in < n_rows)
      v = window_score(dot, aux0, rscale, metric_sq, scaled, cf);
    top.offer(v, (int)(first + row_in), k, lane);
    ++tile;
  }
  if (lane < k) {
    ws[warp][lane] = top.s;
    wi[warp][lane] = top.id;
  }
  __syncthreads();
  if (warp != 0) return;
  WarpTopK best;
  best.init();
  for (int wp = 0; wp < THREADS / 32; ++wp)
    best.offer(lane < k ? ws[wp][lane] : neg_inf(), lane < k ? wi[wp][lane] : -1,
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

// K5 on K4's ring (ops/ivf_kernels.k5_plan "ring": rows of a multiple of 16
// bytes). A class is (query, column c of the sub-window); a 128-class chunk
// [c0, c0 + 128) of one probed sub-window is 128 consecutive layout rows,
// one tile of the ring. The tiles of a query are t = probe * n_sub + u for
// each probe and sub-window u, rows off + u * subwin + c0 + [0, live) with
// live = min(128, subwin - c0, count - u * subwin - c0); a tile with no live
// row is skipped and issues no copy, and rows at or past the count are
// zero-filled and never read. grid (n_q, ceil(subwin / TC), n_splits):
// block (q, b, s) streams tiles [s * tiles_per_split, (s + 1) *
// tiles_per_split) of query q's chunk b through IVF_STAGES stages, and two
// threads a row multiply as ivf_ring_kernel does. The even thread of row r
// keeps class c0 + r: plane R-1 (`last`) and rej in registers, the planes in
// shared memory behind the ring ([R][TC] scores, then [R][TC] positions),
// and runs the chain only for a score that beats `last`. Partials (S, n_q,
// R, subwin) and (S, n_q, subwin), merged by topr_merge_kernel; with one
// split they are the outputs, with the validity rule applied here.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) ivf_topr_ring_kernel(
    const void* __restrict__ q, const unsigned char* __restrict__ x,
    const float* __restrict__ sqn, const float* __restrict__ scales,
    const int* __restrict__ offs, const int* __restrict__ cnts,
    const float* __restrict__ coarse, int n_probe, int d, int window,
    int n_sub, int metric_sq, int scaled, int r_planes, int tiles_per_split,
    int n_dc, int chunk_bytes, float* __restrict__ part_s,
    int* __restrict__ part_i, float* __restrict__ part_rej) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  constexpr int ESIZE = MODE == 2 ? 4 : MODE == 0 ? 2 : 1;  // bytes a row value
  const int row_bytes = ESIZE * d;
  const int pitch = chunk_bytes + 16;
  const int stage_bytes = TC * pitch;
  float* s_q = reinterpret_cast<float*>(ring_smem);  // the query, fp32 [d]
  unsigned char* s_ring = ring_smem + (4 * d + 127) / 128 * 128;
  float* ps = reinterpret_cast<float*>(s_ring + IVF_STAGES * stage_bytes);  // [R][TC]
  int* pi = reinterpret_cast<int*>(ps + r_planes * TC);                      // [R][TC]
  const uint32_t ring_a = smem_u32(s_ring);

  const int tid = threadIdx.x;
  const int qq = blockIdx.x, n_q = gridDim.x, c0 = blockIdx.y * TC, split = blockIdx.z;
  const int subwin = window / n_sub;
  const int n_class = min(TC, subwin - c0);
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_probe * n_sub, t0 + tiles_per_split);
  const int* q_offs = offs + (long long)qq * n_probe;
  const int* q_cnts = cnts + (long long)qq * n_probe;
  // live rows of tile t (<= 0: none) and its first layout row
  auto tile_live = [&](int t) {
    const int p = t / n_sub;
    return min(n_class, min(q_cnts[p], window) - (t - p * n_sub) * subwin - c0);
  };
  auto tile_first = [&](int t) {
    const int p = t / n_sub;
    return (long long)q_offs[p] + (t - p * n_sub) * subwin + c0;
  };
  int n_tiles = 0;  // the live ones
  for (int t = t0; t < t1; ++t) n_tiles += tile_live(t) > 0;
  const int n_chunks = n_tiles * n_dc;

  RingLoader loader;
  loader.init(chunk_bytes);
  int ld_t = t0 - 1, ld_dc = 0, ld_live = 0;  // the tile of the next chunk to load
  long long ld_first = 0;
  auto load_next = [&](int chunk) {
    if (chunk < n_chunks) {
      if (ld_dc == 0) {
        do ld_live = tile_live(++ld_t); while (ld_live <= 0);
        ld_first = tile_first(ld_t);
      }
      const int byte0 = ld_dc * chunk_bytes;
      loader.load(ring_a + (chunk % IVF_STAGES) * stage_bytes, pitch, x, row_bytes,
                  ld_first, ld_live, byte0, min(chunk_bytes, row_bytes - byte0));
      if (++ld_dc == n_dc) ld_dc = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");  // one group a call
  };
#pragma unroll
  for (int c = 0; c < IVF_STAGES - 1; ++c) load_next(c);
  using QT = typename std::conditional<MODE == 2, float, __nv_bfloat16>::type;
  for (int c = tid; c < d; c += THREADS)
    s_q[c] = load_f(static_cast<const QT*>(q) + (long long)qq * d + c);

  const int r = tid >> 1, half = tid & 1;  // this thread's row of a tile
  const bool keeper = half == 0;           // the thread that keeps class c0 + r
  if (keeper)
    for (int rr = 0; rr < r_planes; ++rr) {
      ps[rr * TC + r] = neg_inf();
      pi[rr * TC + r] = -1;
    }
  float last = neg_inf(), rej = neg_inf();
  float aux0 = 0.f, rscale = 1.f, cf = 0.f;  // this row's sqnorm slot, scale, coarse
  float acc = 0.f;
  int t = t0 - 1, live = 0, dc = 0;
  long long first = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    asm volatile("cp.async.wait_group %0;" ::"n"(IVF_STAGES - 2) : "memory");
    __syncthreads();  // the chunk has landed; every warp is done with the one before
    load_next(chunk + IVF_STAGES - 1);

    if (dc == 0) {
      // the next live tile; its row's terms are loaded before the
      // products and used after them
      do live = tile_live(++t); while (live <= 0);
      first = tile_first(t);
      cf = coarse[(long long)qq * n_probe + t / n_sub];
      if (r < live) {
        aux0 = sqn[first + r];
        rscale = scales[first + r];
      }
    }
    const int byte0 = dc * chunk_bytes;
    acc = row_chunk_dot<MODE>(
        s_ring + (chunk % IVF_STAGES) * stage_bytes + r * pitch, s_q, byte0,
        min(chunk_bytes, row_bytes - byte0), half, acc);
    if (++dc < n_dc) continue;
    dc = 0;

    const float dot = acc + __shfl_xor_sync(FULL, acc, 1);  // the same sum in both lanes
    acc = 0.f;
    if (keeper && r < live) {
      float out = window_score(dot, aux0, rscale, metric_sq, scaled, cf);
      if (out > last)
        out = chain_insert(ps + r, pi + r, TC, r_planes, out, (int)(first + r), last);
      rej = fmaxf(rej, out);
    }
  }
  if (!keeper || r >= n_class) return;
  const bool single = gridDim.z == 1;
  const long long o = ((long long)split * n_q + qq) * r_planes * subwin + c0 + r;
  for (int rr = 0; rr < r_planes; ++rr) {
    float s = ps[rr * TC + r];
    int id = pi[rr * TC + r];
    if (single && !(s > VALID_MIN)) {
      s = neg_inf();
      id = -1;
    }
    part_s[o + (long long)rr * subwin] = s;
    part_i[o + (long long)rr * subwin] = id;
  }
  part_rej[((long long)split * n_q + qq) * subwin + c0 + r] = rej;
}

// Storage/query type combinations: 0 fp32/fp32, 1 bf16/bf16, 2 bf16
// queries over int8 residual rows.
enum Combo { F32 = 0, BF16 = 1, I8_BF16 = 2 };

}  // namespace

extern "C" {

// ring = 1 takes ivf_ring_kernel (rows of a multiple of 16 bytes, the
// layout 16-byte aligned; `piece` a multiple of TC), 0 ivf_scan_kernel
// (`piece` = CHUNK); n_pieces * piece must cover the window.
int ivf_scan_topk(int combo, int ring, const void* q, const void* x,
                  const float* sqn, const float* scales, const int* offs,
                  const int* cnts, const float* coarse, int n_q, int n_probe,
                  int d, int window, int metric_sq, int scaled, int k,
                  int piece, int n_pieces, float* part_s, int* part_i,
                  float* out_s, int* out_i, cudaStream_t stream) {
  if (k < 1 || k > 32 || n_q < 1 || n_probe < 1 || n_probe > 65535 ||
      n_pieces < 1 || n_pieces > 65535 || piece < 1 ||
      (long long)n_pieces * piece < window || combo < F32 || combo > I8_BF16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_q, n_probe, n_pieces);
  if (ring) {
    const int mode = combo == F32 ? 2 : combo == BF16 ? 0 : 1;
    const int row_bytes = (mode == 2 ? 4 : mode == 0 ? 2 : 1) * d;
    if (piece % TC != 0 || row_bytes % 16 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int chunk_bytes = std::min(IVF_CHUNK, row_bytes);
    const int n_dc = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    // the fp32 query, then the ring
    const int smem = (4 * d + 127) / 128 * 128 + IVF_STAGES * TC * (chunk_bytes + 16);
    // beside the 2 KB of the warps' top-k in static shared memory
    if (smem > MAX_SMEM - 2 * 1024) return (int)cudaErrorInvalidValue;
#define LAUNCH_IVF_RING(MODE)                                                \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, ivf_ring_kernel<MODE>, smem);        \
    if (e != cudaSuccess) return (int)e;                                     \
    ivf_ring_kernel<MODE><<<grid, THREADS, smem, stream>>>(                  \
        q, (const unsigned char*)x, sqn, scales, offs, cnts, coarse,         \
        n_probe, d, window, metric_sq, scaled, k, piece, n_dc, chunk_bytes,  \
        part_s, part_i);                                                     \
  }
    if (mode == 2) LAUNCH_IVF_RING(2) else if (mode == 0) LAUNCH_IVF_RING(0) else LAUNCH_IVF_RING(1)
#undef LAUNCH_IVF_RING
  } else {
    const int smem = d * (int)sizeof(float);
    if (piece != CHUNK || smem > MAX_SMEM - 2 * 1024) return (int)cudaErrorInvalidValue;
#define LAUNCH_SCAN(QT, XT)                                                  \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, ivf_scan_kernel<QT, XT>, smem);      \
    if (e != cudaSuccess) return (int)e;                                     \
    ivf_scan_kernel<QT, XT><<<grid, K4_THREADS, smem, stream>>>(             \
        (const QT*)q, (const XT*)x, sqn, scales, offs, cnts, coarse,         \
        n_probe, d, window, metric_sq, scaled, k, part_s, part_i);           \
  }
    switch (combo) {
      case F32: LAUNCH_SCAN(float, float) break;
      case BF16: LAUNCH_SCAN(__nv_bfloat16, __nv_bfloat16) break;
      default: LAUNCH_SCAN(__nv_bfloat16, int8_t) break;
    }
#undef LAUNCH_SCAN
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = 8;
  merge_partials_kernel<<<(n_q + warps - 1) / warps, 32 * warps, 0, stream>>>(
      part_s, part_i, n_q, n_probe * n_pieces, k, out_s, out_i);
  return (int)cudaGetLastError();
}

// ring = 1 takes ivf_topr_ring_kernel (rows of a multiple of 16 bytes, the
// layout 16-byte aligned) over n_splits splits of tiles_per_split tiles
// each, merged by topr_merge_kernel into the outputs (with one split the
// kernel writes them itself); 0 takes ivf_topr_kernel, which writes the
// outputs (n_splits must be 1).
int ivf_scan_topr(int combo, int ring, const void* q, const void* x,
                  const float* sqn, const float* scales, const int* offs,
                  const int* cnts, const float* coarse, int n_q, int n_probe,
                  int d, int window, int n_sub, int metric_sq, int scaled,
                  int r_planes, int tiles_per_split, int n_splits,
                  float* part_s, int* part_i, float* part_rej,
                  float* planes_s, int* planes_i, float* out_rej,
                  cudaStream_t stream) {
  if (n_q < 1 || n_probe < 1 || n_sub < 1 || window % n_sub != 0 ||
      r_planes < 1 || n_splits < 1 || n_splits > 65535 || tiles_per_split < 1 ||
      (long long)tiles_per_split * n_splits < (long long)n_probe * n_sub ||
      combo < F32 || combo > I8_BF16)
    return (int)cudaErrorInvalidValue;
  const int subwin = window / n_sub;
  if (ring) {
    const int mode = combo == F32 ? 2 : combo == BF16 ? 0 : 1;
    const int row_bytes = (mode == 2 ? 4 : mode == 0 ? 2 : 1) * d;
    if (row_bytes % 16 != 0 || (uintptr_t)x % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int chunk_bytes = std::min(IVF_CHUNK, row_bytes);
    const int n_dc = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    // the fp32 query, the ring, then the planes
    const long long smem = (4 * d + 127) / 128 * 128 +
                           IVF_STAGES * TC * (chunk_bytes + 16) +
                           (long long)r_planes * TC * 8;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (n_splits == 1) {  // the kernel's partials are the outputs
      part_s = planes_s;
      part_i = planes_i;
      part_rej = out_rej;
    }
    const dim3 grid(n_q, (subwin + TC - 1) / TC, n_splits);
#define LAUNCH_TOPR_RING(MODE)                                               \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, ivf_topr_ring_kernel<MODE>, (int)smem); \
    if (e != cudaSuccess) return (int)e;                                     \
    ivf_topr_ring_kernel<MODE><<<grid, THREADS, (int)smem, stream>>>(        \
        q, (const unsigned char*)x, sqn, scales, offs, cnts, coarse,         \
        n_probe, d, window, n_sub, metric_sq, scaled, r_planes,              \
        tiles_per_split, n_dc, chunk_bytes, part_s, part_i, part_rej);       \
  }
    if (mode == 2) LAUNCH_TOPR_RING(2) else if (mode == 0) LAUNCH_TOPR_RING(0) else LAUNCH_TOPR_RING(1)
#undef LAUNCH_TOPR_RING
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return (int)err;
    return (int)launch_topr_merge(part_s, part_i, part_rej, n_q, n_splits,
                                  subwin, r_planes, planes_s, planes_i,
                                  out_rej, stream);
  }
  const long long smem = (long long)d * 4 + (long long)r_planes * CLASSES * 8;
  if (n_splits != 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_q, (subwin + CLASSES - 1) / CLASSES);
#define LAUNCH_TOPR(QT, XT)                                                  \
  {                                                                          \
    static int allowed[MAX_DEVICES] = {};  /* this instance's, by device */  \
    cudaError_t e = allow_smem(allowed, ivf_topr_kernel<QT, XT>, (int)smem); \
    if (e != cudaSuccess) return (int)e;                                     \
    ivf_topr_kernel<QT, XT><<<grid, K5_THREADS, (int)smem, stream>>>(        \
        (const QT*)q, (const XT*)x, sqn, scales, offs, cnts, coarse,         \
        n_probe, d, window, n_sub, metric_sq, scaled, r_planes, planes_s,    \
        planes_i, out_rej);                                                  \
  }
  switch (combo) {
    case F32: LAUNCH_TOPR(float, float) break;
    case BF16: LAUNCH_TOPR(__nv_bfloat16, __nv_bfloat16) break;
    default: LAUNCH_TOPR(__nv_bfloat16, int8_t) break;
  }
#undef LAUNCH_TOPR
  return (int)cudaGetLastError();
}

}  // extern "C"
