// Streaming-read and scattered-gather measurement kernels on Hopper (sm_90a).
//
// Replace the four Pallas TPU measurement kernels under scripts/:
//   M1  read_all             (scripts/bench_roofline.py:70, `_kernel` :46)
//         -> read_all_kernel + read_all_final_kernel
//   M2  pallas_gather        (scripts/bench_gather_modes.py:60, `_kernel` :42)
//   M4  pallas_gather        (scripts/bench_pallas_gather.py:61, `_kernel` :38)
//         -> gather_rows_kernel (M4 is its span = 1 case)
//   M3  pallas_gather_reduce (scripts/bench_gather_modes.py:198,
//                             `_kernel_reduce` :171)
//         -> gather_reduce_kernel + gather_reduce_final_kernel
//
// They are the measurement itself: what the card's memory system gives a
// kernel that streams a corpus once (the ceiling of every scan kernel) and
// one that reads scattered rows (the ceiling of refine's gather and of a
// graph search's beam). All are bound by bytes; none multiplies.
//
// The TPU kernels moved whole (tile_c, D) blocks or rows by DMA, one grid
// step after another, with the running result in VMEM. Here every thread
// moves 16 bytes a load with several loads in flight, blocks run in
// parallel over a grid-stride loop, and what crosses blocks goes through a
// small partial buffer and a second pass in a fixed order. The only atomics
// are M1's shared-memory maxima, which have no order, so every result is
// the same from run to run.
//
// Plain C ABI (built with nvcc, loaded with ctypes): every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte loads in flight per thread

// A 16-byte load the compiler may not drop, whether or not its result is
// used: "touch" mode must still bring every byte into the SM.
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void unpack(const uint4& w, __nv_bfloat16, float* f) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& w, int8_t, float* f) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = (float)(int8_t)((u[i] >> (8 * b)) & 0xffu);
}

__device__ __forceinline__ void unpack(const uint4& w, float, float* f) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// ---------------------------------------------------------------- M1 -----
// The (n, d) bf16 corpus is n * d / 8 chunks of 16 bytes in memory order, and
// thread t of the grid reads chunks t, t + G, t + 2 G, ... (G threads in the
// grid): a warp's load is 512 contiguous bytes, the access pattern that
// reached the highest read rate of those tried on the card. The wrapper
// picks the grid so that G is a multiple of d, the chunks of 8 rows: a
// thread's output class (row mod 8, column mod 128) is then the same for
// every chunk it reads, its eight running maxima stay in registers, and the
// "reduce" loop needs no division. A block folds its threads' maxima into
// an (8, 128) tile in shared memory (atomics on the ordered bit patterns:
// a maximum has no order) and writes it as its partial.
// full != 0 ("reduce"): every element is folded. full == 0 ("touch"): every
// chunk is still loaded, and only the corner of each `tile_rows`-row tile
// is folded: its first 8 rows, columns [0, 128).
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(THREADS)
read_all_kernel(const __nv_bfloat16* __restrict__ x, long long n, int d,
                int full, int tile_rows,
                float* __restrict__ partial) {  // (blocks, 8, 128)
  __shared__ float tile[8 * 128];
  const int tid = threadIdx.x;
  const int cpr = d / 8;  // chunks per row
  const long long n_chunks = n * cpr;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + tid;
  const uint4* chunks = reinterpret_cast<const uint4*>(x);
  float best[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) best[e] = -CUDART_INF_F;
  for (int e = tid; e < 8 * 128; e += THREADS) tile[e] = -CUDART_INF_F;

  for (long long c0 = first; c0 < n_chunks; c0 += stride * UNROLL) {
    uint4 w[UNROLL];
    bool take[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const long long c = c0 + i * stride;
      take[i] = false;
      if (c >= n_chunks) continue;
      w[i] = ld16(chunks + c);
      if (full) {
        take[i] = true;
      } else {
        const long long row = c / cpr;
        take[i] = row % tile_rows < 8 && c - row * cpr < 16;
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      if (!take[i]) continue;
      float f[8];
      unpack(w[i], __nv_bfloat16(), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) best[e] = fmaxf(best[e], f[e]);
    }
  }
  __syncthreads();
  // every chunk of this thread lies at the same place of its 8-row band
  const int in_band = (int)(first % d);
  float* dst = tile + (in_band / cpr) * 128 + (in_band % cpr % 16) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (best[e] > -CUDART_INF_F) atomic_max_float(dst + e, best[e]);
  __syncthreads();
  for (int e = tid; e < 8 * 128; e += THREADS)
    partial[(long long)blockIdx.x * 1024 + e] = tile[e];
}

// out[c] = max over the blocks' partials; one thread per output element.
__global__ void read_all_final_kernel(const float* __restrict__ partial,
                                      int n_blocks, float* __restrict__ out) {
  const int c = threadIdx.x;  // 1024 threads
  float best = -CUDART_INF_F;
  for (int b = 0; b < n_blocks; ++b)
    best = fmaxf(best, partial[(long long)b * 1024 + c]);
  out[c] = best;
}

// ------------------------------------------------------------ M2 / M4 ----
// dst segment s = the `seg_chunks` 16-byte chunks that start at source row
// ids[s] (span rows, contiguous in the source: one copy of seg_chunks
// chunks). What bounds it: bytes, each row read once and written once, and
// the mix of reads and writes that the memory takes below its read-only
// rate. A group of GS lanes (a warp, or a fixed part of one: the wrapper
// picks the width that leaves the fewest lanes idle on the segment's last
// pass) owns a segment: its first lane loads the id once and the group gets
// it by shuffle, a lane's chunks are lane, lane + GS, ... (a 32-bit lane
// loop, the ragged edge masked), and no division is left. The grid has a
// group for every segment where it can: blocks that persist and walk
// several far-apart segments each widen the window of output in flight and
// were slower. Rows are read through the read-only path (ld.global.nc; L1
// allocation stays on, duplicate ids hit there) and written with streaming
// stores (st.global.cs), so the copy does not push out of the L2 the corpus
// lines that duplicate ids hit. The same copy through the copy engine (1-D
// cp.async.bulk global -> shared -> global, two 1,536-byte buffers and
// mbarriers a thread, 32 threads a block) was 3% slower on 1,536-byte rows,
// 7% on 768-byte rows and 16 to 150% on duplicate ids, 2% faster on 32-row
// spans (PERF.md has the run).
template <int GS>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ src,
                   const long long* __restrict__ ids, uint4* __restrict__ dst,
                   long long m, int seg_chunks, long long row_chunks) {
  constexpr int GPW = 32 / GS;  // groups a warp
  const int lane = threadIdx.x & 31, gl = lane % GS, gi = lane / GS;
  const long long groups = (long long)gridDim.x * (THREADS / 32) * GPW;
  const long long warp_first =
      ((long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * GPW;
  // every lane of the warp takes every trip: the shuffle needs them all
  for (long long s0 = warp_first; s0 < m; s0 += groups) {
    const long long s = s0 + gi;
    const bool live = s < m;
    long long id = 0;
    if (live && gl == 0) id = ids[s];
    id = __shfl_sync(0xffffffffu, id, 0, GS);
    if (!live) continue;
    const uint4* from = src + id * row_chunks;
    uint4* to = dst + s * seg_chunks;
    for (int c = gl; c < seg_chunks; c += GS) __stcs(to + c, ld16(from + c));
  }
}

// ---------------------------------------------------------------- M3 -----
// Thread t owns chunk t % row_chunks of the rows it reads and sums that
// chunk's values in registers; a block reads THREADS / row_chunks rows at a
// time. The rows never go back to device memory: a block writes one (d,)
// partial, and the final pass adds the partials in block order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_reduce_kernel(const T* __restrict__ src,
                     const long long* __restrict__ ids, long long m, int d,
                     int row_chunks,
                     float* __restrict__ partial) {  // (blocks, d)
  constexpr int VPC = 16 / sizeof(T);  // values per chunk
  extern __shared__ float rows_sum[];  // (rows per pass, d)
  const int tid = threadIdx.x;
  const int rpp = THREADS / row_chunks;  // rows per pass
  const int cc = tid % row_chunks, rs = tid / row_chunks;
  const bool active = rs < rpp;
  const long long stride = (long long)gridDim.x * rpp;
  float acc[VPC];
#pragma unroll
  for (int e = 0; e < VPC; ++e) acc[e] = 0.f;

  if (active) {
    for (long long i0 = (long long)blockIdx.x * rpp + rs; i0 < m;
         i0 += stride * UNROLL) {
      uint4 w[UNROLL];
      bool ok[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        const long long row = i0 + i * stride;
        ok[i] = row < m;
        if (ok[i])
          w[i] = ld16(reinterpret_cast<const uint4*>(src + ids[row] * d) + cc);
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        if (!ok[i]) continue;
        float f[VPC];
        unpack(w[i], T(), f);
#pragma unroll
        for (int e = 0; e < VPC; ++e) acc[e] += f[e];
      }
    }
#pragma unroll
    for (int e = 0; e < VPC; ++e) rows_sum[rs * d + cc * VPC + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < d; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < rpp; ++r) s += rows_sum[r * d + c];
    partial[(long long)blockIdx.x * d + c] = s;
  }
}

__global__ void gather_reduce_final_kernel(const float* __restrict__ partial,
                                           int n_blocks, int d,
                                           float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long long)b * d + c];
  out[c] = s;
}

template <typename T>
int launch_gather_reduce(const void* src, const long long* ids, long long m,
                         int d, int n_blocks, float* partial, float* out,
                         cudaStream_t stream) {
  const int row_chunks = d * (int)sizeof(T) / 16;
  const int smem = (THREADS / row_chunks) * d * (int)sizeof(float);
  gather_reduce_kernel<T><<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(src), ids, m, d, row_chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_reduce_final_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      partial, n_blocks, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, d) bf16 contiguous, d a multiple of 128; n_blocks * 256 threads
// must be a multiple of d. partial: (n_blocks, 8, 128) fp32 scratch; out:
// (8, 128) fp32.
int read_all(const void* x, long long n, int d, int full, int tile_rows,
             int n_blocks, float* partial, float* out, cudaStream_t stream) {
  if (n < 1 || d < 128 || d % 128 != 0 || n_blocks < 1 ||
      ((long long)n_blocks * THREADS) % d != 0 || tile_rows < 8 ||
      tile_rows % 8 != 0)
    return (int)cudaErrorInvalidValue;
  read_all_kernel<<<n_blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), n, d, full, tile_rows, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  read_all_final_kernel<<<1, 1024, 0, stream>>>(partial, n_blocks, out);
  return (int)cudaGetLastError();
}

// src rows of row_bytes bytes (a multiple of 16); dst segment i = span rows
// from source row ids[i]. ids: (m,) int64, validated by the caller.
// group_lanes (4, 8, 16 or 32) lanes own a segment.
int gather_rows(const void* src, const long long* ids, void* dst, long long m,
                int span, long long row_bytes, int group_lanes, int n_blocks,
                cudaStream_t stream) {
  if (m < 1 || span < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      n_blocks < 1 || row_bytes / 16 * span > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long row_chunks = row_bytes / 16;
  const int seg_chunks = (int)(row_chunks * span);
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  switch (group_lanes) {
    case 4:
      gather_rows_kernel<4><<<n_blocks, THREADS, 0, stream>>>(
          s, ids, d, m, seg_chunks, row_chunks);
      break;
    case 8:
      gather_rows_kernel<8><<<n_blocks, THREADS, 0, stream>>>(
          s, ids, d, m, seg_chunks, row_chunks);
      break;
    case 16:
      gather_rows_kernel<16><<<n_blocks, THREADS, 0, stream>>>(
          s, ids, d, m, seg_chunks, row_chunks);
      break;
    case 32:
      gather_rows_kernel<32><<<n_blocks, THREADS, 0, stream>>>(
          s, ids, d, m, seg_chunks, row_chunks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out (d,) fp32 = sum over i of src[ids[i], :]. kind: 0 bf16, 1 int8, 2
// fp32. A row is at most THREADS chunks of 16 bytes. partial: (n_blocks, d).
int gather_reduce(const void* src, const long long* ids, long long m, int d,
                  int kind, int n_blocks, float* partial, float* out,
                  cudaStream_t stream) {
  const int elt = kind == 0 ? 2 : kind == 1 ? 1 : 4;
  if (m < 1 || d < 1 || kind < 0 || kind > 2 || (d * elt) % 16 != 0 ||
      d * elt / 16 > THREADS || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (kind == 0)
    return launch_gather_reduce<__nv_bfloat16>(src, ids, m, d, n_blocks,
                                               partial, out, stream);
  if (kind == 1)
    return launch_gather_reduce<int8_t>(src, ids, m, d, n_blocks, partial, out,
                                        stream);
  return launch_gather_reduce<float>(src, ids, m, d, n_blocks, partial, out,
                                     stream);
}

}  // extern "C"
