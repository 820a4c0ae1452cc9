// IVF-PQ asymmetric-distance (ADC) window scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cuvs_rag_tpu/ops/pallas_pq.py:
//   K6  pq_adc_scores_pallas (`_kernel`)  ->  pq_adc_kernel
//
// For every (query, probe) pair it scores the probed list's window of the
// sorted layout from nibble-packed PQ codes and the pair's lookup table:
//   score[q, p, j] = coarse[q, p]
//                    + sum_s ( LUT[q, p, s, b & 15] + LUT[q, p, s + mb, b >> 4] )
//                    - corr[off + j]                      (two-level codes)
// with b = codes[s, off + j], off = offsets[q, p]; the low nibble of a byte
// is stream s and the high nibble stream s + mb (ops/pq.pack_nibbles).
// Slots at or past the list count, slots whose row id is negative
// (tombstones, filtered-out rows, pads) and slots past the layout's end
// come back as -inf / -1. ids[q, p, j] is row_ids[off + j] on live slots,
// or the slot's layout position off + j where the caller asks for
// positions (ivf_pq.search_scores: refine gathers raw rows by position);
// liveness is row_ids[off + j] >= 0 either way. The top-k over the returned
// scores stays outside, as on the TPU: under refine the ADC pool is up to
// k + 1024.
//
// The TPU kernel spent its time in 16 compare+select passes per code block
// (its vector unit has no gather), double-buffered each window by DMA and
// skipped dead slots in 512-lane chunks. Here a block takes one (pair,
// chunk of `chunk` slots): the copy engine brings the pair's (2 mb, 16)
// fp32 table into shared memory (one TMA 1-D bulk copy on an mbarrier),
// and each of its chunk / 4 threads scores four consecutive slots. The list
// count is the loop bound: a chunk past it writes its -inf / -1 and reads
// nothing.
//
// What bounds it on the H100: by bytes a few microseconds (each slot of the
// probed windows costs mb code bytes, a 4-byte id and a 4-byte correction
// once, however many pairs scan it, beside the pairs' tables and 8 bytes
// of output a window slot; at the main path's shape, 16 queries x 20
// probes of 320 distinct windows with about 850 live rows of 48 bytes,
// 2 MB of tables and 3.3 MB of output: 0.0060 ms; where the pairs share
// lists, as a clustered index's batch does, less). The kernel before this
// one, one slot a thread, took 16 us on the device because its 48
// one-byte global loads and 96 table lookups a slot queued in one
// load/store pipe. Here a thread reads a stream row's bytes of its four
// slots with one 32-bit load (consecutive words across a warp: one
// 128-byte line a warp and stream, streamed past the caches with
// `__ldcs`): 12 loads a slot where there were 48. The 96 lookups a slot
// stay, conflict-free (a warp's lanes all read one stream's 16-word row).
// It takes 13.4-13.5 us at the main shape (bound 6.0) and 90.1-90.4 at
// 100 queries x 20 probes x 96 code bytes (bound 49.3), against 15.6-16.0
// and 137.2-137.4 before (NVIDIA H100 80GB HBM3, 700 W;
// eval/k6_times.py). eval/k6_ablation.py, which rebuilds this file with
// parts of the work left out, says where the main shape's 13.4 us go: 9.1
// with neither code loads nor lookups (the launch, the table copy, ids,
// corrections and 3.3 MB of output from one short wave of blocks), 11.4
// with the loads alone, 11.0 with the lookups alone: the two add up rather
// than overlap, and the fixed part is most of it. At 100 queries the loads
// and lookups are most of it (55 us without them, 90 with). Code tiles
// copied into shared memory by TMA bulk copies, one row a stream, and read
// there 32 bits at a time (the variant "tile_by_tma") take 13.3 us at the
// main shape and 159 at 100 queries x 96 bytes; smaller tiles, which let
// more blocks share an SM, do not help (256-slot chunks 162, 128-slot
// 194), so it is not occupancy that the tiles cost. These words need no
// shared memory. Loads through the caches (`__ldg`) are 1 us faster at
// the main shape and slower at the others, 256-slot chunks 1 us faster at
// 16 queries and slower at 64 and 100, an unroll of 8 or 4 slower. Ids
// and corrections are read as int4 / float4 and the outputs written as
// float4 / int4 where aligned, with a scalar edge.
//
// Two routes, chosen by each block for itself (the wrapper never reads
// device offsets on the host): "words" where the chunk's first code byte is
// 4-byte aligned and cap is a multiple of 4 (every index layout: lists
// start at multiples of ops/ivf.ALIGN = 128), "bytes" elsewhere, one-byte
// loads of the live slots only. Where the caller hands it counters (a
// check, never a search), each block that reads codes adds one to its
// route's count in `routes`.
//
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int SLOTS = 4;        // slots a thread
constexpr int MAX_CHUNK = 512;  // slots a block: 128 threads
constexpr int MIN_CHUNK = 32;
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) global -> shared by the copy engine; both
// addresses 16-byte aligned; completion is counted on the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Writes slots j .. j + 3 of one output row (those below j1): one float4
// and one int4 where they are whole and aligned, else one at a time.
__device__ __forceinline__ void store4(float* os, int* oi, int j, int j1,
                                       const float (&v)[SLOTS],
                                       const int (&id)[SLOTS]) {
  if (j + SLOTS <= j1 && aligned16(os + j) && aligned16(oi + j)) {
    *reinterpret_cast<float4*>(os + j) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(oi + j) = make_int4(id[0], id[1], id[2], id[3]);
    return;
  }
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    if (j + u < j1) {
      os[j + u] = v[u];
      oi[j + u] = id[u];
    }
  }
}

// One stream's byte of each of the four slots (byte u of b: slot u) looked
// up in its low- and high-nibble table rows and added to lo / hi.
__device__ __forceinline__ void lookup4(uint32_t b, const float* l0,
                                        const float* l1, float (&lo)[SLOTS],
                                        float (&hi)[SLOTS]) {
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    lo[u] += l0[(b >> (8 * u)) & 15u];
    hi[u] += l1[(b >> (8 * u + 4)) & 15u];
  }
}

__global__ void __launch_bounds__(MAX_CHUNK / SLOTS)
pq_adc_kernel(const uint8_t* __restrict__ codes,   // (mb, cap)
              const int* __restrict__ row_ids,     // (cap,)
              const float* __restrict__ corr,      // (cap,) or nullptr
              const float* __restrict__ luts,      // (Q*P, 2 mb, 16), 16 B aligned
              const int* __restrict__ offs,        // (Q*P,)
              const int* __restrict__ cnts,        // (Q*P,)
              const float* __restrict__ coarse,    // (Q*P,)
              int mb, long long cap, int window, int positions,
              float* __restrict__ out_s,           // (Q*P, window)
              int* __restrict__ out_i,             // (Q*P, window)
              unsigned long long* __restrict__ routes) {  // (2,) or null
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                  // (2 mb, 16)
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + mb * 128);
  const int chunk = blockDim.x * SLOTS;
  const long long qp = blockIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(j0 + chunk, window);
  const long long off = offs[qp];
  long long live = min(cnts[qp], window);
  if (off < 0) live = 0;
  if (off + live > cap) live = max(cap - off, 0LL);
  const int cnt = (int)live;
  float* os = out_s + qp * window;
  int* oi = out_i + qp * window;
  const int t = threadIdx.x;
  const int j = j0 + t * SLOTS;  // this thread's first slot

  if (j0 >= cnt) {  // past the list: nothing to read
    if (j < j1) {
      const float v[SLOTS] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                              -CUDART_INF_F};
      const int id[SLOTS] = {-1, -1, -1, -1};
      store4(os, oi, j, j1, v, id);
    }
    return;
  }
  const int lim = min(cnt, j1);              // slots below lim are live
  const uint8_t* src = codes + off + j0;     // stream s at src + s * cap
  const bool words = ((uintptr_t)src & 3) == 0 && (cap & 3) == 0;
  const uint32_t bar_a = smem_u32(bar);
  if (t == 0) {
    const uint32_t lut_bytes = (uint32_t)mb * 128;
    mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_expect_tx(bar_a, lut_bytes);
    bulk_copy(smem_u32(lut), luts + qp * mb * 32, lut_bytes, bar_a);
    if (routes != nullptr) atomicAdd(routes + (words ? 0 : 1), 1ULL);
  }

  // ids and liveness of slots j .. j + 3, while the table is in flight
  const long long slot = off + j;
  int id[SLOTS] = {-1, -1, -1, -1};
  if (j < lim) {
    const int* rid = &row_ids[slot];
    if (j + SLOTS <= lim && aligned16(rid)) {
      const int4 r = *reinterpret_cast<const int4*>(rid);
      id[0] = r.x; id[1] = r.y; id[2] = r.z; id[3] = r.w;
    } else {
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) id[u] = j + u < lim ? rid[u] : -1;
    }
  }
  const bool scored = max(max(id[0], id[1]), max(id[2], id[3])) >= 0;
  float lo[SLOTS] = {0.f, 0.f, 0.f, 0.f}, hi[SLOTS] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();  // the barrier is initialized
  // every thread waits: the block must not end with the copy in flight
  mbar_wait(bar_a, 0);
  if (scored) {
    const float* l0 = lut;            // stream s's low-nibble row
    const float* l1 = lut + mb * 16;  // and its high-nibble row
    if (words) {
      // the word of slots j .. j + 3 lies inside the layout: j < lim <=
      // cap - off, and off + j and cap are multiples of 4
      const uint32_t* w = reinterpret_cast<const uint32_t*>(src) + t;
      const long long step = cap >> 2;
#pragma unroll 16
      for (int s = 0; s < mb; ++s) {
        lookup4(__ldcs(w), l0, l1, lo, hi);
        w += step;
        l0 += 16;
        l1 += 16;
      }
    } else {
      const uint8_t* g = src + 4 * t;
      const int n = lim - j;  // live slots of this thread (some may be dead)
      for (int s = 0; s < mb; ++s) {
        uint32_t b = 0;
#pragma unroll
        for (int u = 0; u < SLOTS; ++u)
          if (u < n) b |= (uint32_t)g[u] << (8 * u);
        lookup4(b, l0, l1, lo, hi);
        g += cap;
        l0 += 16;
        l1 += 16;
      }
    }
  }
  if (j >= j1) return;
  float c[SLOTS] = {0.f, 0.f, 0.f, 0.f};
  if (corr != nullptr && scored) {
    const float* cr = &corr[slot];
    if (j + SLOTS <= lim && aligned16(cr)) {
      const float4 r = *reinterpret_cast<const float4*>(cr);
      c[0] = r.x; c[1] = r.y; c[2] = r.z; c[3] = r.w;
    } else {
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) c[u] = j + u < lim ? cr[u] : 0.f;
    }
  }
  const float base = coarse[qp];
  float v[SLOTS];
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const bool alive = id[u] >= 0;
    v[u] = alive ? (base + (lo[u] + hi[u])) - c[u] : -CUDART_INF_F;
    if (alive && positions) id[u] = (int)(slot + u);
  }
  store4(os, oi, j, j1, v, id);
}

}  // namespace

extern "C" {

// n_qp = queries x probes; chunk = slots a block (a multiple of 32 up to
// 512, ops/pq_kernels.adc_plan). corr may be null (no per-row correction);
// positions != 0 writes layout positions as ids; routes: null, or two
// counters (words, bytes blocks) for a check.
int pq_adc_scores(const uint8_t* codes, const int* row_ids, const float* corr,
                  const float* luts, const int* offs, const int* cnts,
                  const float* coarse, int n_qp, int mb, long long cap,
                  int window, int chunk, int positions, float* out_s,
                  int* out_i, unsigned long long* routes,
                  cudaStream_t stream) {
  const long long smem = (long long)mb * 128 + 16;  // the table, the barrier
  const long long n_chunks = chunk > 0 ? ((long long)window + chunk - 1) / chunk : 0;
  if (n_qp < 1 || mb < 1 || cap < 1 || window < 1 || chunk < MIN_CHUNK ||
      chunk > MAX_CHUNK || chunk % MIN_CHUNK != 0 || n_chunks > 65535 ||
      smem > MAX_SMEM || ((uintptr_t)luts & 15) != 0 ||
      (positions && cap > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static int allowed[MAX_DEVICES] = {};  // by device
    cudaError_t err = allow_smem(allowed, pq_adc_kernel, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_qp, (unsigned)n_chunks);
  pq_adc_kernel<<<grid, chunk / SLOTS, (int)smem, stream>>>(
      codes, row_ids, corr, luts, offs, cnts, coarse, mb, cap, window,
      positions, out_s, out_i, routes);
  return (int)cudaGetLastError();
}

}  // extern "C"
