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
// come back as -inf / -1. ids[q, p, j] is row_ids[off + j] on live slots.
// The top-k over the returned scores stays outside, as on the TPU: under
// refine the ADC pool is up to k + 1024.
//
// The TPU kernel spent its time in 16 compare+select passes per code block
// (its vector unit has no gather), double-buffered each window by DMA and
// skipped dead slots in 512-lane chunks. Here the table lookup is a
// shared-memory read: a block copies the pair's (2 mb, 16) fp32 table to
// shared memory once (6 KB at mb = 48) and each thread scores one slot,
// walking the mb streams. The slot axis of the (mb, cap) stream-major
// layout is contiguous, so a warp's 32 byte loads of one stream fall in one
// sector, and the 16 entries of a table row lie in 16 different banks, so
// the lookups of a warp never conflict. The list count is the loop bound:
// a chunk past it writes its -inf / -1 and reads nothing.
//
// What bounds it on the H100: bytes. Each live slot costs mb code bytes, a
// 4-byte id, a 4-byte correction and 8 bytes of output against 2 mb adds;
// at the main path's shape (16 queries x 20 probes, about 500 live rows of
// 48 bytes per window, 2 MB of tables, 3.3 MB of output) that is a few
// microseconds of memory traffic, so the launch itself dominates. Byte-wide
// code loads and one table copy per chunk are what a later version would
// widen and share.
//
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 512;  // slots per block: two per thread
constexpr int MAX_SMEM = 227 * 1024;

__global__ void __launch_bounds__(THREADS)
pq_adc_kernel(const uint8_t* __restrict__ codes,   // (mb, cap)
              const int* __restrict__ row_ids,     // (cap,)
              const float* __restrict__ corr,      // (cap,) or nullptr
              const float* __restrict__ luts,      // (Q*P, 2 mb, 16)
              const int* __restrict__ offs,        // (Q*P,)
              const int* __restrict__ cnts,        // (Q*P,)
              const float* __restrict__ coarse,    // (Q*P,)
              int mb, long long cap, int window,
              float* __restrict__ out_s,           // (Q*P, window)
              int* __restrict__ out_i) {           // (Q*P, window)
  extern __shared__ float lut[];  // (2 mb, 16) of this (query, probe)
  const long long qp = blockIdx.x;
  const int j0 = blockIdx.y * CHUNK;
  const int j1 = min(j0 + CHUNK, window);
  const long long off = offs[qp];
  long long live = min(cnts[qp], window);
  if (off < 0) live = 0;
  if (off + live > cap) live = max(cap - off, 0LL);
  const int cnt = (int)live;
  float* os = out_s + qp * window;
  int* oi = out_i + qp * window;

  if (j0 >= cnt) {  // past the list: nothing to read
    for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
      os[j] = -CUDART_INF_F;
      oi[j] = -1;
    }
    return;
  }
  const int lut_n = mb * 32;
  const float* src = luts + qp * lut_n;
  for (int i = threadIdx.x; i < lut_n; i += THREADS) lut[i] = src[i];
  __syncthreads();

  const float base = coarse[qp];
  const float* hi_lut = lut + mb * 16;
  for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
    const long long slot = off + j;
    const int id = j < cnt ? row_ids[slot] : -1;
    if (id < 0) {
      os[j] = -CUDART_INF_F;
      oi[j] = -1;
      continue;
    }
    const uint8_t* c = codes + slot;
    float lo = 0.f, hi = 0.f;
    for (int s = 0; s < mb; ++s) {
      const unsigned b = c[(long long)s * cap];
      lo += lut[s * 16 + (b & 15u)];
      hi += hi_lut[s * 16 + (b >> 4)];
    }
    float v = base + (lo + hi);
    if (corr != nullptr) v -= corr[slot];
    os[j] = v;
    oi[j] = id;
  }
}

}  // namespace

extern "C" {

// n_qp = queries x probes. corr may be null (no per-row correction).
int pq_adc_scores(const uint8_t* codes, const int* row_ids, const float* corr,
                  const float* luts, const int* offs, const int* cnts,
                  const float* coarse, int n_qp, int mb, long long cap,
                  int window, float* out_s, int* out_i, cudaStream_t stream) {
  const long long smem = (long long)mb * 32 * sizeof(float);
  const long long n_chunks = ((long long)window + CHUNK - 1) / CHUNK;
  if (n_qp < 1 || mb < 1 || cap < 1 || window < 1 || n_chunks > 65535 ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_qp, (unsigned)n_chunks);
  pq_adc_kernel<<<grid, THREADS, (int)smem, stream>>>(
      codes, row_ids, corr, luts, offs, cnts, coarse, mb, cap, window, out_s,
      out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
