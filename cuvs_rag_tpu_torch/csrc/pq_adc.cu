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
// What bounds it on the H100: by bytes it is a few microseconds (each live
// slot costs mb code bytes, a 4-byte id, a 4-byte correction and 8 bytes of
// output against 2 mb adds; at the main path's shape, 16 queries x 20
// probes, about 850 live rows of 48 bytes per window, 2 MB of tables, 3.3
// MB of output), but it takes 16-17 us on the device (NVIDIA H100 80GB
// HBM3, 700 W). eval/k6_ablation.py, which rebuilds this file with parts
// of the work left out, says where they go: the same 15.4 us with every
// code resident in L2; 14.9 without the table copy, 15.2 without ids and
// corrections, 15.5 without the lookups, 11.6 without the code loads;
// 13.9 with the code loads alone, 10.8 with the lookups alone; 52-54 for
// four times the pairs, where the loads alone take 39.4 and the lookups
// alone 27.2: a unit of work adds 12.3 us, 8.5 and 5.5, nearly additive.
// So neither DRAM, nor a chain of latencies, nor the launch bounds it, but
// the 48 byte loads and 96 lookups a slot queueing in one load/store
// pipe. Two other designs were built, held every case and
// were no faster: one block a pair with one table copy and four slots a
// thread from one 32-bit load a stream (more than twice as slow), and this
// block shape with ids, corrections and a first round of loads ahead of
// the table copy and double-buffered rounds of 4-24 streams. This one
// stays, with running pointers in its stream loop. The launch and the
// wrapper's host work dominate a call.
//
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem.cuh"

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
    const float* l0 = lut;  // the stream's low-nibble row; high rows mb * 16 on
#pragma unroll 8
    for (int s = 0; s < mb; ++s) {
      const unsigned b = *c;
      c += cap;
      lo += l0[b & 15u];
      hi += l0[mb * 16 + (b >> 4)];
      l0 += 16;
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
    static int allowed[MAX_DEVICES] = {};  // by device
    cudaError_t err = allow_smem(allowed, pq_adc_kernel, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_qp, (unsigned)n_chunks);
  pq_adc_kernel<<<grid, THREADS, (int)smem, stream>>>(
      codes, row_ids, corr, luts, offs, cnts, coarse, mb, cap, window, out_s,
      out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
