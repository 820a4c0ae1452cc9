// The copy ring and tensor-core helpers of the ring-fed kernels of
// flat_topk.cu (K1, K2) and ivf_scan.cu (K4): a block of THREADS threads
// streams tiles of TC consecutive corpus rows, one depth chunk at a time,
// by 16-byte cp.async copies into stages of dynamic shared memory, and
// multiplies them with the TQ queries of its tile (mma.sync) or on the CUDA
// cores. flat_topk.cu's note says how the ring was sized and measured; the
// stage count and chunk width stay in each source.
// Everything has internal linkage: each .cu file compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int TQ = 16;            // queries per block (the mma's M)
constexpr int TC = 128;           // corpus rows per tile
constexpr int THREADS = 256;      // 8 warps
constexpr int QPT = TQ / 8;       // queries per thread (warp w: w, w + 8)
constexpr int CPT = TC / 32;      // rows per thread (lane l: l + 32 j)
constexpr int SCORE_PITCH = TC + 8;  // fragments' float2 stores hit 32 banks
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 queries x 8 rows, fp32) += a (16 x 16 bf16) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 queries x 8 rows, int32) += a (16 x 32 int8) . b (32 x 8 int8):
// exact. A register of an ldmatrix of int8 rows holds bytes 4t .. 4t + 3 of
// its row (t = lane % 4), which is this mma's order for both operands.
__device__ __forceinline__ void mma_16x8x32_s8(int (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte i of an int8 word as an exact float: byte + 128 becomes the low
// mantissa bits of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float int8_lane(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

// Four int8 values of one register -> two registers of bf16 pairs, exactly.
__device__ __forceinline__ void widen_int8(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __nv_bfloat162 a = __floats2bfloat162_rn(int8_lane(u, 0), int8_lane(u, 1));
  const __nv_bfloat162 b = __floats2bfloat162_rn(int8_lane(u, 2), int8_lane(u, 3));
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// The ring's loader: one depth chunk (`width` bytes a row, from byte
// `byte0` of each row) of the TC rows that start at `first_row` of a
// row-major corpus of `row_bytes` a row, into the stage at `dst` with
// `pitch` bytes a row; rows at or past `n_live` become zeros and are never
// read from the corpus. The tile's first row is an argument, so tiles need
// not be consecutive (K2 walks tiles W rows apart, K4 a probed window's).
// (r0, c0) is this thread's first (row, 16-byte piece) and (step_r, step_c)
// the step of one pass of the block, worked out once by the caller for
// `pieces` pieces a full chunk's row.
struct RingLoader {
  int r0, c0, step_r, step_c, pieces, passes;

  __device__ __forceinline__ void init(int chunk_bytes) {
    pieces = chunk_bytes >> 4;
    r0 = threadIdx.x / pieces;
    c0 = threadIdx.x % pieces;
    step_r = THREADS / pieces;
    step_c = THREADS % pieces;
    passes = (TC * pieces + THREADS - 1) / THREADS;
  }

  __device__ __forceinline__ void load(uint32_t dst, int pitch,
                                       const unsigned char* x, long long row_bytes,
                                       long long first_row, int n_live, int byte0,
                                       int width) const {
    const unsigned char* src = x + first_row * row_bytes + byte0;
    int r = r0, c = c0;
    for (int i = 0; i < passes; ++i) {
      if (r < TC && (c << 4) < width) {
        const bool live = r < n_live;
        cp_async16(dst + r * pitch + (c << 4),
                   live ? src + r * row_bytes + (c << 4) : x, live ? 16 : 0);
      }
      r += step_r;
      c += step_c;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
  }
};

}  // namespace
