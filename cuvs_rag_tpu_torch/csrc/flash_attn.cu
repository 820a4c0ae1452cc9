// Causal flash attention with a segment-id pad mask on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel the Qwen3 encoder calls at
// cuvs_rag_tpu/models/flax_qwen.py:157:
//   K7  jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
//       (causal=True, segment_ids = the attention mask)
//         -> flash_attn_wgmma_kernel (bf16) and flash_attn_fp32_kernel (fp32)
//
// out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, g, :])
//                   * v[b, j, g, :],   g = h / (nh / nkv),
// over the keys j <= i with seg[b, j] == seg[b, i] (the TPU kernel's segment
// rule: pad rows attend pad rows). Every row allows j = i, so the softmax
// denominator is never 0 and no row of the output is NaN. q and out are
// (B, S, nh, hd), k and v (B, S, nkv, hd): the projections' own layout, so
// the TPU path's two moveaxis round trips and its materialized GQA repeat
// have no counterpart here. The TPU grid walked 1024-wide kv blocks one
// after another with its state in VMEM; here blocks run in parallel, each
// loops over key tiles up to its own causal limit (the loop bound is the
// causal skip), and the blocks with the longest loops are scheduled first.
// Any S: ragged tiles are masked, not required to divide.
//
// What bounds it on the H100: operations. One layer at S = 8192, 16 heads,
// hd = 128 is 0.263 TFLOP after the causal skip against 0.10 GB of q, k, v
// and out: 0.27 ms on the bf16 tensor cores (989 TFLOP/s), 0.03 ms of bytes.
// Beside the products stand S^2 / 2 exponentials a head on a unit that does
// 16 a clock and SM: half the products' time at hd = 128. So the design is
// about keeping the tensor cores fed while the softmax runs.
//
// bf16 inputs: flash_attn_wgmma_kernel.
// - Both products are warpgroup multiplies (wgmma.mma_async, bf16 x bf16 ->
//   fp32): S = Q.K^T as m64n128k16 with Q and K read from shared memory,
//   O += P.V as m64n(hd)k16 with P as the register operand and V read from
//   shared memory transposed. Products of bf16 values are exact and sums
//   are fp32, so the scores differ from an fp32 computation by summation
//   order alone. scale * log2(e) (positive) meets the fp32 scores in one
//   fused multiply-add with the running max; exponentials are ex2.approx.
// - P never leaves registers: the score accumulator is packed to bf16 in
//   place and is the A operand of P.V. As in the TPU kernel (and the dense
//   branch of flax_qwen.py), P is rounded to bf16 before P.V while the
//   denominator l sums the fp32 p.
// - A block is two warpgroups of 64 rows each and serves the G query heads
//   of one kv group that fit its 128 rows (G = 4, 2 or 1, a divisor of nh /
//   nkv; 128 / G query rows each), so a K/V tile is loaded once for all of
//   them: at Qwen3's 16 / 8 heads, one head a warpgroup.
// - Q (128 rows) and a three-stage ring of 128-key K, V and key-segment
//   tiles sit in shared memory as bf16 panels of 64 values (128 bytes) a
//   row, the 16-byte chunks of a row XORed with row % 8: the 128-byte
//   swizzle that the wgmma descriptors name. K/V tiles arrive by cp.async
//   (16 bytes a thread, zero-filled past S, every thread's offsets worked
//   out once), the next tile in flight while this one multiplies; one
//   __syncthreads() a tile.
// - The two warpgroups run half an iteration apart: warpgroup 0 takes the
//   softmax of tile t right after starting Q.K^T of tile t and P.V of tile
//   t - 1 (while that P.V runs); warpgroup 1 carries its scores over the
//   barrier and takes the softmax at the start of the next iteration, while
//   warpgroup 0's products hold the tensor cores.
// - No wgmma stands under a condition on data: the compiler fences, one
//   after another, every wgmma of a path it cannot prove uniform. So every
//   warpgroup multiplies every tile up to the block's causal limit, and
//   what the data allows is saved in the softmax instead: a warp looks at
//   the tile's key segments and its warpgroup's row segments once (three
//   loads, a shuffle and a vote), and only a tile on the diagonal or with
//   more than one segment takes the per-element causal and segment
//   compares. A row whose keys so far are all masked (a real row of a
//   left-padded sequence sees pad-only tiles first) keeps m = -inf: the
//   exponentials are taken against 0 then, never exp(-inf + inf).
// - The output tile goes back through the warpgroup's own Q rows in shared
//   memory and leaves as 16-byte stores.
// Budget: 256 threads, one block an SM (227 KB of shared memory at hd = 128:
// Q 32 KB + 3 x 64 KB of K/V); O is 64 and S 64 fp32 registers a thread.
// chip_smoke.py's build phase prints what ptxas counted; PERF.md keeps it.
//
// fp32 inputs: flash_attn_fp32_kernel, on the CUDA cores in fp32 (fp32
// storage means fp32 math: no TF32): blocks over (64-row query tile x head x
// batch), Q, K and V tiles in shared memory as fp32, m, l and a 4 x (hd /
// 16) slice of O per thread in registers, P through K's tile.
//
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int SEG_NONE_Q = -2147483647;  // a query row past S matches no key
constexpr int SEG_NONE_K = -2147483646;  // a key past S matches no row

// ------------------------------------------------------------- bf16 ------

constexpr int BLOCK_ROWS = 128;  // (heads of the block) x (query rows each)
constexpr int WBN = 128;         // keys per tile
constexpr int WSTAGES = 3;       // K/V tiles in the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A wgmma operand in shared memory: where it starts, and the two strides
// its layout leaves open. Q and K are read K-major (a row's 64 values are
// 128 contiguous bytes; 8-row groups 1,024 bytes apart: the stride operand),
// V MN-major (the transposed read; its 64-column panels are the leading
// operand apart, its 8-key groups 1,024 bytes).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo_bytes,
                                            uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// The compiler may not move a use of these registers across this point: an
// asynchronous wgmma reads or writes them from its start to its wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
            "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
            "%26, %27, %28, %29, %30, %31}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
            "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
            "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
            "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
            "%62, %63}"

// d (64 x 128) = or += a (64 x 16, shared, K-major) . b (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += a (64 x 16, registers) . b (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_64x128_rs(d, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_64x64_rs(d, a, db);
}

// Byte offset of 16-byte chunk `chunk` (0 .. HD / 8) of row `row` in a tile
// of `rows` rows held as 64-value panels.
__device__ __forceinline__ uint32_t panel(int rows, int row, int chunk) {
  return (uint32_t)((chunk >> 3) * rows * 128 + row * 128 +
                    (((chunk & 7) ^ (row & 7)) << 4));
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ seg,
                        __nv_bfloat16* __restrict__ out, int S, int nh,
                        int nkv, int G, float scale_log2) {
  constexpr int THREADS = 256;
  constexpr int CH = HD / 8;
  constexpr int KS = HD / 16;
  constexpr int NT = WBN / 8;
  constexpr int DT = HD / 8;
  constexpr int TILE = WBN * HD * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  // the panels' swizzle is in the address bits: 1,024-byte aligned bases
  unsigned char* base = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  unsigned char* sq = base;                      // [HD / 64][128][64]
  unsigned char* sk = sq + BLOCK_ROWS * HD * 2;  // [WSTAGES][HD / 64][WBN][64]
  unsigned char* sv = sk + WSTAGES * TILE;       // [WSTAGES][HD / 64][WBN][64]
  int* sseg = reinterpret_cast<int*>(sv + WSTAGES * TILE);  // [WSTAGES][WBN]
  int* sqseg = sseg + WSTAGES * WBN;                         // [128]
  const uint32_t sq_a = smem_u32(sq), sk_a = smem_u32(sk), sv_a = smem_u32(sv);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's number by a broadcast: the compiler then knows that what is
  // decided from it is the same in every lane, and lets wgmma run unfenced
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2;
  const int bmq = BLOCK_ROWS / G;
  // heads in x, query tiles in y from the last down: every head's longest
  // loops are scheduled before any shorter one
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h0 = blockIdx.x * G, b = blockIdx.z;
  const int kvh = h0 / (nh / nkv);
  const int i0 = qt * bmq;
  const long long q_stride = (long long)nh * HD, kv_stride = (long long)nkv * HD;
  const __nv_bfloat16* kb = k + (long long)b * S * kv_stride + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * S * kv_stride + (long long)kvh * HD;
  const int* segb = seg + (long long)b * S;

  for (int e = tid; e < BLOCK_ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const int i = i0 + r % bmq;
    const bool live = i < S;
    const __nv_bfloat16* src =
        q + ((long long)b * S + i) * q_stride + (long long)(h0 + r / bmq) * HD + c * 8;
    cp_async16(sq_a + panel(BLOCK_ROWS, r, c), live ? src : q, live ? 16 : 0);
  }
  if (tid < BLOCK_ROWS) {
    const int i = i0 + tid % bmq;
    sqseg[tid] = i < S ? segb[i] : SEG_NONE_Q;
  }
  const int kv_end = min(S, i0 + bmq);
  const int n_tiles = (kv_end + WBN - 1) / WBN;
  // K/V tile loads: this thread's 16-byte chunk column and first row, its
  // offsets in global and in shared memory worked out once (rows RPP apart
  // share row % 8, so the swizzled offset only steps by whole rows)
  constexpr int RPP = THREADS / CH;  // rows a pass of the block
  const int lr0 = tid / CH, lc = tid % CH;
  const long long g_off0 = (long long)lr0 * kv_stride + lc * 8;
  const long long g_step = (long long)RPP * kv_stride;
  const uint32_t s_off0 = panel(WBN, lr0, lc);
  // one commit group a call, also where no tile is left: the waits count groups
  auto load_kv = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % WSTAGES, j0 = t * WBN;
      const __nv_bfloat16* kp = kb + (long long)j0 * kv_stride + g_off0;
      const __nv_bfloat16* vp = vb + (long long)j0 * kv_stride + g_off0;
      uint32_t dst = stage * TILE + s_off0;
      int left = S - j0 - lr0;  // rows from this thread's first to the end
#pragma unroll
      for (int i = 0; i < WBN / RPP; ++i) {
        const bool live = left > 0;
        cp_async16(sk_a + dst, live ? kp : kb, live ? 16 : 0);
        cp_async16(sv_a + dst, live ? vp : vb, live ? 16 : 0);
        kp += g_step;
        vp += g_step;
        dst += RPP * 128;
        left -= RPP;
      }
      if (tid < WBN) {
        if (j0 + tid < S)
          cp_async4(smem_u32(sseg + stage * WBN + tid), segb + j0 + tid);
        else
          sseg[stage * WBN + tid] = SEG_NONE_K;
      }
    }
    cp_async_commit();
  };
  // tiles 0 .. WSTAGES - 3 ahead; iteration t adds tile t + WSTAGES - 2, into
  // the stage of tile t - 2, whose P.V ended in iteration t - 1
#pragma unroll
  for (int t = 0; t < WSTAGES - 2; ++t) load_kv(t);

  // this warpgroup: block rows [64 wg, 64 wg + 64); this warp 16 of them;
  // this thread rows lane / 4 and lane / 4 + 8 of those
  const int rb = wg * 64 + (warp & 3) * 16;
  const int gq0 = i0 + (wg * 64) % bmq;  // the warpgroup's first query
  int qrow[2], segq[2];
  float m[2], l[2], o[DT * 4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    qrow[hf] = i0 + (rb + hf * 8 + (lane >> 2)) % bmq;
    segq[hf] = qrow[hf] < S ? segb[qrow[hf]] : SEG_NONE_Q;
    m[hf] = -CUDART_INF_F;
    l[hf] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DT * 4; ++e) o[e] = 0.f;

  // Iteration t starts Q.K^T of tile t and then P.V of tile t - 1, and takes
  // the softmax of tile t while that P.V runs on the tensor cores. No wgmma
  // stands under a condition on data: the compiler fences every wgmma of a
  // path it cannot prove the same for the whole warp, one after another.
  uint32_t pa[WBN / 16][4];  // P of the tile before, waiting for its P.V
  float s[NT * 4], alpha[2];
  auto tile_arrives = [&](int t) {
    asm volatile("cp.async.wait_group %0;" ::"n"(WSTAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // tile t has landed; every warp is done with tile t - 2
    load_kv(t + WSTAGES - 2);
  };
  auto start_qk = [&](int t) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t in_panel = (ks & 3) * 32;
      wgmma_64x128_ss(
          s,
          wg_desc(sq_a + (ks >> 2) * BLOCK_ROWS * 128 + wg * 64 * 128 + in_panel,
                  16, 1024),
          wg_desc(sk_a + (t % WSTAGES) * TILE + (ks >> 2) * WBN * 128 + in_panel,
                  16, 1024),
          ks > 0);
    }
    wg_commit();
  };
  auto start_pv = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < WBN / 16; ++kk)
      wgmma_pv(o, pa[kk],
               wg_desc(sv_a + (t % WSTAGES) * TILE + kk * 16 * 128, WBN * 128, 1024));
    wg_commit();
  };
  // masks, running max and sum of tile t on the scores in s; p overwrites s
  auto softmax = [&](int t) {
    const int stage = t % WSTAGES, j0 = t * WBN;
    // The tile's 128 key segments against the warpgroup's 64 rows: a tile of
    // one segment that every row shares needs no compare off the diagonal.
    const int4 ksegs = *reinterpret_cast<const int4*>(sseg + stage * WBN + lane * 4);
    const int seg_0 = __shfl_sync(0xffffffffu, ksegs.x, 0);
    const int row_a = sqseg[wg * 64 + lane], row_b = sqseg[wg * 64 + 32 + lane];
    const bool plain = __all_sync(
        0xffffffffu, ksegs.x == seg_0 && ksegs.y == seg_0 && ksegs.z == seg_0 &&
                         ksegs.w == seg_0 && row_a == seg_0 && row_b == seg_0);
    if (j0 + WBN - 1 > gq0 || !plain) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int2 kseg = *reinterpret_cast<const int2*>(
            sseg + stage * WBN + nt * 8 + (lane & 3) * 2);
        const int key = j0 + nt * 8 + (lane & 3) * 2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!(kseg.x == segq[hf] && key <= qrow[hf])) s[nt * 4 + hf * 2] = -CUDART_INF_F;
          if (!(kseg.y == segq[hf] && key + 1 <= qrow[hf])) s[nt * 4 + hf * 2 + 1] = -CUDART_INF_F;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mxr = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mxr = fmaxf(mxr, fmaxf(s[nt * 4 + hf * 2], s[nt * 4 + hf * 2 + 1]));
      mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 1));
      mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 2));
      const float m_new = fmaxf(m[hf], mxr * scale_log2);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[hf] = ex2(m[hf] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = ex2(fmaf(s[nt * 4 + hf * 2], scale_log2, -m_safe));
        const float p1 = ex2(fmaf(s[nt * 4 + hf * 2 + 1], scale_log2, -m_safe));
        s[nt * 4 + hf * 2] = p0;
        s[nt * 4 + hf * 2 + 1] = p1;
        rs += p0 + p1;
      }
      l[hf] = l[hf] * alpha[hf] + rs;
      m[hf] = m_new;
    }
  };
  // O takes the new maximum's scale and P is rounded to bf16, in registers
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        o[dt * 4 + hf * 2] *= alpha[hf];
        o[dt * 4 + hf * 2 + 1] *= alpha[hf];
      }
#pragma unroll
    for (int kk = 0; kk < WBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[(2 * kk) * 4 + 0], s[(2 * kk) * 4 + 1]);
      pa[kk][1] = pack_bf16(s[(2 * kk) * 4 + 2], s[(2 * kk) * 4 + 3]);
      pa[kk][2] = pack_bf16(s[(2 * kk + 1) * 4 + 0], s[(2 * kk + 1) * 4 + 1]);
      pa[kk][3] = pack_bf16(s[(2 * kk + 1) * 4 + 2], s[(2 * kk + 1) * 4 + 3]);
    }
  };

  // The two warpgroups take the same tiles half an iteration apart, so that
  // one's softmax runs while the other's products hold the tensor cores:
  // warpgroup 0 takes the softmax of tile t right after its products, in
  // iteration t; warpgroup 1 carries the scores over the barrier and takes
  // it at the start of iteration t + 1, before it starts its own products.
  auto fence_pa = [&]() {
#pragma unroll
    for (int kk = 0; kk < WBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
  };
  tile_arrives(0);
  keep(s);
  wg_fence();
  start_qk(0);
  wg_wait<0>();
  keep(s);
  if (wg == 0) {
    softmax(0);
    rescale_and_pack();
  }
  for (int t = 1; t < n_tiles; ++t) {
    tile_arrives(t);
    if (wg == 1) {
      softmax(t - 1);
      rescale_and_pack();
    }
    keep(s);
    keep(o);
    fence_pa();
    wg_fence();
    start_qk(t);
    start_pv(t - 1);
    wg_wait<1>();  // Q.K^T, the older group
    keep(s);
    if (wg == 0) softmax(t);  // while P.V of tile t - 1 runs
    wg_wait<0>();             // it has read pa and written o
    fence_pa();
    keep(o);
    if (wg == 0) rescale_and_pack();
  }
  if (wg == 1) {
    softmax(n_tiles - 1);
    rescale_and_pack();
  }
  keep(o);
  fence_pa();
  wg_fence();
  start_pv(n_tiles - 1);
  wg_wait<0>();
  keep(o);

  // the warpgroup is done reading its Q rows: O / l goes back through them
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / sum;
    const int r = rb + hf * 8 + (lane >> 2);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(sq + panel(BLOCK_ROWS, r, dt) + (lane & 3) * 4) =
          pack_bf16(o[dt * 4 + hf * 2] * inv, o[dt * 4 + hf * 2 + 1] * inv);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = rb + e / CH, c = e % CH;
    const int i = i0 + r % bmq;
    if (i < S)
      *reinterpret_cast<uint4*>(out + ((long long)b * S + i) * q_stride +
                                (long long)(h0 + r / bmq) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(sq + panel(BLOCK_ROWS, r, c));
  }
}

#undef D8
#undef R32
#undef R64

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const int* seg,
                void* out, int B, int S, int nh, int nkv, float scale,
                cudaStream_t stream) {
  // the heads of a kv group that share a block: a divisor of the group
  const int rep = nh / nkv;
  const int G = rep % 4 == 0 ? 4 : rep % 2 == 0 ? 2 : 1;
  const int bmq = BLOCK_ROWS / G;
  // Q, the ring, the key and row segments, and room to align the panels
  const int smem = BLOCK_ROWS * HD * 2 + 2 * WSTAGES * WBN * HD * 2 +
                   (WSTAGES * WBN + BLOCK_ROWS) * (int)sizeof(int) + 1024;
  static int allowed[MAX_DEVICES] = {};  // this instance's, by device
  cudaError_t err = allow_smem(allowed, flash_attn_wgmma_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh / G, (S + bmq - 1) / bmq, B);
  flash_attn_wgmma_kernel<HD><<<grid, 256, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out),
      S, nh, nkv, G, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- fp32 ------

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int RPT = 4;        // query rows per thread: ty * 4 + i
constexpr int CPT = 4;        // score columns per thread: tx + 16 j
constexpr int PPITCH = BN + 4;

// Rows [row0, row0 + n_rows) of a (., stride) matrix -> dst[r][0..HD) with
// `pitch` floats a row; rows at or past `n_live` become zeros.
template <int HD>
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const float* src, long long stride,
                                           int n_rows, int n_live) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < n_rows * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_live) val = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fp32_kernel(const float* __restrict__ q,    // (B, S, nh, HD)
                       const float* __restrict__ k,    // (B, S, nkv, HD)
                       const float* __restrict__ v,    // (B, S, nkv, HD)
                       const int* __restrict__ seg,    // (B, S)
                       float* __restrict__ out,        // (B, S, nh, HD)
                       int S, int nh, int nkv, float scale) {
  constexpr int PITCH = HD + 4;  // rows 33 (17) float4s apart: no conflicts
  constexpr int OG = HD / 64;    // 64-column groups of O: columns g*64 + tx*4
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [BM][PITCH]
  float* sk = sq + BM * PITCH;   // [BN][PITCH], then P as [BM][PPITCH]
  float* sv = sk + BN * PITCH;   // [BN][HD]
  int* sseg = reinterpret_cast<int*>(sv + BN * HD);  // [BN]
  float* sp = sk;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / nkv);
  const int i0 = qt * BM;
  const int q_live = min(BM, S - i0);
  const long long q_stride = (long long)nh * HD, kv_stride = (long long)nkv * HD;
  const float* qb = q + ((long long)b * S + i0) * q_stride + (long long)h * HD;
  const float* kb = k + (long long)b * S * kv_stride + (long long)g * HD;
  const float* vb = v + (long long)b * S * kv_stride + (long long)g * HD;
  const int* segb = seg + (long long)b * S;

  stage_tile<HD>(sq, PITCH, qb, q_stride, BM, q_live);
  int segq[RPT];
  float m[RPT], l[RPT], o[RPT][OG * 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = i0 + ty * RPT + i;
    segq[i] = row < S ? segb[row] : SEG_NONE_Q;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OG * 4; ++c) o[i][c] = 0.f;
  }

  const int kv_end = min(S, i0 + BM);  // keys past the tile's last row are causal-dead
  for (int j0 = 0; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's P and V have been consumed
    const int k_live = min(BN, S - j0);
    stage_tile<HD>(sk, PITCH, kb + j0 * kv_stride, kv_stride, BN, k_live);
    stage_tile<HD>(sv, HD, vb + j0 * kv_stride, kv_stride, BN, k_live);
    if (tid < BN) sseg[tid] = tid < k_live ? segb[j0 + tid] : SEG_NONE_K;
    __syncthreads();

    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[RPT], bb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (ty * RPT + i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        bb[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * PITCH + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
        }
    }

    // mask, then the online softmax of each row over this tile. A row whose
    // keys so far are all masked (a real row of a left-padded sequence sees
    // pad-only tiles first) keeps m = -inf: the exponentials are taken
    // against 0 then, so they are exp(-inf) = 0 and never exp(-inf + inf).
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = i0 + ty * RPT + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = (j0 + c <= row) && (sseg[c] == segq[i]);
        acc[i][j] = ok ? acc[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, acc[i][j]);
      }
#pragma unroll
      for (int s = 8; s >= 1; s >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = __expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[i][j] = __expf(acc[i][j] - m_safe);
        rs += acc[i][j];
      }
#pragma unroll
      for (int s = 8; s >= 1; s >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, s);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OG * 4; ++c) o[i][c] *= alpha;
    }

    __syncthreads();  // every thread has taken its scores from the K tile
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sp[(ty * RPT + i) * PPITCH + tx + 16 * j] = acc[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BN; kk += 4) {
      float4 p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p[i] = *reinterpret_cast<const float4*>(sp + (ty * RPT + i) * PPITCH + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < OG; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sv + (kk + t) * HD + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float pi = t == 0 ? p[i].x : t == 1 ? p[i].y : t == 2 ? p[i].z : p[i].w;
            o[i][c * 4 + 0] = fmaf(pi, vv.x, o[i][c * 4 + 0]);
            o[i][c * 4 + 1] = fmaf(pi, vv.y, o[i][c * 4 + 1]);
            o[i][c * 4 + 2] = fmaf(pi, vv.z, o[i][c * 4 + 2]);
            o[i][c * 4 + 3] = fmaf(pi, vv.w, o[i][c * 4 + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    if (r >= q_live) continue;
    const float inv = 1.0f / l[i];  // l > 0: key j = i is always allowed
    float* dst = out + ((long long)b * S + i0 + r) * q_stride + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < OG; ++c)
      *reinterpret_cast<float4*>(dst + c * 64 + tx * 4) =
          make_float4(o[i][c * 4] * inv, o[i][c * 4 + 1] * inv,
                      o[i][c * 4 + 2] * inv, o[i][c * 4 + 3] * inv);
  }
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, const int* seg,
                void* out, int B, int S, int nh, int nkv, float scale,
                cudaStream_t stream) {
  const int smem =
      (BM * (HD + 4) + BN * (HD + 4) + BN * HD) * (int)sizeof(float) +
      BN * (int)sizeof(int);
  static int allowed[MAX_DEVICES] = {};  // this instance's, by device
  cudaError_t err = allow_smem(allowed, flash_attn_fp32_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BM - 1) / BM, nh, B);
  flash_attn_fp32_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(out), S, nh, nkv,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, S, nh, hd); k, v: (B, S, nkv, hd); seg: (B, S) int32, all
// contiguous and 16-byte aligned. is_bf16 selects the tensor-core kernel
// over the fp32 one; hd is 64 or 128.
int flash_attention(const void* q, const void* k, const void* v,
                    const int* seg, void* out, int B, int S, int nh, int nkv,
                    int hd, int is_bf16, float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || nh < 1 || nkv < 1 || nh % nkv != 0 || nh > 65535 ||
      B > 65535 || (hd != 64 && hd != 128) || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return hd == 128
        ? launch_bf16<128>(q, k, v, seg, out, B, S, nh, nkv, scale, stream)
        : launch_bf16<64>(q, k, v, seg, out, B, S, nh, nkv, scale, stream);
  return hd == 128
      ? launch_fp32<128>(q, k, v, seg, out, B, S, nh, nkv, scale, stream)
      : launch_fp32<64>(q, k, v, seg, out, B, S, nh, nkv, scale, stream);
}

}  // extern "C"
