// Causal flash attention with a segment-id pad mask on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel the Qwen3 encoder calls at
// cuvs_rag_tpu/models/flax_qwen.py:157:
//   K7  jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
//       (causal=True, segment_ids = the attention mask)  ->  flash_attn_kernel
//
// out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, g, :])
//                   * v[b, j, g, :],   g = h / (nh / nkv),
// over the keys j <= i with seg[b, j] == seg[b, i] (the TPU kernel's segment
// rule: pad rows attend pad rows). Every row allows j = i, so the softmax
// denominator is never 0 and no row of the output is NaN. q and out are
// (B, S, nh, hd), k and v (B, S, nkv, hd): the projections' own layout, so
// the TPU path's two moveaxis round trips and its materialized GQA repeat
// have no counterpart here. Scores, the running max, the denominator and
// the output accumulator are fp32; probabilities stay fp32 into P.V.
//
// The TPU grid walked 1024-wide kv blocks one after another with its state
// in VMEM. Here blocks over (64-row query tile x head x batch) run in
// parallel; each loops over 64-row kv tiles up to its own causal limit (the
// loop bound does the causal skip), keeps Q, K and V tiles in shared memory
// as fp32, and holds m, l and a 4 x (hd / 16) slice of O per thread in
// registers. The score tile P reuses the K tile's shared memory once the
// scores are taken. The heaviest query tiles are scheduled first. Any S:
// ragged tiles are masked, not required to divide.
//
// What bounds it on the H100: operations. One layer at S = 8192, 16 heads,
// hd = 128 is 0.275 TFLOP after the causal skip against 0.10 GB of q, k, v
// and out. This first version multiplies on the CUDA cores in fp32 (exact
// products of bf16 operands), four float4 shared-memory loads per 64 FMAs,
// so it runs at a fraction of the 67 TFLOP/s fp32 peak and far under the
// tensor cores' 989 TFLOP/s that bound it. mma.sync / wgmma on bf16 tiles,
// K/V shared by the query heads of one kv group and TMA loads are later
// work.
//
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int RPT = 4;        // query rows per thread: ty * 4 + i
constexpr int CPT = 4;        // score columns per thread: tx + 16 j
constexpr int PPITCH = BN + 4;
constexpr int SEG_NONE_Q = -2147483647;  // a query row past S matches no key
constexpr int SEG_NONE_K = -2147483646;  // a key past S matches no row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [row0, row0 + n_rows) of a (., stride) matrix -> dst[r][0..HD) as
// fp32 with `pitch` floats a row; rows at or past `n_live` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, int pitch, const T* src,
                                           long long stride, int n_rows,
                                           int n_live) {
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < n_rows * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_live) val = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_kernel(const T* __restrict__ q,      // (B, S, nh, HD)
                  const T* __restrict__ k,      // (B, S, nkv, HD)
                  const T* __restrict__ v,      // (B, S, nkv, HD)
                  const int* __restrict__ seg,  // (B, S)
                  T* __restrict__ out,          // (B, S, nh, HD)
                  int S, int nh, int nkv, float scale) {
  constexpr int PITCH = HD + 4;  // rows 33 (17) float4s apart: no conflicts
  constexpr int OG = HD / 64;    // 64-column groups of O: columns g*64 + tx*4
  extern __shared__ float smem[];
  float* sq = smem;              // [BM][PITCH]
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
  const T* qb = q + ((long long)b * S + i0) * q_stride + (long long)h * HD;
  const T* kb = k + (long long)b * S * kv_stride + (long long)g * HD;
  const T* vb = v + (long long)b * S * kv_stride + (long long)g * HD;
  const int* segb = seg + (long long)b * S;

  stage_tile<T, HD>(sq, PITCH, qb, q_stride, BM, q_live);
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
    stage_tile<T, HD>(sk, PITCH, kb + j0 * kv_stride, kv_stride, BN, k_live);
    stage_tile<T, HD>(sv, HD, vb + j0 * kv_stride, kv_stride, BN, k_live);
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
    T* dst = out + ((long long)b * S + i0 + r) * q_stride + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < OG; ++c)
      store4(dst + c * 64 + tx * 4,
             make_float4(o[i][c * 4] * inv, o[i][c * 4 + 1] * inv,
                         o[i][c * 4 + 2] * inv, o[i][c * 4 + 3] * inv));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* out, int B, int S, int nh, int nkv, float scale,
           cudaStream_t stream) {
  const int smem =
      (BM * (HD + 4) + BN * (HD + 4) + BN * HD) * (int)sizeof(float) +
      BN * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BM - 1) / BM, nh, B);
  flash_attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), S, nh, nkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, S, nh, hd); k, v: (B, S, nkv, hd); seg: (B, S) int32, all
// contiguous. is_bf16 selects __nv_bfloat16 over float; hd is 64 or 128.
int flash_attention(const void* q, const void* k, const void* v,
                    const int* seg, void* out, int B, int S, int nh, int nkv,
                    int hd, int is_bf16, float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || nh < 1 || nkv < 1 || nh % nkv != 0 || nh > 65535 ||
      B > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return hd == 128
        ? launch<__nv_bfloat16, 128>(q, k, v, seg, out, B, S, nh, nkv, scale, stream)
        : launch<__nv_bfloat16, 64>(q, k, v, seg, out, B, S, nh, nkv, scale, stream);
  return hd == 128
      ? launch<float, 128>(q, k, v, seg, out, B, S, nh, nkv, scale, stream)
      : launch<float, 64>(q, k, v, seg, out, B, S, nh, nkv, scale, stream);
}

}  // extern "C"
