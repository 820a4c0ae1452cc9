// Device code shared by the top-k kernels of flat_topk.cu and ivf_scan.cu:
// element loads as fp32, the warp-held sorted top-k (k <= 32), the per-class
// top-R insertion chain of the certified large-k kernels, and the merge pass
// that reduces per-block partials to one sorted top-k per query.
// Everything has internal linkage: each .cu file compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float DELETED_THRESHOLD = 1e29f;
constexpr float VALID_MIN = -1e29f;  // a slot scoring <= this is invalid
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const int8_t* p) { return (float)*p; }

// Warp-held sorted top-k (k <= 32): lane l < k holds the l-th best (score,
// id), descending. A candidate enters only if strictly better than the
// current k-th; among equal scores the earlier-offered one stays first.
struct WarpTopK {
  float s;
  int id;
  float thresh;  // the k-th best score (lane k - 1), same in every lane

  __device__ __forceinline__ void init() {
    s = neg_inf();
    id = -1;
    thresh = neg_inf();
  }

  // Offer one candidate per lane; lanes are taken in order 0..31.
  __device__ __forceinline__ void offer(float cand, int cand_id, int k, int lane) {
    unsigned pending = __ballot_sync(FULL, cand > thresh);
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const float cs = __shfl_sync(FULL, cand, src);
      const int ci = __shfl_sync(FULL, cand_id, src);
      if (!(cs > thresh)) continue;  // thresh rose since the ballot
      const int pos = __popc(__ballot_sync(FULL, lane < k && s >= cs));
      const float up_s = __shfl_up_sync(FULL, s, 1);
      const int up_i = __shfl_up_sync(FULL, id, 1);
      if (lane > pos) {
        s = up_s;
        id = up_i;
      } else if (lane == pos) {
        s = cs;
        id = ci;
      }
      thresh = __shfl_sync(FULL, s, k - 1);
    }
  }
};

// Insertion chain over one (query, class)'s R planes (sorted descending,
// `stride` apart in memory), as in the TPU kernel: a strict > lets the
// candidate in after every plane >= it. Returns the value that fell off the
// end (the candidate itself if it entered nowhere); `last` becomes plane R-1.
__device__ __forceinline__ float chain_insert(float* ps, int* pi, int stride,
                                              int r_planes, float cand, int cid,
                                              float& last) {
  for (int r = 0; r < r_planes; ++r) {
    const float b = ps[r * stride];
    if (cand > b) {
      const int bi = pi[r * stride];
      ps[r * stride] = cand;
      pi[r * stride] = cid;
      cand = b;
      cid = bi;
    }
  }
  last = ps[(r_planes - 1) * stride];
  return cand;
}

// One warp per query: top-k over the n_parts * k partials (n_q, n_parts, k)
// in part order, then the validity rule (score <= -1e29 -> -inf / -1).
__global__ void merge_partials_kernel(const float* __restrict__ part_s,
                                      const int* __restrict__ part_i, int n_q,
                                      int n_parts, int k, float* __restrict__ out_s,
                                      int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int qq = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qq >= n_q) return;  // whole warp exits together
  WarpTopK top;
  top.init();
  const long long n = (long long)n_parts * k;
  const long long base = (long long)qq * n;
  for (long long e0 = 0; e0 < n; e0 += 32) {
    const long long e = e0 + lane;
    const float c = e < n ? part_s[base + e] : neg_inf();
    const int ci = e < n ? part_i[base + e] : -1;
    top.offer(c, ci, k, lane);
  }
  if (lane < k) {
    const bool ok = top.s > VALID_MIN;
    out_s[(long long)qq * k + lane] = ok ? top.s : neg_inf();
    out_i[(long long)qq * k + lane] = ok ? top.id : -1;
  }
}

}  // namespace
