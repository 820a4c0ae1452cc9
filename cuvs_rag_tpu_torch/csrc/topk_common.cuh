// Device code shared by the top-k kernels of flat_topk.cu and ivf_scan.cu:
// element loads as fp32, the warp-held sorted top-k (k <= 32), the per-class
// top-R insertion chain of the certified large-k kernels (K3, K5) and the
// merge of their splits, and the merge pass that reduces per-block partials
// to one sorted top-k per query.
// Everything has internal linkage: each .cu file compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>

#include "ring.cuh"

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
// IDT is the planes' id type (int rows or positions; uint16_t tile numbers).
template <typename IDT>
__device__ __forceinline__ float chain_insert(float* ps, IDT* pi, int stride,
                                              int r_planes, float cand, IDT cid,
                                              float& last) {
  for (int r = 0; r < r_planes; ++r) {
    const float b = ps[r * stride];
    if (cand > b) {
      const IDT bi = pi[r * stride];
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

// K3's and K5's merge of their splits. Each class keeps the R best of the
// union of the splits' planes, and its rej becomes the max of the splits'
// rej values and of every value the merge displaced, so max(rej) < tau
// still proves the collected top-k exact. Each split's planes are sorted,
// so the first value that cannot enter ends that split (it is the best of
// the rest). A block takes MERGE_CLASSES classes with `groups` threads
// each: thread (class c, group g) first merges splits g, g + groups, ...
// into its own planes in shared memory ([R][groups x MERGE_CLASSES] scores,
// then ids, then the groups' rej), reading a split's planes four at a time;
// then group 0 merges the other groups' planes, which are sorted too, from
// shared memory. So a class's splits are read by `groups` threads at once
// and no chain waits on device memory (one thread a class left the merge
// latency-bound: half of K5's device time at one query). Partials (S, n_q,
// R, W) and (S, n_q, W); output planes (n_q, R, W) with the validity rule
// applied, rej (n_q, W).
constexpr int MERGE_CLASSES = 128;
constexpr int MERGE_GROUPS = 8;

__global__ void __launch_bounds__(MERGE_CLASSES * MERGE_GROUPS) topr_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    const float* __restrict__ part_rej, int n_q, int n_splits, int w,
    int r_planes, int groups, float* __restrict__ out_s,
    int* __restrict__ out_i, float* __restrict__ out_rej) {
  extern __shared__ float merge_smem[];
  const int cl = threadIdx.x % MERGE_CLASSES, g = threadIdx.x / MERGE_CLASSES;
  const int stride = groups * MERGE_CLASSES;  // between planes of a thread
  float* ps = merge_smem + g * MERGE_CLASSES + cl;
  int* pi = reinterpret_cast<int*>(merge_smem + r_planes * stride) + g * MERGE_CLASSES + cl;
  float* s_rej = merge_smem + 2 * r_planes * stride;  // [groups][MERGE_CLASSES]
  const long long e = (long long)blockIdx.x * MERGE_CLASSES + cl;
  const bool live = e < (long long)n_q * w;
  const int qq = (int)(e / w), c = (int)(e % w);
  for (int r = 0; r < r_planes; ++r) {
    ps[r * stride] = neg_inf();
    pi[r * stride] = -1;
  }
  float last = neg_inf(), rej = neg_inf();
  for (int s = g; live && s < n_splits; s += groups) {
    rej = fmaxf(rej, part_rej[((long long)s * n_q + qq) * w + c]);
    const long long o = ((long long)s * n_q + qq) * r_planes * w + c;
    bool done = false;
    for (int r0 = 0; r0 < r_planes && !done; r0 += 4) {
      float v[4];
      int id[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = r0 + u < r_planes;
        v[u] = in ? part_s[o + (long long)(r0 + u) * w] : neg_inf();
        id[u] = in ? part_i[o + (long long)(r0 + u) * w] : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (done) continue;
        if (!(v[u] > last)) {
          rej = fmaxf(rej, v[u]);
          done = true;
        } else {
          rej = fmaxf(rej, chain_insert(ps, pi, stride, r_planes, v[u], id[u],
                                        last));
        }
      }
    }
  }
  s_rej[g * MERGE_CLASSES + cl] = rej;
  __syncthreads();  // every group's planes are done
  if (g != 0 || !live) return;
  for (int h = 1; h < groups; ++h) {
    rej = fmaxf(rej, s_rej[h * MERGE_CLASSES + cl]);
    const float* hs = ps + h * MERGE_CLASSES;
    const int* hi = pi + h * MERGE_CLASSES;
    for (int r = 0; r < r_planes; ++r) {
      const float v = hs[r * stride];
      if (!(v > last)) {
        rej = fmaxf(rej, v);
        break;
      }
      rej = fmaxf(rej, chain_insert(ps, pi, stride, r_planes, v, hi[r * stride],
                                    last));
    }
  }
  const long long o = (long long)qq * r_planes * w + c;
  for (int r = 0; r < r_planes; ++r) {
    const float sc = ps[r * stride];
    const bool ok = sc > VALID_MIN;
    out_s[o + (long long)r * w] = ok ? sc : neg_inf();
    out_i[o + (long long)r * w] = ok ? pi[r * stride] : -1;
  }
  out_rej[e] = rej;
}

// Launches topr_merge_kernel over the n_q x w classes, as many groups a
// class (<= MERGE_GROUPS, <= n_splits) as the planes' shared memory allows;
// returns the launch's error.
inline cudaError_t launch_topr_merge(const float* part_s, const int* part_i,
                                     const float* part_rej, int n_q,
                                     int n_splits, int w, int r_planes,
                                     float* out_s, int* out_i, float* out_rej,
                                     cudaStream_t stream) {
  const int group_bytes = MERGE_CLASSES * (r_planes * 8 + 4);
  const int groups = std::min(std::min(MERGE_GROUPS, n_splits), MAX_SMEM / group_bytes);
  if (groups < 1) return cudaErrorInvalidValue;
  const int smem = groups * group_bytes;
  static int allowed[MAX_DEVICES] = {};  // this source's, by device
  const cudaError_t e = allow_smem(allowed, topr_merge_kernel, smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)n_q * w;
  topr_merge_kernel<<<(unsigned)((n + MERGE_CLASSES - 1) / MERGE_CLASSES),
                      groups * MERGE_CLASSES, smem, stream>>>(
      part_s, part_i, part_rej, n_q, n_splits, w, r_planes, groups, out_s,
      out_i, out_rej);
  return cudaGetLastError();
}

}  // namespace
