// The CAGRA beam on Hopper (sm_90a): its two steps an iteration of
// ops/graph.beam_search, one launch each. The candidate step
// (cagra_candidates_kernel) is described first; the merge and next picks
// (cagra_merge_kernel) after it.
//
// The candidate step: one launch an iteration, and one for the entry rows.
//
// Replaces no TPU kernel: the JAX package's beam (ops/graph.py) is XLA
// ops. On the card the step was ~20 PyTorch launches an iteration (the
// graph-row gather, the row gather, a widening copy of every gathered bf16
// row to fp32, a gemv, the in-beam `any`, earlier_copy's sort and scatter,
// the masks), and it moved three times the bytes the beam reads: the
// widened rows went out to device memory and back.
//
// What it computes, for query q with parents P (e of them, each with its
// pick score s) or with given candidate ids (the entry step), and the
// beam's b ids B:
//   cand[j]  = graph[max(P[j / G], 0)][j % G]   (or the given ids)
//   score[j] = sum over lanes of row[cand[j]] * aq[q]: fp32 products of
//              the stored values and the fp32 query, summed in fp32
//   score[j] = -inf where the parent's s is not above `s_floor` (a
//              tombstoned or empty pick), where cand[j] is one of B, or
//              where an earlier position j' < j holds the same id
// and writes cand (the news ids) and score: what the merge takes.
//
// What bounds it: bytes, the gathered rows read once (1,792 bytes a bf16
// row of 896 lanes, a few fp32 FMAs a byte). The design:
//   * The grid's blocks split the (query, candidate) positions evenly, so
//     no block waits on a short last wave: a block walks its range one
//     query's segment at a time. The wrapper sizes the grid to the blocks
//     the card holds at once.
//   * Earlier copies, and the beam's ids, in shared memory: the beam's
//     ids, then the candidates', as one list, so that both masks are "an
//     earlier position holds the same id". Rounds of a hash table whose
//     slots keep the least position hashed there (atomicMin: the result
//     does not depend on the order of the inserts; a table keyed by
//     atomicCAS cost 25 us a launch at the CAGRA cell's step on an H100):
//     all copies of an id share a slot, so where a slot's least position
//     holds the id, every copy of it is settled, the first and the later
//     ones. The rest (those whose slot another id took first, at most half
//     the slots being filled) go on to the next round with another hash
//     function. Every round settles at least each slot's least position,
//     so the rounds end.
//     A block settles each query it touches, from the positions up to the
//     end of its own, so blocks share nothing.
//   * Masked candidates are never read: only the segment's live rows are
//     gathered, a warp a row with ROWS rows in flight, each lane 16-byte
//     loads of its chunks, the fp32 query of those chunks in registers.
//
// Plain C ABI (built with nvcc, loaded with ctypes): each entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;    // an SM's blocks: at most 128 registers
constexpr int GATHER = 4;        // candidate ids a thread loads at once
constexpr int NONE = 0x7fffffff; // an empty slot: no position hashes there
// a position's state: its id's earlier positions not known yet, none, some
constexpr unsigned char OPEN = 0, FIRST = 1, LATER = 2;
// the limits of a step's ids, held in shared memory: at these, a block's
// tables, ids, live positions and states take 225,280 of the 232,448 bytes
// an H100 block may have
constexpr int MAX_TABLE_BITS = 14;  // 16,384 slots
constexpr int MAX_CANDIDATES = 8192;
constexpr int MAX_BEAM = 4096;

__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// 16 bytes of stored values -> fp32 (exact for both types)
__device__ __forceinline__ void unpack(const uint4& w, __nv_bfloat16, float* f) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& w, float, float* f) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// this lane's chunks c0 + lane + 32 u of a query row, as fp32 (0 past the row)
template <int U, int VPC>
__device__ __forceinline__ void load_query(float (&qv)[U][VPC], const float* q,
                                           int c0, int lane, int row_chunks) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + lane + 32 * u;
    const float4* at = reinterpret_cast<const float4*>(q) + c * VPC / 4;
#pragma unroll
    for (int v = 0; v < VPC; v += 4) {
      const float4 f = c < row_chunks ? at[v / 4] : make_float4(0, 0, 0, 0);
      qv[u][v] = f.x;
      qv[u][v + 1] = f.y;
      qv[u][v + 2] = f.z;
      qv[u][v + 3] = f.w;
    }
  }
}

// the slot of an id in a table of 2^bits, another function each round
__device__ __forceinline__ unsigned slot_of(int id, int round, int bits) {
  const unsigned x = (unsigned)id ^ ((unsigned)id >> 15);
  return (x * (2654435761u + 0x6d2b79f6u * (unsigned)round)) >> (32 - bits);
}

// Shared memory (dynamic): table[2][1 << bits] (ints), ids[b + m] (the
// beam's ids, then the candidates': a candidate's earlier copies and its
// beam ids are all earlier positions there), live[live_cap] (candidate
// positions left to score), state[b + m] (bytes).
// U: 16-byte chunks a lane loads of a row at once; ROWS: rows a warp keeps
// in flight. A row is at most 32 U chunks, or LONG: a row of any length,
// scored in pieces of 32 U chunks, each piece's query chunks read again
// (from L1) for every row, since a whole row's would not fit the registers.
template <typename T, int U, int ROWS, bool LONG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cagra_candidates_kernel(const void* __restrict__ stored, int width,
                        const int* __restrict__ graph, int degree,
                        const int* __restrict__ src, long long src_stride,
                        const float* __restrict__ src_s, long long s_stride,
                        float s_floor, const int* __restrict__ beam, int b,
                        const float* __restrict__ aq, int n_q, int m,
                        int bits, int live_cap, int* __restrict__ nbrs,
                        float* __restrict__ scores) {
  constexpr int VPC = 16 / sizeof(T);  // values a chunk
  const T* rows = static_cast<const T*>(stored);
  extern __shared__ int smem[];
  int* tables = smem;
  int* ids = tables + (2 << bits);
  int* live = ids + b + m;
  unsigned char* state = reinterpret_cast<unsigned char*>(live + live_cap);
  __shared__ int n_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_chunks = width / VPC;
  const long long total = (long long)n_q * m;
  const long long end = (blockIdx.x + 1) * total / gridDim.x;

  for (long long s = blockIdx.x * total / gridDim.x; s < end;) {
    const int q = (int)(s / m);
    const int p0 = (int)(s - (long long)q * m);
    const int p1 = (int)min((long long)m, p0 + (end - s));
    const int n_ids = b + p1;  // the positions this segment's answers need
    s += p1 - p0;

    // this lane's chunks of the query, kept for every row it scores (a
    // LONG row's are read piece by piece below)
    const float* my_q = aq + (long long)q * width;
    float qv[U][VPC];
    if (!LONG) load_query(qv, my_q, 0, lane, row_chunks);
    for (int i = tid; i < (2 << bits); i += THREADS) tables[i] = NONE;
    if (tid == 0) n_live = 0;
    __syncthreads();

    // the beam's ids and the candidates' up to the segment's end, each
    // position into the first round's table
    const int* my_src = src + q * src_stride;
    for (int i0 = tid; i0 < n_ids; i0 += GATHER * THREADS) {
      int id[GATHER];
#pragma unroll
      for (int g = 0; g < GATHER; ++g) {
        const int i = i0 + g * THREADS, j = i - b;
        if (i >= n_ids)
          id[g] = -1;
        else if (j < 0)
          id[g] = beam[(long long)q * b + i];
        else if (graph != nullptr)
          id[g] = graph[(long long)max(my_src[j / degree], 0) * degree +
                        j % degree];
        else
          id[g] = my_src[j];
      }
#pragma unroll
      for (int g = 0; g < GATHER; ++g) {
        const int i = i0 + g * THREADS;
        if (i >= n_ids) continue;
        ids[i] = id[g];
        state[i] = id[g] < 0 ? FIRST : OPEN;
        if (id[g] >= 0) atomicMin(&tables[slot_of(id[g], 0, bits)], i);
      }
    }
    __syncthreads();

    // rounds: a slot's least position p is its id's first copy, since all
    // copies share the slot; every position of the slot holding that id is
    // settled (the first, or a later copy). The rest go on to the next
    // round's table and hash function, which the round clears.
    for (int round = 0;; ++round) {
      const int* table = tables + ((round & 1) << bits);
      int* next = tables + ((~round & 1) << bits);
      bool open = false;
      for (int i = tid; i < n_ids; i += THREADS) {
        if (state[i] != OPEN) continue;
        const int first = table[slot_of(ids[i], round, bits)];
        if (ids[first] == ids[i])
          state[i] = first < i ? LATER : FIRST;
        else
          open = true;
      }
      for (int i = tid; i < (1 << bits); i += THREADS) next[i] = NONE;
      if (!__syncthreads_or(open)) break;
      for (int i = tid; i < n_ids; i += THREADS)
        if (state[i] == OPEN)
          atomicMin(&next[slot_of(ids[i], round + 1, bits)], i);
      __syncthreads();
    }

    // the segment: ids out, masks, and the rows left to score
    for (int p = p0 + tid; p < p1; p += THREADS) {
      const int id = ids[b + p];
      nbrs[(long long)q * m + p] = id;
      if (id < 0 || state[b + p] == LATER ||
          (src_s != nullptr && !(src_s[q * s_stride + p / degree] > s_floor)))
        scores[(long long)q * m + p] = -CUDART_INF_F;
      else
        live[atomicAdd(&n_live, 1)] = b + p;
    }
    __syncthreads();

    // warp w scores live rows ROWS w .. ROWS w + ROWS - 1, then moves on
    const int n = n_live;
    const int row_end = LONG ? row_chunks : 32 * U;  // one piece unless LONG
    for (int r0 = ROWS * warp; r0 < n; r0 += ROWS * WARPS) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int c0 = 0; c0 < row_end; c0 += 32 * U) {
        if (LONG) load_query(qv, my_q, c0, lane, row_chunks);
        uint4 w[ROWS][U];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint4* row = reinterpret_cast<const uint4*>(
              rows + (long long)ids[live[min(r0 + r, n - 1)]] * width);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (r0 + r < n && c0 + lane + 32 * u < row_chunks)
              w[r][u] = ld16(row + c0 + lane + 32 * u);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (r0 + r >= n || c0 + lane + 32 * u >= row_chunks) continue;
            float f[VPC];
            unpack(w[r][u], T(), f);
#pragma unroll
            for (int v = 0; v < VPC; ++v)
              acc[r] = fmaf(f[v], qv[u][v], acc[r]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      float mine = acc[0];
#pragma unroll
      for (int r = 1; r < ROWS; ++r)
        if (lane == r) mine = acc[r];
      if (lane < ROWS && r0 + lane < n)
        scores[(long long)q * m + live[r0 + lane] - b] = mine;
    }
    __syncthreads();  // the next segment rebuilds the table
  }
}

size_t smem_bytes(int m, int b, int bits, int live_cap) {
  return sizeof(int) * ((size_t)(2 << bits) + b + m + live_cap) + b + m;
}

using Kernel = void (*)(const void*, int, const int*, int, const int*,
                        long long, const float*, long long, float, const int*,
                        int, const float*, int, int, int, int, int*, float*);

// the instance for rows of `kind` and `width`: U chunks a lane, ROWS rows a
// warp (one where eight chunks a lane would pass the register budget), and
// rows past 4,096 bytes in pieces of that
template <typename T>
Kernel instance(int row_chunks) {
  if (row_chunks <= 32) return cagra_candidates_kernel<T, 1, 2, false>;
  if (row_chunks <= 64) return cagra_candidates_kernel<T, 2, 2, false>;
  if (row_chunks <= 128) return cagra_candidates_kernel<T, 4, 2, false>;
  if (row_chunks <= 256) return cagra_candidates_kernel<T, 8, 1, false>;
  return cagra_candidates_kernel<T, 8, 1, true>;
}

Kernel instance(int kind, int width) {
  return kind == 0 ? instance<__nv_bfloat16>(width * 2 / 16)
                   : instance<float>(width * 4 / 16);
}

bool bad_rows(int kind, int width) {
  return (kind != 0 && kind != 2) || width < 8 || width % 8 != 0;
}

// ------------------------------------------------------------------------
// The merge and next picks: one launch an iteration of ops/graph.beam_search
// (after the candidate step), and one for the entry beam and its first
// picks.
//
// Replaces no TPU kernel (the JAX package's beam is XLA ops). On the card
// the step was ~16 PyTorch launches an iteration: the masked pick scores, a
// stable sort and a gather for the picks, the flags' scatter, three cats of
// beam and news, a stable sort of the b + m scores and three gathers. The
// work is tiny, ordering b + m numbers a query (1,152 at the CAGRA cell's
// step), so the step is bound by launches and latency, not by bytes: it
// moves at most ~7 KB a query. The design keeps the whole step in one block a
// query and in shared memory, and does as few passes as the order allows:
//   * What it computes, for query q with the beam (b_in slots: scores S
//     sorted descending with ties by position, as a stable sort leaves
//     them, ids, expanded flags) and the news (m scores N, ids):
//       the new beam = the b best of cat(S, N), ties to the lower position
//         (S before N), with their ids and flags (news unexpanded); slots
//         past b_in + m read -inf, id -1, unexpanded;
//       the picks = the e best of the new beam's scores with its expanded
//         slots as -inf, ties to the lower position: their scores (-inf
//         where masked), their ids, and their slots marked expanded.
//     b_in is b (an iteration), 0 (the entry beam: the news are the
//     entry rows), or the slots that the entry rows' earlier pieces
//     filled.
//   * Scores are compared as keys that keep the float order (-0 as +0),
//     the news' ending in ~position, so that every key is distinct and a
//     descending order of keys is the stable order. The beam arrives
//     sorted, so only the news are ordered, and only those that can enter:
//     with a full beam, a news scoring at or below its last slot never
//     does (the beam's slots win ties), and after a few iterations most
//     news are such. The rest go to shared memory, and are ordered by
//     counting, for each, the keys above it where they are few (at most
//     RANK_BY_COUNT: ~n^2 / MERGE_THREADS compares, a block barrier or
//     two), else by a bitonic sort of their keys (~log^2 n barriers).
//     Then every beam slot and every one of the ordered news' best
//     min(n, b) finds its place in the merged order by one binary search
//     in the other list (the merge path): beam slot i goes to i + the news
//     above it, news j to j + the beam slots at or above it.
//   * The new beam is sorted, so its unexpanded live slots, in position
//     order, are the picks' first part, and the rest follow in position
//     order: a block count and a block scan of the live flags place every
//     pick.
//   * It allocates nothing and rewrites the beam in place: a block reads
//     its own row of the beam (into the merge path's shared memory) before
//     the barrier that ends the merge path, and writes the row after it.
//   * Any number of news: the entry point merges them in pieces of at most
//     MAX_CANDIDATES (fewer beside a beam too wide for that piece's keys to
//     fit in shared memory), one launch a piece, the last one making the
//     picks. Every slot a piece's launch leaves in the beam comes from a
//     lower position than the next piece's news, so ties still go to the
//     lower position and the pieces give the one-launch answer. A beam of
//     at most MERGE_MAX_BEAM slots (13 bytes a slot in shared memory).
// On an H100 (700 W) at 100 queries, a beam of 128 and 1,024 news: 3.0 us
// with no news to order, 4.7 us with 64, 10.9 us with 512 (counted), 14.6
// us with 700 or more (sorted); 6.0 us a launch over the CAGRA cell's
// searches, where the PyTorch ops took ~16 launches and ~68 us an
// iteration.

constexpr int MERGE_THREADS = 256;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
// news that can enter, ordered by counting up to this many (two a thread)
constexpr int RANK_BY_COUNT = 2 * MERGE_THREADS;
constexpr unsigned ORD_NEG_INF = 0x007fffffu;  // ord_of(-inf)
constexpr int MERGE_MAX_BEAM = 16384;  // the beam's slots in shared memory
// a block's dynamic shared memory: an H100's 227 KB less the kernel's static
constexpr size_t MERGE_SMEM = 227 * 1024 - 1024;

// a float's place in the order of floats, as an unsigned: -0 as +0, and a
// NaN above +inf, as torch.sort places it
__device__ __forceinline__ unsigned ord_of(float f) {
  if (f != f) return 0xffffffffu;
  if (f == 0.f) return 0x80000000u;
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Shared memory (dynamic): keys[p2] (the sort keys of the news that can
// enter, p2 = m rounded up to a power of two), ord[b] (the beam's score
// keys), then the new beam: scores[b], ids[b], flags[b] (bytes).
// s, id, x: the beam, rows of b slots, the first b_in of each read (the
// rest are not yet filled) and the whole row rewritten. e = 0: no picks
// (a piece before the last), the flags kept.
__global__ void __launch_bounds__(MERGE_THREADS)
cagra_merge_kernel(float* s, int* id, unsigned char* x, int b_in,
                   const float* __restrict__ n_s, long long ns_stride,
                   const int* __restrict__ n_id, long long ni_stride, int m,
                   int p2, int b, int e, float* __restrict__ pick_s,
                   int* __restrict__ pick_id) {
  extern __shared__ unsigned long long keys[];
  unsigned* ord = reinterpret_cast<unsigned*>(keys + p2);
  float* o_s = reinterpret_cast<float*>(ord + b);
  int* o_id = reinterpret_cast<int*>(o_s + b);
  unsigned char* o_x = reinterpret_cast<unsigned char*>(o_id + b);
  __shared__ int warp_live[MERGE_WARPS];
  __shared__ int n_in;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q = blockIdx.x, row = q * b;
  const float* my_ns = n_s + q * ns_stride;
  const int* my_nid = n_id + q * ni_stride;
  const float* my_s = s + row;

  // news at or below a full beam's last slot never enter (0: every news
  // key is above it)
  const unsigned least = b_in == b ? ord_of(my_s[b - 1]) : 0u;
  for (int i = tid; i < b_in; i += MERGE_THREADS) ord[i] = ord_of(my_s[i]);
  if (tid == 0) n_in = 0;
  __syncthreads();
  for (int j = tid; j < m; j += MERGE_THREADS) {
    const unsigned o = ord_of(my_ns[j]);
    if (o > least)
      keys[atomicAdd(&n_in, 1)] = (unsigned long long)o << 32 | (unsigned)~j;
  }
  __syncthreads();

  // the keys of the news that can enter, descending
  const int n = n_in;
  if (n <= RANK_BY_COUNT) {
    unsigned long long mine[2];
    int above[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 2; ++u)
      mine[u] = tid + u * MERGE_THREADS < n ? keys[tid + u * MERGE_THREADS]
                                            : ~0ull;
    for (int c = 0; c < n; ++c) {
      const unsigned long long key = keys[c];
      above[0] += key > mine[0];
      above[1] += key > mine[1];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (tid + u * MERGE_THREADS < n) keys[above[u]] = mine[u];
    __syncthreads();
  } else {
    int p = 1;
    while (p < n) p <<= 1;
    for (int j = n + tid; j < p; j += MERGE_THREADS)
      keys[j] = 0ull;  // below every key of the news
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < p / 2; t += MERGE_THREADS) {
          const int i = 2 * t - (t & (j - 1)), l = i + j;
          const unsigned long long a = keys[i], c = keys[l];
          if ((a < c) == ((i & k) == 0)) {
            keys[i] = c;
            keys[l] = a;
          }
        }
        __syncthreads();
      }
  }

  // the merge path: each element's place in the new beam
  const int n_best = min(n, b);  // news past these land at b or later
  for (int i = tid; i < b_in; i += MERGE_THREADS) {
    int lo = 0, hi = n_best;  // the news strictly above beam slot i
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((unsigned)(keys[mid] >> 32) > ord[i]) lo = mid + 1; else hi = mid;
    }
    const int r = i + lo;
    if (r < b) {
      o_s[r] = my_s[i];
      o_id[r] = id[row + i];
      o_x[r] = x[row + i];
    }
  }
  for (int j = tid; j < n_best; j += MERGE_THREADS) {
    const unsigned o = (unsigned)(keys[j] >> 32);
    int lo = 0, hi = b_in;  // the beam slots at or above news j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ord[mid] >= o) lo = mid + 1; else hi = mid;
    }
    const int r = j + lo;
    if (r < b) {
      const int src = (int)~(unsigned)keys[j];
      o_s[r] = my_ns[src];
      o_id[r] = my_nid[src];
      o_x[r] = 0;
    }
  }
  for (int r = b_in + m + tid; r < b; r += MERGE_THREADS) {
    o_s[r] = -CUDART_INF_F;
    o_id[r] = -1;
    o_x[r] = 0;
  }
  __syncthreads();  // the beam's row is read: from here on it is written

  // the live unexpanded slots of the new beam
  int n_live = 0;
  for (int base = 0; base < b; base += MERGE_THREADS) {
    const int r = base + tid;
    n_live += __syncthreads_count(r < b && !o_x[r] &&
                                  ord_of(o_s[r]) > ORD_NEG_INF);
  }
  // the picks: the live unexpanded slots in order, then the rest in order;
  // a block scan, a chunk of MERGE_THREADS slots at a time (every thread
  // keeps the running count)
  const long long picks = q * e;
  int seen = 0;
  for (int base = 0; base < b; base += MERGE_THREADS) {
    const int r = base + tid;
    const bool live = r < b && !o_x[r] && ord_of(o_s[r]) > ORD_NEG_INF;
    const unsigned votes = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(votes);
    __syncthreads();
    int before = seen;
#pragma unroll
    for (int w = 0; w < MERGE_WARPS; ++w) {
      if (w < warp) before += warp_live[w];
      seen += warp_live[w];
    }
    if (r < b) {
      const int pre = before + __popc(votes & ((1u << lane) - 1));
      const int rank = live ? pre : n_live + r - pre;
      unsigned char flag = o_x[r];
      if (rank < e) {
        pick_s[picks + rank] = live ? o_s[r] : -CUDART_INF_F;
        pick_id[picks + rank] = o_id[r];
        flag = 1;
      }
      s[row + r] = o_s[r];
      id[row + r] = o_id[r];
      x[row + r] = flag;
    }
    __syncthreads();  // warp_live is rewritten by the next chunk
  }
}

size_t merge_smem_bytes(int p2, int b) {
  return sizeof(unsigned long long) * (size_t)p2 +
         (2 * sizeof(int) + sizeof(float) + 1) * (size_t)b;
}

// the news a launch merges beside a beam of b slots: MAX_CANDIDATES, or
// the most (a power of two) whose keys fit in shared memory beside it
int merge_piece(int b) {
  int piece = MAX_CANDIDATES;
  while (piece > 1 && merge_smem_bytes(piece, b) > MERGE_SMEM) piece >>= 1;
  return piece;
}

}  // namespace

extern "C" {

// Blocks of the kernel for rows of `kind` and `width` that one SM holds at
// once with `smem` bytes of dynamic shared memory (the wrapper's grid is
// this times the SMs); a negative CUDA error where the query fails.
int cagra_candidates_blocks(int kind, int width, long long smem) {
  if (bad_rows(kind, width) || smem < 0) return -(int)cudaErrorInvalidValue;
  const Kernel kernel = instance(kind, width);
  // the most any call asks for: the same for every call, so that no query
  // lowers what an earlier one allowed
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_CANDIDATES, MAX_BEAM, MAX_TABLE_BITS,
                      MAX_CANDIDATES));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                        (size_t)smem);
  return err == cudaSuccess ? n : -(int)err;
}

// rows: (n, width) bf16 (kind 0) or fp32 (kind 2), contiguous, width a
// multiple of 8. aq: (n_q, width) fp32.
// degree > 0: src (n_q, m / degree) parent ids (row stride src_stride),
// graph (n, degree) int32, src_s the parents' scores (row stride
// s_stride) or null; a parent whose score is not above `s_floor` has its
// candidates masked. degree == 0: src (n_q, m) the candidate ids (row
// stride src_stride; 0 repeats one row), src_s null. beam: (n_q, b) int32
// (b may be 0). nbrs (n_q, m) int32, scores (n_q, m) fp32. bits: log2 of
// each table's slots.
// live_cap: positions a block's segment may hold, at least
// min(m, ceil(n_q m / blocks)). cagra_candidates_blocks must have been
// asked once for this kind and width: it allows the shared memory.
int cagra_candidates(const void* rows, int kind, int width, const int* graph,
                     int degree, const int* src, long long src_stride,
                     const float* src_s, long long s_stride, float s_floor,
                     const int* beam, int b, const float* aq, int n_q, int m,
                     int bits, int live_cap, int blocks, int* nbrs,
                     float* scores, cudaStream_t stream) {
  const long long need = ((long long)n_q * m + blocks - 1) / blocks;
  if (bad_rows(kind, width) || n_q < 1 || m < 1 || m > MAX_CANDIDATES ||
      b < 0 || b > MAX_BEAM || bits < 6 || bits > MAX_TABLE_BITS ||
      blocks < 1 || live_cap < 1 ||
      live_cap > m || live_cap < (need < m ? need : m) || degree < 0 ||
      (degree > 0 && (graph == nullptr || m % degree != 0)) ||
      (degree == 0 && (graph != nullptr || src_s != nullptr)) ||
      (b > 0 && beam == nullptr))
    return (int)cudaErrorInvalidValue;
  instance(kind, width)<<<blocks, THREADS, smem_bytes(m, b, bits, live_cap),
                         stream>>>(rows, width, graph, degree, src, src_stride,
                                   src_s, s_stride, s_floor, beam, b, aq, n_q,
                                   m, bits, live_cap, nbrs, scores);
  return (int)cudaGetLastError();
}

// The beam's merge and next picks, a block a query (see cagra_merge_kernel).
// s, id, x: the beam, (n_q, b) fp32 scores sorted descending (ties by
// position), int32 ids and bool flags, contiguous: read where `merge` is 1
// (0: the entry beam, made from the news alone), and rewritten in place
// with the new beam, its flags with the picks set. n_s, n_id: the news,
// (n_q, m) fp32 scores and int32 ids, unit column stride, row strides
// ns_stride and ni_stride (0 repeats one row); any m, merged in pieces of
// merge_piece(b), a launch each. pick_s, pick_id: the picks, (n_q, e)
// contiguous. The news and the picks lie apart from the beam.
int cagra_merge(float* s, int* id, unsigned char* x, int merge,
                const float* n_s, long long ns_stride, const int* n_id,
                long long ni_stride, int m, int n_q, int b, int e,
                float* pick_s, int* pick_id, cudaStream_t stream) {
  if (n_q < 1 || b < 1 || b > MERGE_MAX_BEAM || e < 1 || e > b || m < 0 ||
      (merge != 0 && merge != 1) || s == nullptr || id == nullptr ||
      x == nullptr || pick_s == nullptr || pick_id == nullptr ||
      (m > 0 && (n_s == nullptr || n_id == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int piece = merge_piece(b);
  static int allowed[MAX_DEVICES] = {};
  int b_in = merge ? b : 0, at = 0;
  do {
    const int n = min(m - at, piece);
    int p2 = n > 0 ? 1 : 0;
    while (p2 < n) p2 <<= 1;
    const size_t smem = merge_smem_bytes(p2, b);
    cudaError_t err = allow_smem(allowed, cagra_merge_kernel, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cagra_merge_kernel<<<n_q, MERGE_THREADS, smem, stream>>>(
        s, id, x, b_in, n_s + at, ns_stride, n_id + at, ni_stride, n, p2, b,
        at + n == m ? e : 0, pick_s, pick_id);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    b_in = min(b, b_in + n);
    at += n;
  } while (at < m);
  return (int)cudaSuccess;
}

}  // extern "C"
