// The CAGRA beam's candidate step on Hopper (sm_90a): one launch an
// iteration of ops/graph.beam_search, and one for its entry rows.
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
// Plain C ABI (built with nvcc, loaded with ctypes): the entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

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

}  // extern "C"
