// hostops — native host-side runtime for cuvs_rag_tpu.
//
// TPU-native framework boundary: device compute is JAX/XLA/Pallas; this
// library covers the *host* runtime roles the reference delegated to native
// code (SURVEY.md §2):
//   * k-way merge of per-shard top-k results (SearchResultAggregator's
//     merge, test_search_result_aggregator.py:330-358 — the reference did
//     this with numpy argsort on the host; here a heap merge, O(Q·S·k·log S))
//     for API-edge merging across processes/hosts where ICI collectives
//     don't reach.
//   * multithreaded exact CPU brute-force top-k (the CPU baseline,
//     VectorSearch_QuestionRetrieval.ipynb#cell26-27 sklearn brute) — the
//     recall oracle when no accelerator is attached.
//   * int8 row-wise quantization for compact host-side embedding storage.
//
// Build: make -C cuvs_rag_tpu/native   (produces libhostops.so)
// ABI: plain C, loaded via ctypes (cuvs_rag_tpu/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// Merge S per-shard candidate lists (each Q x k_in, already sorted
// best-first) into a global top-k_out per query. `descending` = 1 when
// larger scores are better (internal score convention), 0 for ascending
// distances. Invalid slots are marked id = -1 and skipped.
void topk_merge(const float* scores, const int32_t* ids, int64_t S,
                int64_t Q, int64_t k_in, float* out_scores,
                int32_t* out_ids, int64_t k_out, int descending) {
  struct Head {
    float s;
    int32_t id;
    int32_t shard;
    int32_t pos;
  };
  for (int64_t q = 0; q < Q; ++q) {
    auto better = [descending](const Head& a, const Head& b) {
      // priority_queue keeps the *worst* on top given this comparator,
      // so invert: return true when a is worse than b.
      return descending ? (a.s < b.s) : (a.s > b.s);
    };
    std::priority_queue<Head, std::vector<Head>, decltype(better)> heap(better);
    if (k_in > 0) {  // k_in == 0: zero-length candidate rows, pad-only
      for (int64_t s = 0; s < S; ++s) {
        const int64_t base = (s * Q + q) * k_in;
        if (ids[base] >= 0)
          heap.push({scores[base], ids[base], (int32_t)s, 0});
      }
    }
    int64_t filled = 0;
    while (filled < k_out && !heap.empty()) {
      Head h = heap.top();
      heap.pop();
      out_scores[q * k_out + filled] = h.s;
      out_ids[q * k_out + filled] = h.id;
      ++filled;
      if (h.pos + 1 < k_in) {
        const int64_t base = ((int64_t)h.shard * Q + q) * k_in + h.pos + 1;
        if (ids[base] >= 0)
          heap.push({scores[base], ids[base], h.shard, h.pos + 1});
      }
    }
    for (; filled < k_out; ++filled) {
      out_scores[q * k_out + filled] =
          descending ? -INFINITY : INFINITY;
      out_ids[q * k_out + filled] = -1;
    }
  }
}

// Exact multithreaded brute-force squared-L2 top-k on the host CPU.
// corpus: N x D fp32, queries: Q x D fp32. Results ascending by distance.
void brute_topk_l2(const float* corpus, int64_t N, int64_t D,
                   const float* queries, int64_t Q, int64_t k,
                   float* out_d, int32_t* out_i, int nthreads) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;  // hardware_concurrency() may return 0
  const int64_t kk = std::min(k, N);

  std::vector<float> corpus_sq(N);
  {
    std::vector<std::thread> ts;
    std::atomic<int64_t> next(0);
    for (int t = 0; t < nthreads; ++t)
      ts.emplace_back([&]() {
        int64_t i;
        while ((i = next.fetch_add(4096)) < N) {
          int64_t end = std::min(i + 4096, N);
          for (int64_t r = i; r < end; ++r) {
            float acc = 0.f;
            const float* row = corpus + r * D;
            for (int64_t d = 0; d < D; ++d) acc += row[d] * row[d];
            corpus_sq[r] = acc;
          }
        }
      });
    for (auto& t : ts) t.join();
  }

  std::atomic<int64_t> next_q(0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t)
    ts.emplace_back([&]() {
      using Pair = std::pair<float, int32_t>;  // (dist, id), max-heap
      int64_t q;
      while ((q = next_q.fetch_add(1)) < Q) {
        const float* qv = queries + q * D;
        float q_sq = 0.f;
        for (int64_t d = 0; d < D; ++d) q_sq += qv[d] * qv[d];
        std::priority_queue<Pair> heap;
        for (int64_t r = 0; r < N; ++r) {
          const float* row = corpus + r * D;
          float ip = 0.f;
          for (int64_t d = 0; d < D; ++d) ip += row[d] * qv[d];
          float dist = q_sq - 2.f * ip + corpus_sq[r];
          if (dist < 0.f) dist = 0.f;
          if ((int64_t)heap.size() < kk) {
            heap.push({dist, (int32_t)r});
          } else if (dist < heap.top().first) {
            heap.pop();
            heap.push({dist, (int32_t)r});
          }
        }
        for (int64_t j = (int64_t)heap.size() - 1; j >= 0; --j) {
          out_d[q * k + j] = heap.top().first;
          out_i[q * k + j] = heap.top().second;
          heap.pop();
        }
        for (int64_t j = kk; j < k; ++j) {
          out_d[q * k + j] = INFINITY;
          out_i[q * k + j] = -1;
        }
      }
    });
  for (auto& t : ts) t.join();
}

// Row-wise symmetric int8 quantization: values[i] = round(x / scale[row]),
// scale[row] = max|x_row| / 127.
void quantize_int8(const float* x, int64_t N, int64_t D, int8_t* values,
                   float* scales) {
  for (int64_t r = 0; r < N; ++r) {
    const float* row = x + r * D;
    float amax = 0.f;
    for (int64_t d = 0; d < D; ++d) amax = std::max(amax, std::fabs(row[d]));
    float scale = amax > 0.f ? amax / 127.f : 1.f;
    scales[r] = scale;
    const float inv = 1.f / scale;
    for (int64_t d = 0; d < D; ++d)
      values[r * D + d] = (int8_t)std::lround(row[d] * inv);
  }
}

void dequantize_int8(const int8_t* values, const float* scales, int64_t N,
                     int64_t D, float* out) {
  for (int64_t r = 0; r < N; ++r)
    for (int64_t d = 0; d < D; ++d)
      out[r * D + d] = (float)values[r * D + d] * scales[r];
}

// BM25 batch scoring over CSR postings (rag/lexical.py's hot loop).
// Per query: walk the query terms' postings slices, accumulate
//   idf * tf * (k1+1) / (tf + k1 * norm_cache[doc])
// into a dense per-thread score buffer, then partial-select top-k of the
// strictly-positive, unmasked scores. Queries parallelize across
// `nthreads` workers (0 = hardware_concurrency), each reusing one
// (n_docs) float buffer — postings access is integer-sparse gather, the
// access pattern host DRAM handles and TPUs don't (module rationale in
// rag/lexical.py).
//
// Inputs: CSR (indptr over terms, post_docs/post_tfs), norm_cache[d] =
// 1-b+b*dl/avgdl, concatenated per-query term ids `q_tids` + aligned
// `q_idf` with (Q+1) offsets, optional mask (NULL = all alive).
// Outputs: (Q, k) scores (0-padded) and ids (-1-padded), best-first,
// ties broken by ascending doc id.
void bm25_score_topk(const int64_t* indptr, const int64_t* post_docs,
                     const float* post_tfs, const float* norm_cache,
                     int64_t n_terms, int64_t n_docs, float k1,
                     const int64_t* q_tids, const float* q_idf,
                     const int64_t* q_offsets, int64_t Q,
                     const uint8_t* mask, int64_t k, float* out_scores,
                     int64_t* out_ids, int nthreads) {
  int nt = nthreads > 0 ? nthreads
                        : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > Q) nt = (int)(Q > 0 ? Q : 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<float> scores((size_t)n_docs);
    std::vector<int64_t> touched;
    std::vector<std::pair<float, int64_t>> cand;
    for (;;) {
      int64_t q = next.fetch_add(1);
      if (q >= Q) return;
      touched.clear();
      for (int64_t t = q_offsets[q]; t < q_offsets[q + 1]; ++t) {
        int64_t tid = q_tids[t];
        if (tid < 0 || tid >= n_terms) continue;
        float idf = q_idf[t];
        for (int64_t p = indptr[tid]; p < indptr[tid + 1]; ++p) {
          int64_t d = post_docs[p];
          float tf = post_tfs[p];
          if (scores[d] == 0.0f) touched.push_back(d);
          scores[d] += idf * tf * (k1 + 1.0f) / (tf + k1 * norm_cache[d]);
        }
      }
      cand.clear();
      for (int64_t d : touched) {
        if (scores[d] > 0.0f && (!mask || mask[d])) {
          cand.emplace_back(scores[d], d);
        }
        scores[d] = 0.0f;  // reset for the next query
      }
      auto better = [](const std::pair<float, int64_t>& a,
                       const std::pair<float, int64_t>& b) {
        if (a.first != b.first) return a.first > b.first;
        return a.second < b.second;  // tie: ascending doc id
      };
      size_t kk = (size_t)k < cand.size() ? (size_t)k : cand.size();
      std::partial_sort(cand.begin(), cand.begin() + kk, cand.end(), better);
      for (size_t j = 0; j < (size_t)k; ++j) {
        if (j < kk) {
          out_scores[q * k + j] = cand[j].first;
          out_ids[q * k + j] = cand[j].second;
        } else {
          out_scores[q * k + j] = 0.0f;
          out_ids[q * k + j] = -1;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Exact DAAT MaxScore BM25 (Turtle & Flood 1995): terms sorted by score
// upper bound; the low-bound suffix whose cumulative bound can no longer
// lift a doc past the current top-k threshold becomes "non-essential" —
// its postings are only probed (binary search) for docs surfaced by the
// essential terms, never walked. Exact top-k (no stopword heuristics):
// a doc seen ONLY by non-essential terms scores < theta by the partition
// invariant, so skipping it cannot change the result set. Wins over the
// dense-accumulate scorer when head (high-df) terms dominate the walk.
//
// q_bounds[t] = per-query-term upper bound on a single doc's
// contribution (computed host-side: idf*(k1+1)*tfmax/(tfmax+k1*min_norm)).
// Other conventions (CSR, mask, outputs, ties by ascending doc id) match
// bm25_score_topk.
void bm25_maxscore_topk(const int64_t* indptr, const int64_t* post_docs,
                        const float* post_tfs, const float* norm_cache,
                        int64_t n_terms, int64_t n_docs, float k1,
                        const int64_t* q_tids, const float* q_idf,
                        const float* q_bounds, const int64_t* q_offsets,
                        int64_t Q, const uint8_t* mask, int64_t k,
                        float* out_scores, int64_t* out_ids,
                        int nthreads) {
  (void)n_docs;
  int nt = nthreads > 0 ? nthreads
                        : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > Q) nt = (int)(Q > 0 ? Q : 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    struct Term {
      float idf, bound;
      int64_t cur, end;  // cursor into post_docs/post_tfs
    };
    std::vector<Term> terms;
    std::vector<double> prefix;  // prefix[i] = sum of bounds[0..i-1]
    // top-k accumulator: worst entry on top. "Worse" = lower score, or
    // equal score with HIGHER doc id (so ties keep ascending doc ids).
    auto worse = [](const std::pair<float, int64_t>& a,
                    const std::pair<float, int64_t>& b) {
      if (a.first != b.first) return a.first > b.first;
      return a.second < b.second;
    };
    std::vector<std::pair<float, int64_t>> heap;
    for (;;) {
      int64_t q = next.fetch_add(1);
      if (q >= Q) return;
      terms.clear();
      for (int64_t t = q_offsets[q]; t < q_offsets[q + 1]; ++t) {
        int64_t tid = q_tids[t];
        if (tid < 0 || tid >= n_terms) continue;
        if (indptr[tid] == indptr[tid + 1]) continue;
        terms.push_back(
            {q_idf[t], q_bounds[t], indptr[tid], indptr[tid + 1]});
      }
      // ascending bound: terms[0..ess) are non-essential
      std::sort(terms.begin(), terms.end(),
                [](const Term& a, const Term& b) {
                  return a.bound < b.bound;
                });
      size_t m = terms.size();
      prefix.assign(m + 1, 0.0);
      for (size_t i = 0; i < m; ++i) prefix[i + 1] = prefix[i] + terms[i].bound;
      heap.clear();
      float theta = -1.0f;  // threshold; -1 until the heap holds k docs
      size_t ess = 0;       // first essential term index
      while (ess < m) {
        // pivot: smallest current doc among essential terms
        int64_t d = INT64_MAX;
        for (size_t i = ess; i < m; ++i) {
          if (terms[i].cur < terms[i].end) {
            int64_t c = post_docs[terms[i].cur];
            if (c < d) d = c;
          }
        }
        if (d == INT64_MAX) break;  // essential cursors exhausted
        float score = 0.0f;
        for (size_t i = ess; i < m; ++i) {
          Term& t = terms[i];
          if (t.cur < t.end && post_docs[t.cur] == d) {
            float tf = post_tfs[t.cur];
            score += t.idf * tf * (k1 + 1.0f) / (tf + k1 * norm_cache[d]);
            ++t.cur;
          }
        }
        // probe non-essential terms, highest bound first, abandoning as
        // soon as the remaining bounds can't reach theta
        for (size_t i = ess; i-- > 0;) {
          if (theta >= 0.0f && score + prefix[i + 1] < theta) break;
          Term& t = terms[i];
          const int64_t* lo = post_docs + t.cur;
          const int64_t* hi = post_docs + t.end;
          const int64_t* it = std::lower_bound(lo, hi, d);
          t.cur = it - post_docs;  // future pivots are >= d
          if (it != hi && *it == d) {
            float tf = post_tfs[t.cur];
            score += t.idf * tf * (k1 + 1.0f) / (tf + k1 * norm_cache[d]);
            ++t.cur;
          }
        }
        if (score > 0.0f && (!mask || mask[d])) {
          bool take = (int64_t)heap.size() < k;
          if (!take && k > 0) {
            const auto& w = heap.front();
            take = score > w.first || (score == w.first && d < w.second);
          }
          if (take) {
            if ((int64_t)heap.size() == k) {
              std::pop_heap(heap.begin(), heap.end(), worse);
              heap.pop_back();
            }
            heap.emplace_back(score, d);
            std::push_heap(heap.begin(), heap.end(), worse);
            if ((int64_t)heap.size() == k) {
              theta = heap.front().first;
              // grow the non-essential prefix while it provably cannot
              // put a new doc into the top-k on its own
              while (ess < m && prefix[ess + 1] < theta) ++ess;
            }
          }
        }
      }
      std::sort(heap.begin(), heap.end(),
                [](const std::pair<float, int64_t>& a,
                   const std::pair<float, int64_t>& b) {
                  if (a.first != b.first) return a.first > b.first;
                  return a.second < b.second;
                });
      for (size_t j = 0; j < (size_t)k; ++j) {
        if (j < heap.size()) {
          out_scores[q * k + j] = heap[j].first;
          out_ids[q * k + j] = heap[j].second;
        } else {
          out_scores[q * k + j] = 0.0f;
          out_ids[q * k + j] = -1;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
