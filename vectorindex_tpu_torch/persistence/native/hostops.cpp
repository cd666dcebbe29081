// Native host-side ops for the host-memory rerank tier.
//
// Parity target (reference kernel #40): ExactRerank.swift:655
// rerank_exact_topk — gather the top-C candidate rows, score them with the
// exact metric, and keep the strict (score, id) top-k. The reference runs
// this on CPU cores beside the gather (gatherTile/reorderBySegment,
// ExactRerank.swift:21-64); this is the same stage for the TPU build's
// host-memory capacity tier, where the f32 corpus lives in host RAM
// (CSRReader / np.memmap) and only candidate ids cross the PCIe link.
//
// Why native: the serving host may have very few cores (the round-4 bench
// host has ONE), and the numpy pipeline pays three full passes over the
// gathered block (gather copy, GEMV, sqnorm) plus a full lexsort —
// measured 69 ms per (B=64, C=1024, d=96) batch. This kernel fuses
// gather+score+topk into one streaming pass over the candidate rows: each
// row is read once from the corpus, its score folds straight into a
// k-bounded insertion buffer, and no [B,C,d] intermediate ever
// materializes. Single-core cost is the 25 MB of corpus reads, ~5 ms.
//
// Contracts matched to ops/rerank.rerank_gathered_host:
//   - metric 0 = L2 squared: max(|q|^2 + |x|^2 - 2<q,x>, 0)
//     metric 1 = inner product: -<q,x>   metric 2 = cosine: 1 - cos(q,x)
//   - ids out of [0, n) are missing: they never enter the top-k and
//     unfilled output slots hold (+inf, INVALID_ID) — the reference's
//     +/-inf sentinel convention (ExactRerank.swift:76-78).
//   - ties break strictly by (score, id) ascending — TopK.swift:8-30.
//
// The PyTorch port's own copy of vectorindex_tpu/persistence/native/
// hostops.cpp (same source). Build: g++ -O3 -march=native -std=c++20 -fPIC
// -shared, at first use, by vectorindex_tpu_torch/ops/rerank.py into
// build/hostops/<hash of source, flags and CPU>/. No deps.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr int32_t kInvalidId = std::numeric_limits<int32_t>::max();
constexpr float kInf = std::numeric_limits<float>::infinity();

// Candidate rows are processed in blocks: a prefetch sweep issues every
// cache line of the next block's rows before the compute sweep touches
// them, so the (random-row) corpus misses overlap instead of serializing
// behind each row's dot product — the fused-kernel form of the
// reference's gather tiles (ExactRerank.swift:21-64, gatherTile 128).
constexpr int64_t kBlock = 16;

// Strict (score, id) ascending comparison.
inline bool better(float s1, int32_t i1, float s2, int32_t i2) {
  return s1 < s2 || (s1 == s2 && i1 < i2);
}

// Dot product and squared norm of x over d lanes in one pass.
#if defined(__AVX512F__)
inline void dot_sq(const float* __restrict q, const float* __restrict x,
                   int64_t d, float* dot_out, float* sq_out) {
  __m512 acc_d = _mm512_setzero_ps();
  __m512 acc_s = _mm512_setzero_ps();
  int64_t i = 0;
  for (; i + 16 <= d; i += 16) {
    __m512 xv = _mm512_loadu_ps(x + i);
    __m512 qv = _mm512_loadu_ps(q + i);
    acc_d = _mm512_fmadd_ps(qv, xv, acc_d);
    acc_s = _mm512_fmadd_ps(xv, xv, acc_s);
  }
  if (i < d) {
    __mmask16 m = (__mmask16)((1u << (d - i)) - 1u);
    __m512 xv = _mm512_maskz_loadu_ps(m, x + i);
    __m512 qv = _mm512_maskz_loadu_ps(m, q + i);
    acc_d = _mm512_fmadd_ps(qv, xv, acc_d);
    acc_s = _mm512_fmadd_ps(xv, xv, acc_s);
  }
  *dot_out = _mm512_reduce_add_ps(acc_d);
  *sq_out = _mm512_reduce_add_ps(acc_s);
}
#else
inline void dot_sq(const float* __restrict q, const float* __restrict x,
                   int64_t d, float* dot_out, float* sq_out) {
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t i = 0;
  for (; i + 4 <= d; i += 4) {
    d0 += q[i] * x[i];
    d1 += q[i + 1] * x[i + 1];
    d2 += q[i + 2] * x[i + 2];
    d3 += q[i + 3] * x[i + 3];
    s0 += x[i] * x[i];
    s1 += x[i + 1] * x[i + 1];
    s2 += x[i + 2] * x[i + 2];
    s3 += x[i + 3] * x[i + 3];
  }
  for (; i < d; ++i) {
    d0 += q[i] * x[i];
    s0 += x[i] * x[i];
  }
  *dot_out = (d0 + d1) + (d2 + d3);
  *sq_out = (s0 + s1) + (s2 + s3);
}
#endif

inline void prefetch_row(const float* row, int64_t d) {
  for (int64_t o = 0; o < d; o += 16) __builtin_prefetch(row + o);
}

// Sorted top-k insertion buffer (ascending by strict (score, id)). k is
// small (10..100) next to C (1024+), so insertion beats a heap: the common
// case is one compare against the current worst.
struct TopK {
  float* s;
  int32_t* ids;
  int64_t k;
  int64_t len = 0;

  inline void push(float sc, int32_t id) {
    if (len == k && !better(sc, id, s[len - 1], ids[len - 1])) return;
    int64_t lo = 0, hi = len;
    while (lo < hi) {  // first slot where (sc,id) is better
      int64_t mid = (lo + hi) >> 1;
      if (better(sc, id, s[mid], ids[mid])) hi = mid;
      else lo = mid + 1;
    }
    int64_t end = len < k ? len : k - 1;
    for (int64_t j = end; j > lo; --j) {
      s[j] = s[j - 1];
      ids[j] = ids[j - 1];
    }
    s[lo] = sc;
    ids[lo] = id;
    if (len < k) ++len;
  }
};

void rerank_query(const float* x, int64_t n, int64_t d, int64_t stride,
                  const int32_t* ids, const float* q, int64_t c, int64_t k,
                  int metric, float* out_d, int32_t* out_i) {
  for (int64_t j = 0; j < k; ++j) {
    out_d[j] = kInf;
    out_i[j] = kInvalidId;
  }
  float qn = 0.f;
  if (metric != 1) {
    float dummy;
    dot_sq(q, q, d, &qn, &dummy);
  }
  const float q_inv = metric == 2 ? 1.0f / std::sqrt(qn > 1e-30f ? qn : 1e-30f) : 0.f;
  TopK top{out_d, out_i, k};
  // prime the first block's rows, then per block: prefetch block j+1,
  // compute block j (misses of the next 16 rows fly while this block's
  // dots run)
  for (int64_t j = 0; j < c && j < kBlock; ++j) {
    const int32_t id = ids[j];
    if (id >= 0 && static_cast<int64_t>(id) < n)
      prefetch_row(x + static_cast<int64_t>(id) * stride, d);
  }
  for (int64_t j0 = 0; j0 < c; j0 += kBlock) {
    const int64_t j1 = j0 + kBlock < c ? j0 + kBlock : c;
    for (int64_t j = j0 + kBlock; j < j1 + kBlock && j < c; ++j) {
      const int32_t id = ids[j];
      if (id >= 0 && static_cast<int64_t>(id) < n)
        prefetch_row(x + static_cast<int64_t>(id) * stride, d);
    }
    for (int64_t j = j0; j < j1; ++j) {
      const int32_t id = ids[j];
      if (id < 0 || static_cast<int64_t>(id) >= n) continue;  // missing
      const float* row = x + static_cast<int64_t>(id) * stride;
      float dot, sq;
      dot_sq(q, row, d, &dot, &sq);
      float sc;
      if (metric == 0) {
        sc = qn + sq - 2.0f * dot;
        if (sc < 0.f) sc = 0.f;
      } else if (metric == 1) {
        sc = -dot;
      } else {
        float xn = std::sqrt(sq > 1e-30f ? sq : 1e-30f);
        sc = 1.0f - dot * q_inv / xn;
      }
      top.push(sc, id);
    }
  }
}

}  // namespace

extern "C" {

// Fused gather+score+topk over a host-resident f32 corpus in ORIGINAL row
// order (CSRReader.vecs): for each of b queries, rerank its c candidate
// ids exactly and write the strict (score, id) top-k.
//   x        [n, stride] f32 corpus base; logical dim d <= stride
//   ids      [b, c] i32 original corpus ids (out-of-range = missing)
//   q        [b, d] f32 queries
//   metric   0 = L2^2, 1 = IP (-dot), 2 = cosine distance
//   out_d    [b, k] f32   out_i [b, k] i32
//   n_threads > 1 partitions queries across std::thread workers (the
//   gather is the cost; independent queries stream independent rows).
void vi_rerank_ids_f32(const float* x, int64_t n, int64_t d, int64_t stride,
                       const int32_t* ids, const float* q, int64_t b,
                       int64_t c, int64_t k, int metric, int n_threads,
                       float* out_d, int32_t* out_i) {
  if (n_threads <= 1 || b == 1) {
    for (int64_t i = 0; i < b; ++i)
      rerank_query(x, n, d, stride, ids + i * c, q + i * d, c, k, metric,
                   out_d + i * k, out_i + i * k);
    return;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= b) return;
      rerank_query(x, n, d, stride, ids + i * c, q + i * d, c, k, metric,
                   out_d + i * k, out_i + i * k);
    }
  };
  int nt = static_cast<int>(n_threads < b ? n_threads : b);
  std::vector<std::thread> ts;
  ts.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
}

}  // extern "C"
