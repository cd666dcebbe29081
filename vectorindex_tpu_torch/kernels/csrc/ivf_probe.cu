// IVF-Flat probe kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/ivf_probe.py:
//
//   K4 ivf_probe_scores            replaces ivf_probe.py:ivf_probe_scores
//                                  (body _probe_kernel)
//   K5 ivf_probe_scores_rankmajor  replaces ivf_probe.py:ivf_probe_scores_rankmajor
//                                  (body _probe_rankseg_kernel)
//   K3 ivf_probe_topc              replaces ivf_probe.py:ivf_probe_topc_rankmajor
//                                  (body _probe_rankseg_binned_kernel)
//
// All three score, for each (query, probe) pair, the live rows start + o
// (o < live) of the probed list of a CSR store x [N, d] (f32 or bf16) and
// never read a dead row. Every distance is one chain and one epilogue
// (probe_epilogue): q is rounded to the storage dtype by the caller,
// g = sum_k q[k] x[k] is one chain in k order with each product and each
// sum rounded separately (__fmul_rn, __fadd_rn: no FMA contraction), and
// the epilogue uses explicitly rounded operations (a correctly rounded
// square root and division for cosine). The designs differ only in which
// thread runs which chain and how the rows reach it. The plain PyTorch versions in
// kernels/ivf_probe.py perform the same operations in the same order, so
// kernel and plain version agree bit for bit.
//
// K4/K5 (`probe_scores_grouped_kernel`): list-major. At B=256, nprobe=32
// over nlist=1024 a list is probed by ~8 queries, so a schedule of one CTA
// per (query, probe) pair reads every list ~8 times. The wrapper sorts the
// B * nprobe pairs stably by start row (kernels/ivf_probe.probe_groups, no
// host sync) and marks a leader at the start of each run of one start and
// every kGroup pairs within a long run; serving batches skip the sort and
// give each pair its own group. Grid (sorted position, row chunk): a
// non-leader CTA exits at once; a leader CTA reads its chunk of the list
// once for its g <= kGroup pairs. Rows and query slices are staged with
// cp.async (16-byte copies where row bytes are 16-byte aligned, else plain
// loads) into a ring of kScoreStages buffers; a row's slice sits at a
// stride of (slice bytes rounded up to 32) + 16, so the 16-byte reads of 8
// lanes (one wavefront) fall on distinct banks. Thread (h, t) owns row t of
// a kScoreRows-row tile and the chains of pairs h, h + kScoreSplit, ... of
// the group, with q read as a shared-memory broadcast; the chains carry on
// across k-slices of kScoreSlice bytes (any d: shared memory does not grow
// with d). Each pair keeps its own live length (a disabled list has live 0
// beside a live pair of the same start). Writes are coalesced over slots;
// slots past a pair's live length get +inf. With the list read once a
// group, the chains' issue (one rounded multiply and one rounded add per
// element and pair) is what bounds the kernel, hence the kScoreSplit lanes:
// 32 warps an SM instead of 8.
//
// K3 (`topc_kernel`): the TPU kernel folds list segments in grid order into
// one resident binned accumulator. Here the output is defined as a function
// of the set of live probed rows: per query and per class (CSR row mod 256)
// the 3 smallest finite (dist, row) pairs in lexicographic order, plus the
// class's 4th-smallest distance (drop_min). That is decomposable. One
// launch, grid (pair, row chunk), 256 threads: thread t owns class t of
// every 256-row block and keeps its sorted top-4 in registers; rows reach
// it through a kTopcStages-stage cp.async ring of kTopcSlice-byte k-slices
// (padded as in K4), ahead of the chain. Each CTA writes its top-4s as a
// partial; the last CTA of a query to arrive (a per-query counter in a
// workspace, __threadfence before the atomic) folds the query's live
// partials and resets the counter to 0. The insert is lexicographic, so
// the result does not depend on chunking or on the order of arrival.
//
// Bounds on the H100: each kernel reads every live row of the distinct
// probed lists once (d * itemsize + 4 bytes) and does 2 d operations per
// (query, row), so all three are bound by bytes (K4/K5 also write
// B * nprobe * probe_cap floats). The first designs (one CTA per pair,
// each thread loading its own row with 16-byte loads; K3 as a scan launch
// and a merge launch) stay as probe_scores_kernel, topc_scan_kernel and
// topc_merge_kernel behind the *_v1 entry points, for timing in turns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads per scan CTA = classes per query
constexpr int kTiers = 3;        // K3 candidates kept per class
constexpr int kKeep = kTiers + 1;  // + the 4th smallest, for drop_min
constexpr int kScoresChunk = 1024;  // rows per K4/K5 CTA (first design)
constexpr int kMergeGroups = 8;  // partial groups per class in the merge launch (first design)
constexpr int kGroup = 16;       // most (query, probe) pairs one K4/K5 CTA serves
constexpr int kScoreRows = 128;  // K4/K5: rows of a tile
constexpr int kScoreSplit = 4;   // K4/K5: pair lanes; a CTA is kScoreRows * kScoreSplit threads
constexpr int kScoreSlice = 256;  // K4/K5: bytes of a row's k-slice in one stage
constexpr int kScoreStages = 2;  // K4/K5: ring stages
constexpr int kTopcSlice = 128;  // K3: bytes of a row's k-slice in one stage
constexpr int kTopcStages = 3;   // K3: ring stages
constexpr int kMergeBatch = 4;   // K3: partials whose loads the fold keeps in flight
constexpr int kMergeWindow = 1024;  // K3: partial ids the fold lists at a time
constexpr int kInvalidRow = 0x7fffffff;
constexpr int kL2 = 0, kIP = 1, kCos = 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive row elements as f32; vec means 16-byte aligned.
__device__ __forceinline__ void load8(const float* __restrict__ p, bool vec, float (&v)[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(p + j);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, bool vec,
                                      float (&v)[8]) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = widen(p[j]);
  }
}

// g = q . x as one chain over k = 0..d-1, product and sum rounded apart.
template <typename T>
__device__ __forceinline__ float dot_seq(const float* __restrict__ qs, const T* __restrict__ xrow,
                                         int d, bool vec) {
  float acc = 0.0f;
  int k = 0;
  for (; k + 8 <= d; k += 8) {
    float xv[8];
    load8(xrow + k, vec, xv);
    const float4 qa = *reinterpret_cast<const float4*>(qs + k);
    const float4 qb = *reinterpret_cast<const float4*>(qs + k + 4);
    acc = __fadd_rn(acc, __fmul_rn(qa.x, xv[0]));
    acc = __fadd_rn(acc, __fmul_rn(qa.y, xv[1]));
    acc = __fadd_rn(acc, __fmul_rn(qa.z, xv[2]));
    acc = __fadd_rn(acc, __fmul_rn(qa.w, xv[3]));
    acc = __fadd_rn(acc, __fmul_rn(qb.x, xv[4]));
    acc = __fadd_rn(acc, __fmul_rn(qb.y, xv[5]));
    acc = __fadd_rn(acc, __fmul_rn(qb.z, xv[6]));
    acc = __fadd_rn(acc, __fmul_rn(qb.w, xv[7]));
  }
  for (; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(qs[k], widen(xrow[k])));
  return acc;
}

// The one epilogue of K3, K4 and K5 on the chain's g. qterm: ||q||^2 (L2),
// 1/||q|| (cosine), unused (IP); sq = ||x||^2 of the row.
template <int METRIC, bool SENTINEL>
__device__ __forceinline__ float probe_epilogue(float g, float qterm, float sq) {
  if (METRIC == kL2) return __fsub_rn(__fadd_rn(qterm, sq), __fmul_rn(2.0f, g));
  if (SENTINEL && !(sq < INFINITY)) return INFINITY;
  if (METRIC == kIP) return -g;
  const float xinv = sq > 0.0f ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(sq, 1e-30f))) : 0.0f;
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(g, qterm), xinv));
}

// The first designs' distance: the chain over the row in global memory.
template <typename T, int METRIC, bool SENTINEL>
__device__ __forceinline__ float probe_distance(const float* __restrict__ qs,
                                               const T* __restrict__ xrow, int d, bool vec,
                                               float qterm, float sq) {
  return probe_epilogue<METRIC, SENTINEL>(dot_seq(qs, xrow, d, vec), qterm, sq);
}

// The CTA's query row into shared memory.
__device__ __forceinline__ void stage_query(float* __restrict__ qs, const float* __restrict__ qr,
                                            int b, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qr[static_cast<size_t>(b) * d + i];
  __syncthreads();
}

__device__ __forceinline__ bool lex_less(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// Keep the kKeep smallest finite (dist, row) pairs sorted in (dist, row)
// order: the new pair sinks to its place and the largest falls off.
__device__ __forceinline__ void insert_keep(float (&td)[kKeep], int (&ti)[kKeep], float v,
                                            int row) {
  if (!(v < INFINITY) || !lex_less(v, row, td[kKeep - 1], ti[kKeep - 1])) return;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (lex_less(v, row, td[j], ti[j])) {
      const float sd = td[j];
      const int sr = ti[j];
      td[j] = v;
      ti[j] = row;
      v = sd;
      row = sr;
    }
  }
}

// K4/K5: grid (pair = query * nprobe + probe, row chunk), kThreads threads.
template <typename T, int METRIC, bool SENTINEL>
__global__ void __launch_bounds__(kThreads)
    probe_scores_kernel(const float* __restrict__ qr, const float* __restrict__ qterm,
                        const int* __restrict__ starts, const int* __restrict__ lives,
                        const T* __restrict__ x, const float* __restrict__ sqn, int nprobe,
                        int d, int probe_cap, bool vec, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int pair = blockIdx.x;
  const int b = pair / nprobe;
  stage_query(qs, qr, b, d);
  const int start = starts[pair];
  const int live = lives[pair];
  const float qt = qterm[b];
  float* o = out + static_cast<size_t>(pair) * probe_cap;
  const int o0 = blockIdx.y * kScoresChunk;
  const int o1 = min(o0 + kScoresChunk, probe_cap);
  for (int off = o0 + threadIdx.x; off < o1; off += kThreads) {
    float v = INFINITY;
    if (off < live) {
      const int row = start + off;
      v = probe_distance<T, METRIC, SENTINEL>(qs, x + static_cast<size_t>(row) * d, d, vec, qt,
                                              sqn[row]);
    }
    o[off] = v;
  }
}

// K3 scan: grid (pair, chunk), kThreads threads. A CTA whose chunk starts
// past the live length exits (the merge reads live chunks only); the others
// write their per-class top-4 to part_[dist|row] laid out
// [pair][chunk][kKeep][class].
template <typename T, int METRIC>
__global__ void __launch_bounds__(kThreads)
    topc_scan_kernel(const float* __restrict__ qr, const float* __restrict__ qterm,
                     const int* __restrict__ starts, const int* __restrict__ lives,
                     const T* __restrict__ x, const float* __restrict__ sqn, int nprobe, int d,
                     int chunk_rows, int nchunks, bool vec, float* __restrict__ part_dist,
                     int* __restrict__ part_row) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int pair = blockIdx.x;
  const int live = lives[pair];
  const int o0 = blockIdx.y * chunk_rows;
  if (o0 >= live) return;
  const int b = pair / nprobe;
  stage_query(qs, qr, b, d);
  const int start = starts[pair];
  const float qt = qterm[b];
  float td[kKeep];
  int ti[kKeep];
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    td[t] = INFINITY;
    ti[t] = kInvalidRow;
  }
  const int o1 = min(o0 + chunk_rows, live);
  for (int off = o0 + threadIdx.x; off < o1; off += kThreads) {
    const int row = start + off;
    insert_keep(td, ti,
                probe_distance<T, METRIC, true>(qs, x + static_cast<size_t>(row) * d, d, vec, qt,
                                                sqn[row]),
                row);
  }
  // every row this thread scanned is start + o0 + threadIdx.x + j * 256
  const int cls = (start + o0 + static_cast<int>(threadIdx.x)) & (kThreads - 1);
  const size_t base = (static_cast<size_t>(pair) * nchunks + blockIdx.y) * kKeep;
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    part_dist[(base + t) * kThreads + cls] = td[t];
    part_row[(base + t) * kThreads + cls] = ti[t];
  }
}

// K3 merge: grid (query, kThreads / 32), 32 x kMergeGroups threads. Thread
// (g, lane) folds every kMergeGroups-th live partial of class
// blockIdx.y * 32 + lane, then group 0 folds the groups' top-4s and writes
// cand [query][tier * 256 + class] (unfilled: +inf, row 0) and drop_min.
__global__ void __launch_bounds__(32 * kMergeGroups)
    topc_merge_kernel(const float* __restrict__ part_dist, const int* __restrict__ part_row,
                      const int* __restrict__ lives, int nprobe, int chunk_rows, int nchunks,
                      float* __restrict__ cand_dist, int* __restrict__ cand_row,
                      float* __restrict__ drop_min) {
  __shared__ float sd[kMergeGroups][kKeep][32];
  __shared__ int si[kMergeGroups][kKeep][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  float td[kKeep];
  int ti[kKeep];
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    td[t] = INFINITY;
    ti[t] = kInvalidRow;
  }
  int j = 0;
  for (int p = 0; p < nprobe; ++p) {
    const int pair = b * nprobe + p;
    const int nch = min(nchunks, (lives[pair] + chunk_rows - 1) / chunk_rows);
    for (int ch = 0; ch < nch; ++ch, ++j) {
      if (j % kMergeGroups != g) continue;
      const size_t base = (static_cast<size_t>(pair) * nchunks + ch) * kKeep;
#pragma unroll
      for (int t = 0; t < kKeep; ++t) {
        insert_keep(td, ti, part_dist[(base + t) * kThreads + c], part_row[(base + t) * kThreads + c]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    sd[g][t][lane] = td[t];
    si[g][t][lane] = ti[t];
  }
  __syncthreads();
  if (g != 0) return;
  for (int h = 1; h < kMergeGroups; ++h) {
#pragma unroll
    for (int t = 0; t < kKeep; ++t) insert_keep(td, ti, sd[h][t][lane], si[h][t][lane]);
  }
#pragma unroll
  for (int t = 0; t < kTiers; ++t) {
    const size_t o = static_cast<size_t>(b) * kTiers * kThreads + t * kThreads + c;
    cand_dist[o] = td[t];
    cand_row[o] = td[t] < INFINITY ? ti[t] : 0;
  }
  drop_min[static_cast<size_t>(b) * kThreads + c] = td[kTiers];
}

// ---------------------------------------------------------------------------
// the list-major K4/K5 and the one-launch K3
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory geometry of a ring of STAGES stages, each holding ROWS row
// slices of at most SLICE bytes (T elements at `stride`), their ||x||^2 and
// QROWS query slices (f32, kElems apart). Host and device compute the same.
template <typename T, int ROWS, int SLICE, int STAGES, int QROWS>
struct Ring {
  static constexpr int kElems = SLICE / static_cast<int>(sizeof(T));  // elements of a slice
  int nsl;     // k-slices of a row
  int stride;  // elements between two rows' slices: odd multiple of 16 bytes
  __host__ __device__ explicit Ring(int d) {
    nsl = (d + kElems - 1) / kElems;
    const int w = (d < kElems ? d : kElems) * static_cast<int>(sizeof(T));
    stride = ((w + 31) / 32 * 32 + 16) / static_cast<int>(sizeof(T));
  }
  __host__ __device__ size_t rows_bytes() const {
    return static_cast<size_t>(STAGES) * ROWS * stride * sizeof(T);
  }
  __host__ __device__ size_t sq_offset() const { return rows_bytes(); }
  __host__ __device__ size_t q_offset() const {
    return rows_bytes() + STAGES * ROWS * sizeof(float);
  }
  __host__ __device__ size_t bytes() const {
    return q_offset() + static_cast<size_t>(STAGES) * QROWS * kElems * sizeof(float);
  }
};

// Copy rows [r0, r0 + nrows) of x [*, d], columns [k0, k0 + w), to dst at
// `stride`: 16-byte cp.async pieces (vec: row bytes and x 16-byte aligned),
// else plain loads. Consecutive threads take consecutive pieces.
template <typename T, int NTHREADS>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, const T* __restrict__ x, size_t r0,
                                           int nrows, int d, int k0, int w, int stride, bool vec) {
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    const int per_row = w / E;
    for (int i = threadIdx.x; i < nrows * per_row; i += NTHREADS) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * E;
      cp_async16(dst + r * stride + c, x + (r0 + r) * d + k0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * w; i += NTHREADS) {
      const int r = i / w;
      const int c = i - r * w;
      dst[r * stride + c] = x[(r0 + r) * d + k0 + c];
    }
  }
}

// 16 bytes of a row slice in shared memory as f32 (bf16 -> f32 is exact).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <int E>
__device__ __forceinline__ void load_q(const float* p, float (&v)[E]) {
#pragma unroll
  for (int j = 0; j < E; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + j);
    v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
  }
}

// K4/K5, list-major: grid (sorted position, row chunk), kScoreRows *
// kScoreSplit threads. order [P]: pair ids sorted stably by start row;
// glen [P]: pairs the CTA at a position serves (0: not a leader). Both
// null: every pair is its own group (order = identity). Thread (h, t) owns
// row t of a tile and the chains of pairs h, h + kScoreSplit, ... of the
// group.
template <typename T, int METRIC, bool SENTINEL>
__global__ void __launch_bounds__(kScoreRows * kScoreSplit, 1024 / (kScoreRows * kScoreSplit))
    probe_scores_grouped_kernel(const float* __restrict__ qr, const float* __restrict__ qterm,
                                const int* __restrict__ starts, const int* __restrict__ lives,
                                const int* __restrict__ order, const int* __restrict__ glen,
                                const T* __restrict__ x, const float* __restrict__ sqn, int nprobe,
                                int d, int probe_cap, int chunk_rows, bool vec,
                                float* __restrict__ out) {
  using R = Ring<T, kScoreRows, kScoreSlice, kScoreStages, kGroup>;
  constexpr int SPLIT = kScoreSplit;
  constexpr int STAGES = kScoreStages;
  constexpr int NT = kScoreRows * SPLIT;
  constexpr int PER = kGroup / SPLIT;  // chains a thread holds
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int pos = blockIdx.x;
  const int t = threadIdx.x % kScoreRows;
  const int h = threadIdx.x / kScoreRows;
  // the group's length and its pair ids load together (no dependent hop)
  const int g = glen != nullptr ? glen[pos] : 1;
  const int mine = order != nullptr && threadIdx.x < kGroup && pos + threadIdx.x < gridDim.x
                       ? order[pos + threadIdx.x]
                       : pos;
  if (g == 0) return;
  __shared__ int s_pair[kGroup];
  __shared__ int s_b[kGroup];
  __shared__ int s_live[kGroup];
  __shared__ float s_qt[kGroup];
  __shared__ int s_start;
  if (static_cast<int>(threadIdx.x) < g) {
    s_pair[threadIdx.x] = mine;
    s_b[threadIdx.x] = mine / nprobe;
    s_live[threadIdx.x] = lives[mine];
    s_qt[threadIdx.x] = qterm[mine / nprobe];
    if (threadIdx.x == 0) s_start = starts[mine];
  }
  __syncthreads();
  const int start = s_start;
  int maxlive = 0;
  for (int j = 0; j < g; ++j) maxlive = max(maxlive, s_live[j]);
  const int o0 = blockIdx.y * chunk_rows;
  const int o1 = min(o0 + chunk_rows, probe_cap);
  const int oend = max(o0, min(o1, maxlive));  // rows [o0, oend) are read
  const R ring(d);
  const int ntiles = (oend - o0 + kScoreRows - 1) / kScoreRows;
  const int nunits = ntiles * ring.nsl;  // a unit: one k-slice of one tile

  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  T* rows = reinterpret_cast<T*>(base);
  float* sqs = reinterpret_cast<float*>(base + ring.sq_offset());
  float* qs = reinterpret_cast<float*>(base + ring.q_offset());
  constexpr int QS = R::kElems * kGroup;  // floats of one stage's query slices

  auto issue = [&](int u) {
    const int tile = u / ring.nsl;
    const int sl = u - tile * ring.nsl;
    const int st = u % STAGES;
    const int k0 = sl * R::kElems;
    const int w = min(R::kElems, d - k0);
    const int r = o0 + tile * kScoreRows;
    const int nrows = min(kScoreRows, oend - r);
    stage_rows<T, NT>(rows + st * kScoreRows * ring.stride, x, static_cast<size_t>(start) + r,
                      nrows, d, k0, w, ring.stride, vec);
    if (sl == ring.nsl - 1 && static_cast<int>(threadIdx.x) < nrows) {
      cp_async4(sqs + st * kScoreRows + threadIdx.x, sqn + start + r + threadIdx.x);
    }
    if (ring.nsl > 1 || u == 0) {  // one slice: the queries are staged once
      float* q = qs + (ring.nsl > 1 ? st : 0) * QS;
      for (int i = threadIdx.x; i < g * w; i += NT) {
        const int j = i / w;
        const int c = i - j * w;
        cp_async4(q + j * R::kElems + c, qr + static_cast<size_t>(s_b[j]) * d + k0 + c);
      }
    }
  };

  float acc[PER];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nunits) issue(s);
    cp_async_commit();
  }
  for (int u = 0; u < nunits; ++u) {
    if (u + STAGES - 1 < nunits) issue(u + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int tile = u / ring.nsl;
    const int sl = u - tile * ring.nsl;
    const int st = u % STAGES;
    const int w = min(R::kElems, d - sl * R::kElems);
    const T* xr = rows + (st * kScoreRows + t) * ring.stride;
    const float* q = qs + (ring.nsl > 1 ? st : 0) * QS;
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
    }
    if (h < g) {
      const int wv = w - w % E;
      for (int c = 0; c < wv; c += E) {
        float xv[E];
        load16(xr + c, xv);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int j = h + SPLIT * i;
          if (j < g) {
            float qv[E];
            load_q<E>(q + j * R::kElems + c, qv);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i] = __fadd_rn(acc[i], __fmul_rn(qv[e], xv[e]));
          }
        }
      }
      for (int c = wv; c < w; ++c) {  // d % E tail (rows staged by plain loads)
        const float xv = widen(xr[c]);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int j = h + SPLIT * i;
          if (j < g) acc[i] = __fadd_rn(acc[i], __fmul_rn(q[j * R::kElems + c], xv));
        }
      }
    }
    if (sl == ring.nsl - 1) {
      const int off = o0 + tile * kScoreRows + t;
      if (off < o1) {
        const float sq = off < oend ? sqs[st * kScoreRows + t] : 0.0f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int j = h + SPLIT * i;
          if (j < g) {
            out[static_cast<size_t>(s_pair[j]) * probe_cap + off] =
                off < s_live[j] ? probe_epilogue<METRIC, SENTINEL>(acc[i], s_qt[j], sq) : INFINITY;
          }
        }
      }
    }
    __syncthreads();
  }
  // slots past the last tile read: +inf for every pair of the group
  for (int j = h; j < g; j += SPLIT) {
    float* o = out + static_cast<size_t>(s_pair[j]) * probe_cap;
    for (int off = o0 + ntiles * kScoreRows + t; off < o1; off += kScoreRows) o[off] = INFINITY;
  }
}

// Fold into td/ti (class c) the partials id(0) .. id(n - 1), each [kKeep]
// [class] at part_[dist|row] + id * kKeep * kThreads, kMergeBatch partials'
// loads at a time; they were written by other CTAs, so the loads bypass L1.
template <typename Id>
__device__ __forceinline__ void fold_partials(float (&td)[kKeep], int (&ti)[kKeep],
                                              const float* __restrict__ part_dist,
                                              const int* __restrict__ part_row, int n, Id id,
                                              int c) {
  for (int i0 = 0; i0 < n; i0 += kMergeBatch) {
    float vd[kMergeBatch][kKeep];
    int vr[kMergeBatch][kKeep];
#pragma unroll
    for (int m = 0; m < kMergeBatch; ++m) {
      const bool ok = i0 + m < n;
      const size_t pb = static_cast<size_t>(ok ? id(i0 + m) : 0) * kKeep;
#pragma unroll
      for (int t = 0; t < kKeep; ++t) {
        vd[m][t] = ok ? __ldcg(part_dist + (pb + t) * kThreads + c) : INFINITY;
        vr[m][t] = ok ? __ldcg(part_row + (pb + t) * kThreads + c) : kInvalidRow;
      }
    }
#pragma unroll
    for (int m = 0; m < kMergeBatch; ++m) {
#pragma unroll
      for (int t = 0; t < kKeep; ++t) insert_keep(td, ti, vd[m][t], vr[m][t]);
    }
  }
}

// K3 in one launch: grid (pair, row chunk), kThreads threads. A CTA whose
// chunk holds live rows scans them (thread t: rows start + o0 + t + 256 j,
// one class) and writes its per-class top-4 to part_[dist|row], laid out
// [pair][chunk][kKeep][class]; every CTA then arrives at its query's
// counter (arrivals [nq]), and the last to arrive folds the query's live
// partials into cand [query][tier * 256 + class] (unfilled: +inf, row 0)
// and drop_min, and resets the counter to 0.
template <typename T, int METRIC>
__global__ void __launch_bounds__(kThreads, 2)
    topc_kernel(const float* __restrict__ qr, const float* __restrict__ qterm,
                const int* __restrict__ starts, const int* __restrict__ lives,
                const T* __restrict__ x, const float* __restrict__ sqn, int nprobe, int d,
                int chunk_rows, int nchunks, bool vec, float* __restrict__ part_dist,
                int* __restrict__ part_row, int* __restrict__ arrivals,
                float* __restrict__ cand_dist, int* __restrict__ cand_row,
                float* __restrict__ drop_min) {
  constexpr int STAGES = kTopcStages;
  using R = Ring<T, kThreads, kTopcSlice, STAGES, 1>;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int pair = blockIdx.x;
  const int b = pair / nprobe;
  const int live = lives[pair];
  const int start = starts[pair];
  const float qt = qterm[b];
  const int o0 = blockIdx.y * chunk_rows;
  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  float td[kKeep];
  int ti[kKeep];
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    td[t] = INFINITY;
    ti[t] = kInvalidRow;
  }
  if (o0 < live) {
    const int o1 = min(o0 + chunk_rows, live);
    const R ring(d);
    const int ntiles = (o1 - o0 + kThreads - 1) / kThreads;
    const int nunits = ntiles * ring.nsl;
    T* rows = reinterpret_cast<T*>(base);
    float* sqs = reinterpret_cast<float*>(base + ring.sq_offset());
    float* qs = reinterpret_cast<float*>(base + ring.q_offset());
    const float* qrow = qr + static_cast<size_t>(b) * d;

    auto issue = [&](int u) {
      const int tile = u / ring.nsl;
      const int sl = u - tile * ring.nsl;
      const int st = u % STAGES;
      const int k0 = sl * R::kElems;
      const int w = min(R::kElems, d - k0);
      const int r = o0 + tile * kThreads;
      const int nrows = min(kThreads, o1 - r);
      stage_rows<T, kThreads>(rows + st * kThreads * ring.stride, x, static_cast<size_t>(start) + r,
                              nrows, d, k0, w, ring.stride, vec);
      if (sl == ring.nsl - 1 && static_cast<int>(threadIdx.x) < nrows) {
        cp_async4(sqs + st * kThreads + threadIdx.x, sqn + start + r + threadIdx.x);
      }
      if ((ring.nsl > 1 || u == 0) && static_cast<int>(threadIdx.x) < w) {
        cp_async4(qs + (ring.nsl > 1 ? st : 0) * R::kElems + threadIdx.x, qrow + k0 + threadIdx.x);
      }
    };

    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nunits) issue(s);
      cp_async_commit();
    }
    for (int u = 0; u < nunits; ++u) {
      if (u + STAGES - 1 < nunits) issue(u + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int tile = u / ring.nsl;
      const int sl = u - tile * ring.nsl;
      const int st = u % STAGES;
      const int w = min(R::kElems, d - sl * R::kElems);
      const T* xr = rows + (st * kThreads + threadIdx.x) * ring.stride;
      const float* q = qs + (ring.nsl > 1 ? st : 0) * R::kElems;
      if (sl == 0) acc = 0.0f;
      const int wv = w - w % E;
      for (int c = 0; c < wv; c += E) {
        float xv[E], qv[E];
        load16(xr + c, xv);
        load_q<E>(q + c, qv);
#pragma unroll
        for (int e = 0; e < E; ++e) acc = __fadd_rn(acc, __fmul_rn(qv[e], xv[e]));
      }
      for (int c = wv; c < w; ++c) acc = __fadd_rn(acc, __fmul_rn(q[c], widen(xr[c])));
      if (sl == ring.nsl - 1) {
        const int off = o0 + tile * kThreads + threadIdx.x;
        if (off < o1) {
          const float sq = sqs[st * kThreads + threadIdx.x];
          insert_keep(td, ti, probe_epilogue<METRIC, true>(acc, qt, sq), start + off);
        }
      }
      __syncthreads();
    }
    const int cls = (start + o0 + static_cast<int>(threadIdx.x)) & (kThreads - 1);
    const size_t pbase = (static_cast<size_t>(pair) * nchunks + blockIdx.y) * kKeep;
#pragma unroll
    for (int t = 0; t < kKeep; ++t) {
      part_dist[(pbase + t) * kThreads + cls] = td[t];
      part_row[(pbase + t) * kThreads + cls] = ti[t];
    }
  }
  // arrive; the last CTA of the query folds the query's live partials
  __shared__ int s_last;
  __shared__ int s_n;
  const int c = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (c == 0) s_last = atomicAdd(arrivals + b, 1) == nprobe * nchunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int t = 0; t < kKeep; ++t) {
    td[t] = INFINITY;
    ti[t] = kInvalidRow;
  }
  // the ids of the query's live partials, a window at a time, listed in
  // shared memory (the ring is free now) in any order: the insert does not
  // depend on it
  int* list = reinterpret_cast<int*>(base);
  const int total = nprobe * nchunks;
  for (int w0 = 0; w0 < total; w0 += kMergeWindow) {
    if (c == 0) s_n = 0;
    __syncthreads();
    for (int j = w0 + c; j < min(w0 + kMergeWindow, total); j += kThreads) {
      const int p = j / nchunks;
      if ((j - p * nchunks) * chunk_rows < lives[b * nprobe + p]) {
        list[atomicAdd(&s_n, 1)] = b * total + j;
      }
    }
    __syncthreads();
    fold_partials(td, ti, part_dist, part_row, s_n, [&](int i) { return list[i]; }, c);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kTiers; ++t) {
    const size_t o = static_cast<size_t>(b) * kTiers * kThreads + t * kThreads + c;
    cand_dist[o] = td[t];
    cand_row[o] = td[t] < INFINITY ? ti[t] : 0;
  }
  drop_min[static_cast<size_t>(b) * kThreads + c] = td[kTiers];
  if (c == 0) arrivals[b] = 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t query_smem(int d) { return static_cast<size_t>((d + 7) / 8 * 8) * sizeof(float); }

bool vec_ok(const void* x, int d) { return d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

// The first design's launchers.
template <typename T, int METRIC, bool SENTINEL>
cudaError_t launch_scores_v1(const float* qr, const float* qterm, const int* starts,
                             const int* lives, const void* x, const float* sqn, int nq, int nprobe,
                             int d, int probe_cap, float* out, cudaStream_t stream) {
  const size_t smem = query_smem(d);
  cudaError_t err = allow_smem(probe_scores_kernel<T, METRIC, SENTINEL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nq * nprobe, (probe_cap + kScoresChunk - 1) / kScoresChunk);
  probe_scores_kernel<T, METRIC, SENTINEL><<<grid, kThreads, smem, stream>>>(
      qr, qterm, starts, lives, static_cast<const T*>(x), sqn, nprobe, d, probe_cap, vec_ok(x, d),
      out);
  return cudaGetLastError();
}

template <typename T, int METRIC>
cudaError_t launch_topc_v1(const float* qr, const float* qterm, const int* starts,
                           const int* lives, const void* x, const float* sqn, int nq, int nprobe,
                           int d, int chunk_rows, int nchunks, float* part_dist, int* part_row,
                           float* cand_dist, int* cand_row, float* drop_min, cudaStream_t stream) {
  const size_t smem = query_smem(d);
  cudaError_t err = allow_smem(topc_scan_kernel<T, METRIC>, smem);
  if (err != cudaSuccess) return err;
  topc_scan_kernel<T, METRIC><<<dim3(nq * nprobe, nchunks), kThreads, smem, stream>>>(
      qr, qterm, starts, lives, static_cast<const T*>(x), sqn, nprobe, d, chunk_rows, nchunks,
      vec_ok(x, d), part_dist, part_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topc_merge_kernel<<<dim3(nq, kThreads / 32), 32 * kMergeGroups, 0, stream>>>(
      part_dist, part_row, lives, nprobe, chunk_rows, nchunks, cand_dist, cand_row, drop_min);
  return cudaGetLastError();
}

// 16-byte cp.async of whole rows: row bytes and the base 16-byte aligned.
template <typename T>
bool rows16_ok(const void* x, int d) {
  return (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, int METRIC, bool SENTINEL>
cudaError_t launch_scores(const float* qr, const float* qterm, const int* starts,
                          const int* lives, const int* order, const int* glen, const void* x,
                          const float* sqn, int nq, int nprobe, int d, int probe_cap,
                          int chunk_rows, float* out, cudaStream_t stream) {
  if (chunk_rows <= 0 || chunk_rows % kScoreRows) return cudaErrorInvalidValue;
  const size_t smem = Ring<T, kScoreRows, kScoreSlice, kScoreStages, kGroup>(d).bytes();
  auto kernel = probe_scores_grouped_kernel<T, METRIC, SENTINEL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nq * nprobe, (probe_cap + chunk_rows - 1) / chunk_rows);
  kernel<<<grid, kScoreRows * kScoreSplit, smem, stream>>>(
      qr, qterm, starts, lives, order, glen, static_cast<const T*>(x), sqn, nprobe, d, probe_cap,
      chunk_rows, rows16_ok<T>(x, d), out);
  return cudaGetLastError();
}

template <typename T, int METRIC>
cudaError_t launch_topc(const float* qr, const float* qterm, const int* starts, const int* lives,
                        const void* x, const float* sqn, int nq, int nprobe, int d,
                        int chunk_rows, int nchunks, float* part_dist, int* part_row,
                        int* arrivals, float* cand_dist, int* cand_row, float* drop_min,
                        cudaStream_t stream) {
  if (chunk_rows <= 0 || chunk_rows % kThreads) return cudaErrorInvalidValue;
  const size_t smem = Ring<T, kThreads, kTopcSlice, kTopcStages, 1>(d).bytes();
  auto kernel = topc_kernel<T, METRIC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nq * nprobe, nchunks), kThreads, smem, stream>>>(
      qr, qterm, starts, lives, static_cast<const T*>(x), sqn, nprobe, d, chunk_rows, nchunks,
      rows16_ok<T>(x, d), part_dist, part_row, arrivals, cand_dist, cand_row, drop_min);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; metric: 0 = L2, 1 = IP, 2 = cosine.
#define VI_PROBE_DISPATCH(FN, ...)                                                        \
  do {                                                                                    \
    if (dtype == 0 && metric == kL2) return static_cast<int>(FN<float, kL2>(__VA_ARGS__));           \
    if (dtype == 0 && metric == kIP) return static_cast<int>(FN<float, kIP>(__VA_ARGS__));           \
    if (dtype == 0 && metric == kCos) return static_cast<int>(FN<float, kCos>(__VA_ARGS__));         \
    if (dtype == 1 && metric == kL2) return static_cast<int>(FN<__nv_bfloat16, kL2>(__VA_ARGS__));   \
    if (dtype == 1 && metric == kIP) return static_cast<int>(FN<__nv_bfloat16, kIP>(__VA_ARGS__));   \
    if (dtype == 1 && metric == kCos) return static_cast<int>(FN<__nv_bfloat16, kCos>(__VA_ARGS__)); \
    return static_cast<int>(cudaErrorInvalidValue);                                       \
  } while (0)

template <typename T, int METRIC>
static cudaError_t launch_scores_any(int sentinel, const float* qr, const float* qterm,
                                     const int* starts, const int* lives, const int* order,
                                     const int* glen, const void* x, const float* sqn, int nq,
                                     int nprobe, int d, int probe_cap, int chunk_rows, float* out,
                                     cudaStream_t stream) {
  if (sentinel) {
    return launch_scores<T, METRIC, true>(qr, qterm, starts, lives, order, glen, x, sqn, nq,
                                          nprobe, d, probe_cap, chunk_rows, out, stream);
  }
  return launch_scores<T, METRIC, false>(qr, qterm, starts, lives, order, glen, x, sqn, nq, nprobe,
                                         d, probe_cap, chunk_rows, out, stream);
}

template <typename T, int METRIC>
static cudaError_t launch_scores_v1_any(int sentinel, const float* qr, const float* qterm,
                                        const int* starts, const int* lives, const void* x,
                                        const float* sqn, int nq, int nprobe, int d,
                                        int probe_cap, float* out, cudaStream_t stream) {
  if (sentinel) {
    return launch_scores_v1<T, METRIC, true>(qr, qterm, starts, lives, x, sqn, nq, nprobe, d,
                                             probe_cap, out, stream);
  }
  return launch_scores_v1<T, METRIC, false>(qr, qterm, starts, lives, x, sqn, nq, nprobe, d,
                                            probe_cap, out, stream);
}

extern "C" {

// K4 (sentinel 0) and K5 (sentinel 1), list-major. qr [nq, d] f32, q
// rounded to the storage dtype; qterm [nq] f32; starts, lives [nq, nprobe]
// int32; order, glen [nq * nprobe] int32 (kernels/ivf_probe.probe_groups,
// glen <= 16), or both null (every pair its own group); x [n, d] (dtype);
// sqn [n] f32; out [nq, nprobe * probe_cap] f32; chunk_rows a multiple of
// 128.
int vi_ivf_probe_scores(const void* qr, const void* qterm, const void* starts, const void* lives,
                        const void* order, const void* glen, const void* x, const void* sqn,
                        int nq, int nprobe, int d, int probe_cap, int chunk_rows, int dtype,
                        int metric, int sentinel, void* out, void* stream) {
  VI_PROBE_DISPATCH(launch_scores_any, sentinel, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), static_cast<const int*>(order),
                    static_cast<const int*>(glen), x, static_cast<const float*>(sqn), nq, nprobe,
                    d, probe_cap, chunk_rows, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
}

// K4/K5's first design: one CTA per (pair, 1024-row chunk).
int vi_ivf_probe_scores_v1(const void* qr, const void* qterm, const void* starts,
                           const void* lives, const void* x, const void* sqn, int nq, int nprobe,
                           int d, int probe_cap, int dtype, int metric, int sentinel, void* out,
                           void* stream) {
  VI_PROBE_DISPATCH(launch_scores_v1_any, sentinel, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), x, static_cast<const float*>(sqn), nq,
                    nprobe, d, probe_cap, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
}

// K3 in one launch. part_* [nq * nprobe * nchunks, 4, 256] scratch;
// arrivals [nq] int32, all 0 on entry and on return; cand_* [nq, 768];
// drop_min [nq, 256]; chunk_rows a multiple of 256.
int vi_ivf_probe_topc(const void* qr, const void* qterm, const void* starts, const void* lives,
                      const void* x, const void* sqn, int nq, int nprobe, int d, int chunk_rows,
                      int nchunks, int dtype, int metric, void* part_dist, void* part_row,
                      void* arrivals, void* cand_dist, void* cand_row, void* drop_min,
                      void* stream) {
  VI_PROBE_DISPATCH(launch_topc, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), x, static_cast<const float*>(sqn), nq,
                    nprobe, d, chunk_rows, nchunks, static_cast<float*>(part_dist),
                    static_cast<int*>(part_row), static_cast<int*>(arrivals),
                    static_cast<float*>(cand_dist), static_cast<int*>(cand_row),
                    static_cast<float*>(drop_min), static_cast<cudaStream_t>(stream));
}

// K3's first design: a scan launch and a merge launch.
int vi_ivf_probe_topc_v1(const void* qr, const void* qterm, const void* starts,
                         const void* lives, const void* x, const void* sqn, int nq, int nprobe,
                         int d, int chunk_rows, int nchunks, int dtype, int metric,
                         void* part_dist, void* part_row, void* cand_dist, void* cand_row,
                         void* drop_min, void* stream) {
  VI_PROBE_DISPATCH(launch_topc_v1, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), x, static_cast<const float*>(sqn), nq,
                    nprobe, d, chunk_rows, nchunks, static_cast<float*>(part_dist),
                    static_cast<int*>(part_row), static_cast<float*>(cand_dist),
                    static_cast<int*>(cand_row), static_cast<float*>(drop_min),
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
