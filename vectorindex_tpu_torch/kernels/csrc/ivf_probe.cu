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
// never read a dead row. One __device__ function, probe_distance, gives
// every distance: q is rounded to the storage dtype by the caller,
// g = sum_k q[k] x[k] is one chain in k order with each product and each
// sum rounded separately (__fmul_rn, __fadd_rn: no FMA contraction), and
// the epilogue uses explicitly rounded operations (a correctly rounded
// square root and division for cosine). The plain PyTorch versions in
// kernels/ivf_probe.py perform the same operations in the same order, so
// kernel and plain version agree bit for bit.
//
// K4/K5: grid (pair, row chunk of 1024), 256 threads, one thread per row;
// each CTA writes its slots of the [B, nprobe * probe_cap] output, +inf
// past the live length. K5 is K4 with the deny sentinel on: a non-finite
// ||x||^2 gives +inf for IP and cosine (L2 gets +inf from the arithmetic).
// The TPU's rank-major grid exists to batch DMAs; on Hopper one kernel
// serves both.
//
// K3: the TPU kernel folds list segments in grid order into one resident
// binned accumulator. Here the output is defined as a function of the set
// of live probed rows: per query and per class (CSR row mod 256) the 3
// smallest finite (dist, row) pairs in lexicographic order, plus the
// class's 4th-smallest distance (drop_min). That is decomposable, so a scan
// launch runs CTAs over (pair, row chunk), each keeping a sorted top-4 per
// class in registers (thread t owns one class: 256 threads cover the 256
// classes of every 256-row block), and writes it to a partial buffer; a
// merge launch folds a query's live partials (grid (query, 32-class
// group), as scan_fused.cu's merge_splits_kernel). The lexicographic insert
// makes the result independent of chunking and order.
//
// Bounds on the H100: each kernel reads every live probed row once
// (d * itemsize + 4 bytes) and does 2 d operations per row, so all three
// are bound by bytes (K4/K5 also write B * nprobe * probe_cap floats). The
// design reads rows with 16-byte vector loads and does no reuse across
// queries that probe the same list; cp.async/TMA staging, warp-per-row
// loads and wgmma are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads per scan CTA = classes per query
constexpr int kTiers = 3;        // K3 candidates kept per class
constexpr int kKeep = kTiers + 1;  // + the 4th smallest, for drop_min
constexpr int kScoresChunk = 1024;  // rows per K4/K5 CTA
constexpr int kMergeGroups = 8;  // partial groups per class in the merge launch
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

// The one distance function of K3, K4 and K5. qterm: ||q||^2 (L2), 1/||q||
// (cosine), unused (IP); sq = ||x||^2 of the row.
template <typename T, int METRIC, bool SENTINEL>
__device__ __forceinline__ float probe_distance(const float* __restrict__ qs,
                                               const T* __restrict__ xrow, int d, bool vec,
                                               float qterm, float sq) {
  const float g = dot_seq(qs, xrow, d, vec);
  if (METRIC == kL2) return __fsub_rn(__fadd_rn(qterm, sq), __fmul_rn(2.0f, g));
  if (SENTINEL && !(sq < INFINITY)) return INFINITY;
  if (METRIC == kIP) return -g;
  const float xinv = sq > 0.0f ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(sq, 1e-30f))) : 0.0f;
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(g, qterm), xinv));
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t query_smem(int d) { return static_cast<size_t>((d + 7) / 8 * 8) * sizeof(float); }

bool vec_ok(const void* x, int d) { return d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

template <typename T, int METRIC, bool SENTINEL>
cudaError_t launch_scores(const float* qr, const float* qterm, const int* starts,
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
cudaError_t launch_topc(const float* qr, const float* qterm, const int* starts, const int* lives,
                        const void* x, const float* sqn, int nq, int nprobe, int d,
                        int chunk_rows, int nchunks, float* part_dist, int* part_row,
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
                                     const int* starts, const int* lives, const void* x,
                                     const float* sqn, int nq, int nprobe, int d, int probe_cap,
                                     float* out, cudaStream_t stream) {
  if (sentinel) {
    return launch_scores<T, METRIC, true>(qr, qterm, starts, lives, x, sqn, nq, nprobe, d,
                                          probe_cap, out, stream);
  }
  return launch_scores<T, METRIC, false>(qr, qterm, starts, lives, x, sqn, nq, nprobe, d,
                                         probe_cap, out, stream);
}

extern "C" {

// K4 (sentinel 0) and K5 (sentinel 1). qr [nq, d] f32, q rounded to the
// storage dtype; qterm [nq] f32; starts, lives [nq, nprobe] int32; x [n, d]
// (dtype); sqn [n] f32; out [nq, nprobe * probe_cap] f32.
int vi_ivf_probe_scores(const void* qr, const void* qterm, const void* starts, const void* lives,
                        const void* x, const void* sqn, int nq, int nprobe, int d, int probe_cap,
                        int dtype, int metric, int sentinel, void* out, void* stream) {
  VI_PROBE_DISPATCH(launch_scores_any, sentinel, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), x, static_cast<const float*>(sqn), nq,
                    nprobe, d, probe_cap, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
}

// K3. part_* [nq * nprobe * nchunks, 4, 256] scratch; cand_* [nq, 768];
// drop_min [nq, 256].
int vi_ivf_probe_topc(const void* qr, const void* qterm, const void* starts, const void* lives,
                      const void* x, const void* sqn, int nq, int nprobe, int d, int chunk_rows,
                      int nchunks, int dtype, int metric, void* part_dist, void* part_row,
                      void* cand_dist, void* cand_row, void* drop_min, void* stream) {
  VI_PROBE_DISPATCH(launch_topc, static_cast<const float*>(qr),
                    static_cast<const float*>(qterm), static_cast<const int*>(starts),
                    static_cast<const int*>(lives), x, static_cast<const float*>(sqn), nq,
                    nprobe, d, chunk_rows, nchunks, static_cast<float*>(part_dist),
                    static_cast<int*>(part_row), static_cast<float*>(cand_dist),
                    static_cast<int*>(cand_row), static_cast<float*>(drop_min),
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
