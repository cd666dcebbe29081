// Fused flat-scan kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/scan_fused.py:
//
//   K1 bin_candidates   replaces scan_fused.py:_bin_candidates
//                       (body _candidates_kernel, _dist_tile, _reduce_tile)
//   K2 count_below      replaces scan_fused.py:_count_below
//                       (body _count_kernel)
//
// Both scan a corpus x [n, d] (f32 or bf16, n a multiple of 256) against a
// query block q [nq, d] f32 in kernel space:
//
//   L2:     dist = bias - 2 (q.x)        bias = ||x||^2, +inf for dead rows
//   IP:     dist = bias - (q.x)          bias = 0,       +inf for dead rows
//   cosine: dist = bias - (q.x) cs       cs = 1/||x||,   q pre-normalised
//
// with q rounded to the corpus dtype before the product (scan_fused.py:85).
//
// K1 returns, per query and per class c = row mod 256, the 3 smallest finite
// (dist, row) pairs over the whole corpus in strict (dist, row) order;
// unfilled tiers are (+inf, INVALID_ID). The TPU kernel walks the corpus in
// order into one resident accumulator; here CTAs run in parallel and in no
// order, so the grid is (query block, corpus split): each CTA keeps exact
// per-class top-3 over its split in registers (thread t owns class t, and a
// 256-row tile holds exactly one row of each class), and a second small
// launch merges the splits. Per-class top-3 is decomposable (the top-3 of a
// union is the top-3 of the parts' top-3s) and the lexicographic insert is
// order-free, so the result does not depend on the split count. It keeps at
// least what the TPU kernel keeps (which drops a tile's third-smallest). The
// insert and the merge launch live in class_top3.cuh, shared with K8.
//
// K2 counts, per query, rows with dist < tau and dist <= tau. Each CTA counts
// its split and adds into per-query int32 counters with atomicAdd: integer
// atomics are order-free, so the counts are deterministic.
//
// The exactness proof (scan_fused.py:17-21) needs K2 to recompute, bit for
// bit, the float K1 produced for every (query, row). Both kernels call the
// one __device__ function row_distances: each query's dot product is a
// single __fmaf_rn chain over k = 0..d-1 in order, independent of the query
// block, the split and the row's place in a tile, and the epilogue uses
// explicitly rounded intrinsics that nvcc cannot contract. Both are built by
// one nvcc call without --use_fast_math.
//
// Bounds on the H100: at B=256, d=128 each pass is 2*B*n*d FLOPs on the
// CUDA cores' f32 FMA pipe (no tensor cores: f32 corpora must stay full f32,
// and bf16 x bf16 products are exact in f32 FMA), so the kernels are bound
// by the FMA rate; queries are staged in shared memory, transposed so one
// 16-byte broadcast load feeds 4 FMAs, and each corpus element loaded is
// used by the block's 8 queries (the 32 query blocks of one split run close
// together, so the corpus comes from L2 after its first read). At small B
// they are bound by reading the corpus bytes once per pass. wgmma, TMA and
// shared-memory staging of corpus tiles are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "class_top3.cuh"

namespace {

constexpr int kTB = 8;  // queries per CTA
constexpr int kL2 = 0, kIP = 1, kCos = 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// q rounded to the storage dtype and widened back to f32.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive corpus elements as f32; vec means 16-byte aligned.
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

// acc[b] += q[b][k] * xk for the block's 8 queries; qk points at the
// transposed shared-memory column q[0..7][k].
__device__ __forceinline__ void fma8(const float* __restrict__ qk, float xk, float (&acc)[kTB]) {
  const float4 lo = reinterpret_cast<const float4*>(qk)[0];
  const float4 hi = reinterpret_cast<const float4*>(qk)[1];
  acc[0] = __fmaf_rn(lo.x, xk, acc[0]);
  acc[1] = __fmaf_rn(lo.y, xk, acc[1]);
  acc[2] = __fmaf_rn(lo.z, xk, acc[2]);
  acc[3] = __fmaf_rn(lo.w, xk, acc[3]);
  acc[4] = __fmaf_rn(hi.x, xk, acc[4]);
  acc[5] = __fmaf_rn(hi.y, xk, acc[5]);
  acc[6] = __fmaf_rn(hi.z, xk, acc[6]);
  acc[7] = __fmaf_rn(hi.w, xk, acc[7]);
}

// Kernel-space distances of one corpus row to the CTA's 8 queries. The one
// distance function of both kernels (see the file comment).
template <typename T, int METRIC>
__device__ __forceinline__ void row_distances(const float* __restrict__ qs,
                                              const T* __restrict__ xrow, int d, bool vec,
                                              float bias, float colscale, float (&dist)[kTB]) {
  float acc[kTB];
#pragma unroll
  for (int b = 0; b < kTB; ++b) acc[b] = 0.0f;
  int k = 0;
  for (; k + 8 <= d; k += 8) {
    float xv[8];
    load8(xrow + k, vec, xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) fma8(qs + (k + j) * kTB, xv[j], acc);
  }
  for (; k < d; ++k) fma8(qs + k * kTB, widen(xrow[k]), acc);
#pragma unroll
  for (int b = 0; b < kTB; ++b) {
    if (METRIC == kL2) {
      dist[b] = __fsub_rn(bias, __fmul_rn(2.0f, acc[b]));
    } else if (METRIC == kIP) {
      dist[b] = __fsub_rn(bias, acc[b]);
    } else {
      dist[b] = __fsub_rn(bias, __fmul_rn(acc[b], colscale));
    }
  }
}

// Stage the CTA's queries into shared memory as qs[k * kTB + b], rounded to
// the storage dtype; queries past nq are zero (their results are dropped).
template <typename T>
__device__ __forceinline__ void stage_queries(float* __restrict__ qs, const float* __restrict__ q,
                                              int q0, int nq, int d) {
  for (int i = threadIdx.x; i < kTB * d; i += blockDim.x) {
    const int b = i / d;
    const int k = i - b * d;
    const float v = (q0 + b < nq) ? q[static_cast<size_t>(q0 + b) * d + k] : 0.0f;
    qs[k * kTB + b] = round_to(v, static_cast<const T*>(nullptr));
  }
  __syncthreads();
}

// K1 scan: grid (query block, split), kClasses threads. Writes per-split
// top-3 to part_[dist|row] laid out [split][query][tier][class].
template <typename T, int METRIC>
__global__ void __launch_bounds__(kClasses)
    bin_candidates_kernel(const float* __restrict__ q, const T* __restrict__ x,
                          const float* __restrict__ bias, const float* __restrict__ colscale,
                          int nq, int d, int ntiles, int tiles_per_split, bool vec,
                          float* __restrict__ part_dist, int* __restrict__ part_row) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int q0 = blockIdx.x * kTB;
  const int split = blockIdx.y;
  const int c = threadIdx.x;
  stage_queries<T>(qs, q, q0, nq, d);

  float td[kTB][kTiers];
  int ti[kTB][kTiers];
#pragma unroll
  for (int b = 0; b < kTB; ++b) {
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      td[b][t] = INFINITY;
      ti[b][t] = kInvalidId;
    }
  }
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int row = tile * kClasses + c;
    float dist[kTB];
    row_distances<T, METRIC>(qs, x + static_cast<size_t>(row) * d, d, vec, bias[row],
                             METRIC == kCos ? colscale[row] : 0.0f, dist);
#pragma unroll
    for (int b = 0; b < kTB; ++b) insert3(td[b], ti[b], dist[b], row);
  }
#pragma unroll
  for (int b = 0; b < kTB; ++b) {
    if (q0 + b >= nq) break;
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      const size_t o = ((static_cast<size_t>(split) * nq + q0 + b) * kTiers + t) * kClasses + c;
      part_dist[o] = td[b][t];
      part_row[o] = ti[b][t];
    }
  }
}

// K2: grid (query block, split), kClasses threads. lt/le must be zeroed.
template <typename T, int METRIC>
__global__ void __launch_bounds__(kClasses)
    count_below_kernel(const float* __restrict__ q, const T* __restrict__ x,
                       const float* __restrict__ bias, const float* __restrict__ colscale,
                       const float* __restrict__ thresh, int nq, int d, int ntiles,
                       int tiles_per_split, bool vec, int* __restrict__ lt,
                       int* __restrict__ le) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  const int q0 = blockIdx.x * kTB;
  const int split = blockIdx.y;
  stage_queries<T>(qs, q, q0, nq, d);

  float tau[kTB];
  int n_lt[kTB], n_le[kTB];
#pragma unroll
  for (int b = 0; b < kTB; ++b) {
    tau[b] = (q0 + b < nq) ? thresh[q0 + b] : -INFINITY;
    n_lt[b] = 0;
    n_le[b] = 0;
  }
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int row = tile * kClasses + threadIdx.x;
    float dist[kTB];
    row_distances<T, METRIC>(qs, x + static_cast<size_t>(row) * d, d, vec, bias[row],
                             METRIC == kCos ? colscale[row] : 0.0f, dist);
#pragma unroll
    for (int b = 0; b < kTB; ++b) {
      n_lt[b] += dist[b] < tau[b];
      n_le[b] += dist[b] <= tau[b];
    }
  }
#pragma unroll
  for (int b = 0; b < kTB; ++b) {
    int a = n_lt[b], e = n_le[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      e += __shfl_down_sync(0xffffffffu, e, off);
    }
    if ((threadIdx.x & 31) == 0 && q0 + b < nq) {
      if (a) atomicAdd(lt + q0 + b, a);
      if (e) atomicAdd(le + q0 + b, e);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int METRIC>
cudaError_t launch_bin(const float* q, const void* x, const float* bias, const float* cs, int nq,
                       int n, int d, int splits, int tiles_per_split, float* part_dist,
                       int* part_row, float* out_dist, int* out_row, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = static_cast<size_t>(kTB) * d * sizeof(float);
  cudaError_t err = allow_smem(bin_candidates_kernel<T, METRIC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTB - 1) / kTB, splits);
  bin_candidates_kernel<T, METRIC><<<grid, kClasses, smem, stream>>>(
      q, xt, bias, cs, nq, d, n / kClasses, tiles_per_split, vec, part_dist, part_row);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge_splits(part_dist, part_row, nq, splits, out_dist, out_row, stream);
}

template <typename T, int METRIC>
cudaError_t launch_count(const float* q, const void* x, const float* bias, const float* cs,
                         const float* thresh, int nq, int n, int d, int splits,
                         int tiles_per_split, int* lt, int* le, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = static_cast<size_t>(kTB) * d * sizeof(float);
  cudaError_t err = allow_smem(count_below_kernel<T, METRIC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTB - 1) / kTB, splits);
  count_below_kernel<T, METRIC><<<grid, kClasses, smem, stream>>>(
      q, xt, bias, cs, thresh, nq, d, n / kClasses, tiles_per_split, vec, lt, le);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; metric: 0 = L2, 1 = IP, 2 = cosine.
#define VI_DISPATCH(FN, ...)                                                          \
  do {                                                                                \
    if (dtype == 0 && metric == kL2) return static_cast<int>(FN<float, kL2>(__VA_ARGS__));              \
    if (dtype == 0 && metric == kIP) return static_cast<int>(FN<float, kIP>(__VA_ARGS__));              \
    if (dtype == 0 && metric == kCos) return static_cast<int>(FN<float, kCos>(__VA_ARGS__));            \
    if (dtype == 1 && metric == kL2) return static_cast<int>(FN<__nv_bfloat16, kL2>(__VA_ARGS__));      \
    if (dtype == 1 && metric == kIP) return static_cast<int>(FN<__nv_bfloat16, kIP>(__VA_ARGS__));      \
    if (dtype == 1 && metric == kCos) return static_cast<int>(FN<__nv_bfloat16, kCos>(__VA_ARGS__));    \
    return static_cast<int>(cudaErrorInvalidValue);                                   \
  } while (0)

extern "C" {

// K1. q [nq, d] f32; x [n, d] (dtype), n a multiple of 256; bias, colscale
// [n] f32 (colscale read for cosine only); part_* [splits, nq, 3, 256]
// scratch; out_* [nq, 3, 256]. Returns cudaGetLastError().
int vi_bin_candidates(const void* q, const void* x, const void* bias, const void* colscale,
                      int nq, int n, int d, int dtype, int metric, int splits,
                      int tiles_per_split, void* part_dist, void* part_row, void* out_dist,
                      void* out_row, void* stream) {
  VI_DISPATCH(launch_bin, static_cast<const float*>(q), x,
              static_cast<const float*>(bias), static_cast<const float*>(colscale), nq, n, d,
              splits, tiles_per_split, static_cast<float*>(part_dist),
              static_cast<int*>(part_row), static_cast<float*>(out_dist),
              static_cast<int*>(out_row), static_cast<cudaStream_t>(stream));
}

// K2. thresh [nq] f32; lt, le [nq] int32, zeroed by the caller.
int vi_count_below(const void* q, const void* x, const void* bias, const void* colscale,
                   const void* thresh, int nq, int n, int d, int dtype, int metric, int splits,
                   int tiles_per_split, void* lt, void* le, void* stream) {
  VI_DISPATCH(launch_count, static_cast<const float*>(q), x,
              static_cast<const float*>(bias), static_cast<const float*>(colscale),
              static_cast<const float*>(thresh), nq, n, d, splits, tiles_per_split,
              static_cast<int*>(lt), static_cast<int*>(le), static_cast<cudaStream_t>(stream));
}

const char* vi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
