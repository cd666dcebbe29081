// Fused flat-scan kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/scan_fused.py and of the round-5 pass-1 A/B kernel
// in scripts/ab_flat_tree.py:
//
//   K1  bin_candidates       replaces scan_fused.py:_bin_candidates
//                            (body _candidates_kernel, _dist_tile, _reduce_tile)
//   K2  count_below          replaces scan_fused.py:_count_below
//                            (body _count_kernel)
//   K11 bin_candidates_tree  replaces ab_flat_tree.py:_bin_candidates_param
//                            (body _kernel_param, mode "tree")
//
// All scan a corpus x [n, d] (f32 or bf16, n a multiple of 256) against a
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
// order, so each CTA keeps exact per-class top-3 over its corpus split in
// registers and a second small launch merges the splits. Per-class top-3 is
// decomposable (the top-3 of a union is the top-3 of the parts' top-3s) and
// the lexicographic insert is order-free, so the result does not depend on
// the split count. It keeps at least what the TPU kernel keeps (which drops
// a tile's third-smallest). The insert and the merge launch live in
// class_top3.cuh, shared with K8.
//
// K11 is K1 with the "tree" reduction of the A/B: per query, class and block
// of `block_tiles` 256-row tiles, one candidate, the block's smallest
// distance and its first row, folded into the same 3 tiers. Splits start on
// block boundaries.
//
// K2 counts, per query, rows with dist < tau and dist <= tau. Each CTA counts
// its split and adds into per-query int32 counters with atomicAdd: integer
// atomics are order-free, so the counts are deterministic.
//
// Two designs.
//
// bf16 corpora (the flat main path) run on the tensor cores, as the TPU
// kernel runs on its matrix unit: one mma.sync.m16n8k16 (bf16 x bf16, f32
// accumulate) per 16 corpus rows x 8 queries x 16 k. A warp owns 16 classes
// (the mma's M) x 16 queries (two n8 tiles); a CTA holds up to 8 warps, split
// into query warps (the batch's queries, up to 128) and class warps. The
// thread that holds a fragment position owns the same (query, class) pairs
// in every 256-row tile, so the per-class tiers live in its registers: 8
// pairs a thread. Queries are staged once per CTA in shared memory as bf16;
// the CTA's slice of each corpus tile (16 rows per class warp) streams
// through two shared-memory stages of several tiles each (about 128 rows,
// one barrier a stage: the per-stage overhead, not memory or mma latency,
// bounded the first version) by cp.async (16-byte copies where the rows are
// 16-byte aligned, plain loads otherwise: a d=100 bf16 row is 200 bytes),
// K past d zero-filled. Rows are padded by 8 bf16 in shared memory so
// ldmatrix reads are free of bank conflicts. The grid is one wave of
// (query block, class group, split) CTAs with the query blocks innermost,
// so the CTAs that read one corpus slice run together and find it in L2,
// and each CTA's run of tiles is long, which keeps per-class inserts rare.
//
// mma.sync rather than wgmma: the per-class epilogue needs each thread to
// own a fixed set of (query, class) pairs, which the m16n8 accumulator
// layout gives directly; at B=256 the product is not what bounds the pass
// (PERF.md), and a first kernel is right and simple first.
//
// The exactness proof (scan_fused.py:17-21) needs K2 to recompute, bit for
// bit, the float K1 produced for every (query, row). Tensor-core sums are
// deterministic but not IEEE-sequential, so K1, K2 and K11 share one
// __device__ tile function (mma_dist_tile) with the same instruction, the
// same k order, the same query block and the same row-to-fragment mapping
// for a given (nq, d), and the same rounded epilogue (kernel_space). Against
// the plain versions (cuBLAS f32 GEMM) they agree bit for bit only where
// every partial sum is exact (integer-valued data); elsewhere each distance
// is within 2 d 2^-23 sum_k |q_k x_k| (times 2 for L2, times cs for cosine)
// of the exact one.
//
// f32 corpora stay on the CUDA cores in full f32 (row_distances): each
// query's dot product is one __fmaf_rn chain over k = 0..d-1 in order, equal
// bit for bit to the plain versions. The same FMA kernel instantiated for
// bf16 is the earlier design of K1, kept for the A/B (vi_bin_candidates with
// qwarps = 0) and never reached from an index.
//
// Bounds on the H100 at B=256, d=128, n=2^20: 68.7 GFLOP a pass, 0.069 ms on
// the tensor cores at 989 TFLOP/s, against 0.080 ms for reading the corpus
// once at 3.35 TB/s: both passes are bound by the corpus bytes (the FMA
// design took 5.95 ms, 17% of the 67 TFLOP/s f32 pipe). At small B they are
// bound by the bytes as well. All are built by one nvcc call without
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "class_top3.cuh"

namespace {

constexpr int kTB = 8;  // queries per CTA of the FMA design
constexpr int kL2 = 0, kIP = 1, kCos = 2;

// ---------------------------------------------------------------------------
// the FMA design (f32 corpora; bf16 only through the A/B entry)
// ---------------------------------------------------------------------------

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

// Kernel space from the dot product: the rounded epilogue of every kernel
// here (explicit intrinsics, which nvcc cannot contract).
template <int METRIC>
__device__ __forceinline__ float kernel_space(float acc, float bias, float colscale) {
  if (METRIC == kL2) return __fsub_rn(bias, __fmul_rn(2.0f, acc));
  if (METRIC == kIP) return __fsub_rn(bias, acc);
  return __fsub_rn(bias, __fmul_rn(acc, colscale));
}

// Kernel-space distances of one corpus row to the CTA's 8 queries. The one
// distance function of the FMA kernels (see the file comment).
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
  for (int b = 0; b < kTB; ++b) dist[b] = kernel_space<METRIC>(acc[b], bias, colscale);
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

// K1 scan, FMA design: grid (query block, split), kClasses threads (thread t
// owns class t: a 256-row tile holds one row of each class). Writes per-split
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

// K2, FMA design: grid (query block, split), kClasses threads. lt/le must be
// zeroed.
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

// ---------------------------------------------------------------------------
// the tensor-core design (bf16 corpora)
// ---------------------------------------------------------------------------

constexpr int kMmaTile = 16;   // corpus rows (classes) and queries of one warp's tile
constexpr int kMmaWarps = 8;   // most warps a CTA holds
constexpr int kMmaPad = 8;     // bf16 elements of padding after each row in shared memory
constexpr int kStages = 2;     // ring stages: one computed while the next loads
constexpr int kModeTop3 = 0, kModeTree = 1, kModeCount = 2;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row-major) x b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The one distance tile of K1, K2 and K11: the dot products of the warp's 16
// corpus rows (shared memory, row stride kp) with its 16 queries (shared
// memory [query][k], row stride kp), k-steps 0..nks-1 in order from 0.
// a_addr / b_addr are this lane's ldmatrix addresses at k = 0. acc[nt][i]
// holds (row g + 8 (i / 2), query 8 nt + 2 t + i % 2), with g = lane / 4 and
// t = lane % 4 (the m16n8 accumulator layout).
__device__ __forceinline__ void mma_dist_tile(uint32_t a_addr, uint32_t b_addr, int nks,
                                              float (&acc)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
  }
#pragma unroll 4
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a_addr + ks * 2 * kMmaTile, a);
    ldmatrix_x4(b_addr + ks * 2 * kMmaTile, b);
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
}

// The rows of one ring stage: `tiles` consecutive 256-row tiles from tile0
// (fewer at the end of a split), each the class group's `grows` rows c0..,
// stored [tile][row][k] with row stride kp (k < d only), then their bias
// [tile][row] and, for cosine, colscale (f32). 16-byte cp.async where rows
// are 16-byte aligned, plain loads otherwise (visible after the next
// __syncthreads). A thread's first 16-byte chunk is (sr0, ck0) and it steps
// by (dsr, dck) chunks, so the loop needs no division.
struct StageLoader {
  int sr0, ck0, dsr, dck;  // first (row, chunk) of this thread, and its step
};

template <int METRIC>
__device__ __forceinline__ void load_stage(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ colscale, int tile0,
                                           int tiles, int c0, int grows, int lg_grows, int d,
                                           int kp, int tps, bool vec, StageLoader ld) {
  const int rows = tiles << lg_grows;
  float* sb = reinterpret_cast<float*>(dst + tps * grows * kp);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int row = (tile0 + (i >> lg_grows)) * kClasses + c0 + (i & (grows - 1));
    cp_async4(sb + i, bias + row);
    if (METRIC == kCos) cp_async4(sb + tps * grows + i, colscale + row);
  }
  if (vec) {
    const int chunks = d / 8;
    int sr = ld.sr0, ck = ld.ck0;
    for (; sr < rows; sr += ld.dsr) {
      const int row = (tile0 + (sr >> lg_grows)) * kClasses + c0 + (sr & (grows - 1));
      cp_async16(dst + sr * kp + ck * 8, x + static_cast<size_t>(row) * d + ck * 8);
      ck += ld.dck;
      if (ck >= chunks) {
        ck -= chunks;
        ++sr;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int sr = i / d;
      const int k = i - sr * d;
      const int row = (tile0 + (sr >> lg_grows)) * kClasses + c0 + (sr & (grows - 1));
      dst[sr * kp + k] = x[static_cast<size_t>(row) * d + k];
    }
  }
}

// K1 (MODE kModeTop3), K11 (kModeTree) and K2 (kModeCount) on the tensor
// cores. Grid (query block of 16 qwarps, class group of 16 cwarps, split),
// 32 qwarps cwarps threads; warp w is query warp w % qwarps of class warp
// w / qwarps. Shared memory: the query block, then kStages ring stages of
// `tps` tiles' class-group rows (load_stage), all with row stride
// kp = roundup(d, 16) + 8. One barrier per stage, not per tile.
// K1/K11 write per-split tiers to part_[dist|row] [split][query][tier][class];
// K2 adds into lt/le, which must be zeroed.
template <int METRIC, int MODE>
__global__ void __launch_bounds__(32 * kMmaWarps, 2)
    scan_mma_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ bias, const float* __restrict__ colscale,
                    const float* __restrict__ thresh, int nq, int d, int qwarps, int cwarps,
                    int tps, int ntiles, int tiles_per_split, int block_tiles, bool vec,
                    float* __restrict__ part_dist, int* __restrict__ part_row,
                    int* __restrict__ lt, int* __restrict__ le) {
  extern __shared__ float4 smem[];
  const int nks = (d + kMmaTile - 1) / kMmaTile;
  const int kp = nks * kMmaTile + kMmaPad;
  const int qrows = kMmaTile * qwarps;  // queries of the CTA
  const int grows = kMmaTile * cwarps;  // classes of the CTA: its rows of each tile
  const int lg_grows = __ffs(grows) - 1;
  const int stage_elems = tps * grows * (kp + 4);  // rows, then 2 f32 a row (bias, colscale)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + qrows * kp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qwarp = warp % qwarps;
  const int cwarp = warp / qwarps;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * qrows;
  const int c0 = blockIdx.y * grows;
  const int split = blockIdx.z;

  // zero everything (k past d, queries past nq stay 0), then stage the
  // queries rounded to bf16
  {
    uint32_t* w = reinterpret_cast<uint32_t*>(smem);
    const int words = (qrows * kp + kStages * stage_elems) / 2;
    for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0u;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < qrows * d; i += blockDim.x) {
    const int b = i / d;
    const int k = i - b * d;
    if (q0 + b < nq) qs[b * kp + k] = __float2bfloat16_rn(q[static_cast<size_t>(q0 + b) * d + k]);
  }

  // this lane's ldmatrix addresses: A rows (lane & 15) at k (lane >> 4) * 8;
  // B queries (lane & 7) + 8 (lane >> 4) at k ((lane >> 3) & 1) * 8
  const uint32_t b_addr = smem_addr(
      qs + (qwarp * kMmaTile + (lane & 7) + ((lane >> 4) << 3)) * kp + ((lane >> 3) & 1) * 8);
  const uint32_t a_off =
      static_cast<uint32_t>(((cwarp * kMmaTile + (lane & 15)) * kp + (lane >> 4) * 8) * 2);
  const uint32_t ring_addr = smem_addr(ring);
  const int cls = c0 + cwarp * kMmaTile + g;  // classes cls and cls + 8

  // per pair p = nt * 4 + i: query 8 nt + 2 t + i % 2, class cls + 8 (i / 2)
  constexpr int kPairs = 8;
  constexpr int kSlots = (MODE == kModeCount) ? 1 : kPairs;  // registers only where used
  float td[kSlots][kTiers];
  int ti[kSlots][kTiers];
  float m1[MODE == kModeTree ? kPairs : 1];
  int r1[MODE == kModeTree ? kPairs : 1];
  float tau[4];
  int n_lt[4], n_le[4];
  if constexpr (MODE != kModeCount) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
#pragma unroll
      for (int k = 0; k < kTiers; ++k) {
        td[p][k] = INFINITY;
        ti[p][k] = kInvalidId;
      }
    }
  }
  if constexpr (MODE == kModeTree) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      m1[p] = INFINITY;
      r1[p] = kInvalidId;
    }
  }
  if constexpr (MODE == kModeCount) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int qi = q0 + qwarp * kMmaTile + 8 * (s >> 1) + 2 * t + (s & 1);
      tau[s] = qi < nq ? thresh[qi] : -INFINITY;
      n_lt[s] = 0;
      n_le[s] = 0;
    }
  }

  const int t0 = split * tiles_per_split;
  const int ntl = min(t0 + tiles_per_split, ntiles) - t0;
  const int ngroups = (ntl + tps - 1) / tps;  // ring stages this split fills
  StageLoader ld{0, 0, 1, 0};
  if (vec) {
    const int chunks = d / 8;
    ld = {static_cast<int>(threadIdx.x) / chunks, static_cast<int>(threadIdx.x) % chunks,
          static_cast<int>(blockDim.x) / chunks, static_cast<int>(blockDim.x) % chunks};
  }
  auto load = [&](int group, int slot) {
    load_stage<METRIC>(ring + slot * stage_elems, x, bias, colscale, t0 + group * tps,
                       min(tps, ntl - group * tps), c0, grows, lg_grows, d, kp, tps, vec, ld);
  };
  load(0, 0);
  cp_async_commit();
  for (int it = 0; it < ngroups; ++it) {
    const int slot = it & 1;  // ring stage of group `it`
    cp_async_wait_all();
    __syncthreads();  // group `it` has landed; the other stage (group it - 1) is free again
    if (it + 1 < ngroups) load(it + 1, slot ^ 1);
    cp_async_commit();

    const uint32_t stage_addr = ring_addr + static_cast<uint32_t>(slot * stage_elems * 2);
    const float* sb =
        reinterpret_cast<const float*>(ring + slot * stage_elems + tps * grows * kp) +
        cwarp * kMmaTile + g;  // this lane's bias at tile 0 of the stage
    const int tiles = min(tps, ntl - it * tps);
    for (int r = 0; r < tiles; ++r) {
      const int tile = t0 + it * tps + r;
      const int row = tile * kClasses + cls;
      const float b_lo = sb[r * grows], b_hi = sb[r * grows + 8];
      const float s_lo = METRIC == kCos ? sb[(tps + r) * grows] : 0.0f;
      const float s_hi = METRIC == kCos ? sb[(tps + r) * grows + 8] : 0.0f;
      float acc[2][4];
      mma_dist_tile(stage_addr + static_cast<uint32_t>(r * grows * kp * 2) + a_off, b_addr, nks,
                    acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hi = i >> 1;
          const float v = kernel_space<METRIC>(acc[nt][i], hi ? b_hi : b_lo, hi ? s_hi : s_lo);
          const int p = nt * 4 + i;
          if constexpr (MODE == kModeTop3) {
            // rows only grow along the loop, so (v, row) beats the third
            // tier iff v is smaller: the usual case is one compare and a reject
            if (v < td[p][2]) insert3(td[p], ti[p], v, row + 8 * hi);
          } else if constexpr (MODE == kModeTree) {
            // strict <: the first row of the block wins a tie (the JAX eq-scan)
            if (v < m1[p]) {
              m1[p] = v;
              r1[p] = row + 8 * hi;
            }
          } else {
            const int s = nt * 2 + (i & 1);
            n_lt[s] += v < tau[s];
            n_le[s] += v <= tau[s];
          }
        }
      }
      if constexpr (MODE == kModeTree) {
        if ((tile + 1) % block_tiles == 0) {
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            insert3(td[p], ti[p], m1[p], r1[p]);
            m1[p] = INFINITY;
            r1[p] = kInvalidId;
          }
        }
      }
    }
  }

  if constexpr (MODE == kModeCount) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      int a = n_lt[s], e = n_le[s];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes of one query column
        a += __shfl_xor_sync(0xffffffffu, a, off);
        e += __shfl_xor_sync(0xffffffffu, e, off);
      }
      const int qi = q0 + qwarp * kMmaTile + 8 * (s >> 1) + 2 * t + (s & 1);
      if (g == 0 && qi < nq) {
        if (a) atomicAdd(lt + qi, a);
        if (e) atomicAdd(le + qi, e);
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int qi = q0 + qwarp * kMmaTile + 8 * (p >> 2) + 2 * t + (p & 1);
      if (qi >= nq) continue;
      const int c = cls + 8 * ((p >> 1) & 1);
#pragma unroll
      for (int k = 0; k < kTiers; ++k) {
        const size_t o = ((static_cast<size_t>(split) * nq + qi) * kTiers + k) * kClasses + c;
        part_dist[o] = td[p][k];
        part_row[o] = ti[p][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool aligned16(const void* x, int d) {
  return d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The tensor-core geometry the wrapper chose (kernels/scan_fused._mma_config).
struct MmaGrid {
  int qwarps, cwarps, tiles_per_stage, splits, tiles_per_split, block_tiles;
};

template <int METRIC, int MODE>
cudaError_t launch_mma(const float* q, const void* x, const float* bias, const float* cs,
                       const float* thresh, int nq, int n, int d, MmaGrid g,
                       float* part_dist, int* part_row, int* lt, int* le,
                       cudaStream_t stream) {
  if (g.qwarps < 1 || g.cwarps < 1 || g.qwarps * g.cwarps > kMmaWarps ||
      kClasses % (kMmaTile * g.cwarps) != 0 || g.tiles_per_stage < 1) {
    return cudaErrorInvalidValue;
  }
  const int kp = (d + kMmaTile - 1) / kMmaTile * kMmaTile + kMmaPad;
  const size_t smem = static_cast<size_t>(2) * kMmaTile *
                      (kp * g.qwarps + kStages * g.tiles_per_stage * g.cwarps * (kp + 4));
  auto kernel = scan_mma_kernel<METRIC, MODE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int qrows = kMmaTile * g.qwarps;
  const dim3 grid((nq + qrows - 1) / qrows, kClasses / (kMmaTile * g.cwarps), g.splits);
  kernel<<<grid, 32 * g.qwarps * g.cwarps, smem, stream>>>(
      q, static_cast<const __nv_bfloat16*>(x), bias, cs, thresh, nq, d, g.qwarps, g.cwarps,
      g.tiles_per_stage, n / kClasses, g.tiles_per_split, g.block_tiles, aligned16(x, d),
      part_dist, part_row, lt, le);
  return cudaGetLastError();
}

template <typename T, int METRIC>
cudaError_t launch_fma_bin(const float* q, const void* x, const float* bias, const float* cs,
                           int nq, int n, int d, int splits, int tiles_per_split,
                           float* part_dist, int* part_row, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTB) * d * sizeof(float);
  cudaError_t err = allow_smem(bin_candidates_kernel<T, METRIC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTB - 1) / kTB, splits);
  bin_candidates_kernel<T, METRIC><<<grid, kClasses, smem, stream>>>(
      q, static_cast<const T*>(x), bias, cs, nq, d, n / kClasses, tiles_per_split,
      aligned16(x, d), part_dist, part_row);
  return cudaGetLastError();
}

template <typename T, int METRIC>
cudaError_t launch_fma_count(const float* q, const void* x, const float* bias, const float* cs,
                             const float* thresh, int nq, int n, int d, int splits,
                             int tiles_per_split, int* lt, int* le, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTB) * d * sizeof(float);
  cudaError_t err = allow_smem(count_below_kernel<T, METRIC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kTB - 1) / kTB, splits);
  count_below_kernel<T, METRIC><<<grid, kClasses, smem, stream>>>(
      q, static_cast<const T*>(x), bias, cs, thresh, nq, d, n / kClasses, tiles_per_split,
      aligned16(x, d), lt, le);
  return cudaGetLastError();
}

// The tensor-core kernel of MODE for a runtime metric (0 = L2, 1 = IP,
// 2 = cosine; K11 takes L2 and IP only).
template <int MODE>
cudaError_t launch_mma_metric(int metric, const float* q, const void* x, const float* bias,
                              const float* cs, const float* thresh, int nq, int n, int d,
                              MmaGrid g, float* part_dist, int* part_row, int* lt, int* le,
                              cudaStream_t stream) {
  if (metric == kL2) {
    return launch_mma<kL2, MODE>(q, x, bias, cs, thresh, nq, n, d, g, part_dist, part_row, lt,
                                 le, stream);
  }
  if (metric == kIP) {
    return launch_mma<kIP, MODE>(q, x, bias, cs, thresh, nq, n, d, g, part_dist, part_row, lt,
                                 le, stream);
  }
  if constexpr (MODE != kModeTree) {
    if (metric == kCos) {
      return launch_mma<kCos, MODE>(q, x, bias, cs, thresh, nq, n, d, g, part_dist, part_row,
                                    lt, le, stream);
    }
  }
  return cudaErrorInvalidValue;
}

// The CUDA-core kernel F<T, METRIC> for a runtime dtype (0 = f32, 1 = bf16)
// and metric.
#define VI_FMA_DISPATCH(FN, ...)                                                              \
  do {                                                                                        \
    if (dtype == 0 && metric == kL2) return static_cast<int>(FN<float, kL2>(__VA_ARGS__));     \
    if (dtype == 0 && metric == kIP) return static_cast<int>(FN<float, kIP>(__VA_ARGS__));     \
    if (dtype == 0 && metric == kCos) return static_cast<int>(FN<float, kCos>(__VA_ARGS__));   \
    if (dtype == 1 && metric == kL2)                                                          \
      return static_cast<int>(FN<__nv_bfloat16, kL2>(__VA_ARGS__));                           \
    if (dtype == 1 && metric == kIP)                                                          \
      return static_cast<int>(FN<__nv_bfloat16, kIP>(__VA_ARGS__));                           \
    if (dtype == 1 && metric == kCos)                                                         \
      return static_cast<int>(FN<__nv_bfloat16, kCos>(__VA_ARGS__));                          \
    return static_cast<int>(cudaErrorInvalidValue);                                           \
  } while (0)

int scan_bin(const float* q, const void* x, const float* bias, const float* cs, int nq, int n,
             int d, int dtype, int metric, MmaGrid g, float* part_dist, int* part_row,
             cudaStream_t stream) {
  if (g.qwarps == 0) {
    VI_FMA_DISPATCH(launch_fma_bin, q, x, bias, cs, nq, n, d, g.splits, g.tiles_per_split,
                    part_dist, part_row, stream);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma_metric<kModeTop3>(
      metric, q, x, bias, cs, nullptr, nq, n, d, g, part_dist, part_row, nullptr, nullptr,
      stream));
}

int scan_count(const float* q, const void* x, const float* bias, const float* cs,
               const float* thresh, int nq, int n, int d, int dtype, int metric, MmaGrid g,
               int* lt, int* le, cudaStream_t stream) {
  if (g.qwarps == 0) {
    VI_FMA_DISPATCH(launch_fma_count, q, x, bias, cs, thresh, nq, n, d, g.splits,
                    g.tiles_per_split, lt, le, stream);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma_metric<kModeCount>(
      metric, q, x, bias, cs, thresh, nq, n, d, g, nullptr, nullptr, lt, le, stream));
}

}  // namespace

extern "C" {

// K1. q [nq, d] f32; x [n, d] (dtype), n a multiple of 256; bias, colscale
// [n] f32 (colscale read for cosine only); part_* [splits, nq, 3, 256]
// scratch; out_* [nq, 3, 256]. qwarps = 0 runs the FMA design (f32, or bf16
// for the A/B); otherwise the tensor-core design (bf16) with qwarps x cwarps
// warps and ring stages of tiles_per_stage tiles. Returns cudaGetLastError().
int vi_bin_candidates(const void* q, const void* x, const void* bias, const void* colscale,
                      int nq, int n, int d, int dtype, int metric, int qwarps, int cwarps,
                      int tiles_per_stage, int splits, int tiles_per_split, void* part_dist,
                      void* part_row, void* out_dist, void* out_row, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pd = static_cast<float*>(part_dist);
  int* pr = static_cast<int*>(part_row);
  const int err = scan_bin(static_cast<const float*>(q), x, static_cast<const float*>(bias),
                           static_cast<const float*>(colscale), nq, n, d, dtype, metric,
                           MmaGrid{qwarps, cwarps, tiles_per_stage, splits, tiles_per_split, 1},
                           pd, pr, s);
  if (err != 0) return err;
  return static_cast<int>(launch_merge_splits(pd, pr, nq, splits, static_cast<float*>(out_dist),
                                              static_cast<int*>(out_row), s));
}

// K11. As K1 (bf16, L2 or IP, tensor-core design), keeping per block of
// block_tiles 256-row tiles one candidate per (query, class); tiles_per_split
// a multiple of block_tiles, n a multiple of 256 block_tiles.
int vi_bin_candidates_tree(const void* q, const void* x, const void* bias, int nq, int n, int d,
                           int metric, int qwarps, int cwarps, int tiles_per_stage, int splits,
                           int tiles_per_split, int block_tiles, void* part_dist,
                           void* part_row, void* out_dist, void* out_row, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_tiles < 1 || tiles_per_split % block_tiles != 0 || (n / kClasses) % block_tiles != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* pd = static_cast<float*>(part_dist);
  int* pr = static_cast<int*>(part_row);
  const cudaError_t err = launch_mma_metric<kModeTree>(
      metric, static_cast<const float*>(q), x, static_cast<const float*>(bias), nullptr, nullptr,
      nq, n, d, MmaGrid{qwarps, cwarps, tiles_per_stage, splits, tiles_per_split, block_tiles},
      pd, pr, nullptr, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_splits(pd, pr, nq, splits, static_cast<float*>(out_dist),
                                              static_cast<int*>(out_row), s));
}

// K2. thresh [nq] f32; lt, le [nq] int32, zeroed by the caller; the design
// arguments as K1's (and equal to them, for the bit identity).
int vi_count_below(const void* q, const void* x, const void* bias, const void* colscale,
                   const void* thresh, int nq, int n, int d, int dtype, int metric, int qwarps,
                   int cwarps, int tiles_per_stage, int splits, int tiles_per_split, void* lt,
                   void* le, void* stream) {
  return scan_count(static_cast<const float*>(q), x, static_cast<const float*>(bias),
                    static_cast<const float*>(colscale), static_cast<const float*>(thresh), nq,
                    n, d, dtype, metric,
                    MmaGrid{qwarps, cwarps, tiles_per_stage, splits, tiles_per_split, 1},
                    static_cast<int*>(lt), static_cast<int*>(le),
                    static_cast<cudaStream_t>(stream));
}

const char* vi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
