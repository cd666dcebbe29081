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
// bf16 corpora of any width (the flat main path) run on Hopper's
// asynchronous tensor cores, as the TPU kernel runs on its matrix unit
// (scan_wgmma_kernel, sized by kernels/scan_fused.wgmma_plan):
//
//   - wgmma.mma_async m64n32k16 (bf16 x bf16, f32 accumulate) with the
//     queries as A (64 a unit: M) and 32 classes of a 256-row tile as B
//     (N), so each thread owns the same 16 (query, class) pairs of a unit
//     in every tile. N = 32 issues at about 90% of the tensor cores' rate,
//     N = 16 at about half (scripts/wgmma_rates.cu).
//   - a CTA: two consumer warpgroups of U units each (unit i of the CTA:
//     query tile i % qt against class block i / qt) and one producer
//     warpgroup, so a CTA covers 64 qt queries x 64 U / qt classes. Up to
//     64 queries (qt = 1) and up to 128 (qt = 2) one unit a warpgroup (the
//     narrow tile): the batch in one CTA, the corpus read once a pass. Past
//     one query tile (B > 64) K1 and K2 take the wide tile: at d <= 128 four
//     query tiles, two units a warpgroup (qt = 4, U = 2: 256 queries x 32
//     classes, A from registers), so a batch up to 256 crosses the corpus
//     once; past d = 128 two query tiles beside four ring tiles a chunked
//     stage (below): on streamed rows (d > 448), and in the band
//     128 < d <= 448 on rows TMA can address (d % 8 == 0), where it ran
//     0.67-0.84x K1's and 0.45-0.99x K2's time with the narrow tile's
//     resident block at d = 136-448, B = 128, 200 and 256 (H100 80GB HBM3,
//     700 W; kernels/scan_fused.band_chunked). The band's other rows, which
//     the producer copies, keep that resident block: fed by two stages of
//     copies the chunked tile took 1.19-1.36x its time. A resident block of
//     256 queries there leaves K1's tiers no room. Past a CTA's queries the
//     query blocks that read one corpus slice run together and share it in
//     L2. Clusters of them sharing each load by TMA multicast were slower:
//     2 CTAs on the narrow rows, whose query block sits in registers or
//     shared memory, and 2 or 4 on the chunked wide rows, 1.17-1.41x at
//     d = 768-8,192, B = 128 and 256 (H100 80GB HBM3, 700 W), where each
//     CTA still takes in every byte of its stages. So was a 256-query
//     chunked tile for K2 (four query tiles, two units a warpgroup beside
//     four ring tiles of one slab: 128 accumulators a consumer thread),
//     which counted the same bit for bit but spilled 88-200 bytes a thread
//     and took 1.4-2.2x the wide tile's time at d = 136-8,192, B = 200 and
//     256 (PERF.md §6). Rows past the batch take nothing; a warp (or half a
//     warp's rows) with none skips its epilogues.
//   - where K1's tiers live: in registers (6 a pair, beside a distance) at
//     one unit and at most two accumulators a warpgroup (the narrow tile:
//     B <= 64, B <= 128 at d <= 128, and the band's copied rows); in the
//     wide tile in shared memory, 16 bytes a pair ([pair][word][thread]:
//     the 3 distances and the 3 rows as their tiles' 10-bit indices in the
//     split, so a split holds at most 1,023 tiles), with one register a
//     pair, its third tier's distance. Rows grow along a thread's loop, so a distance
//     enters the tiers iff it is below that threshold: one compare a pair
//     on the common path, and the hits go to a per-thread queue in shared
//     memory ([entry][thread], 8 bytes: the distance and its tile and
//     pair), folded by push3 in the order they came once a thread's queue
//     might not take the next 8 (a vote of the warpgroup, whose next
//     products wait for its slowest warp, so its warps fold together), with
//     no product in flight, each entry's tiers read before the last one's
//     are written back; the fold reloads the thresholds (stale between
//     folds: they only let in hits that the fold drops). On the main path
//     (d = 128, B=256) the folds are the largest part of K1's epilogue
//     (scripts/ab_scan_trees_torch.py). K11 keeps its tiers, touched once a
//     block, in shared memory, so its A fragments fit in registers beside
//     its block minima.
//   - the producer's one thread brings each stage's corpus rows in by TMA
//     (a 3-D tensor map [tile][class][k], 64-value k slabs of 128 bytes in
//     the 128-byte swizzle wgmma reads, bias and colscale by 2-D maps) into
//     a ring of up to 8 stages with full and empty mbarriers; rows TMA
//     cannot address (not 16-byte aligned: a d = 100 bf16 row is 200 bytes)
//     are copied by the producer's 128 threads into the same layout
//     (cp.async of 8 or 4 bytes as the width and alignment allow, two
//     stages in flight). The query block is rounded to bf16 once a CTA by
//     the consumers: held in registers as A fragments up to d = 128,
//     written into shared memory for the whole pass past that, and for rows
//     too wide for that (d > 448), or past one query tile from d = 129, its
//     k chunk rides in each stage (TMA from a padded copy the wrapper makes)
//     beside the k chunk of TPS ring tiles' rows, each multiplied into its
//     own accumulator: two at one query tile (B <= 64; K11: one), four at
//     two (the wide tile: 128 queries x 128 rows a stage, up to 3 slabs for
//     K2, 2 for K1, whose tiers and queue take 80 KiB, the fewest slabs that
//     keep a row's k chunks; eight tiles' 128 accumulators spilled: ptxas
//     holds a consumer thread near the launch bound's 168 registers, its
//     SASS naming at most R171-R187 where a kernel needed more, despite
//     setmaxnreg's 224, scripts/ab_scan_wgmma_torch.py). The
//     wide tile reads each stage's query chunk into A fragments once for its
//     four tiles: with A and B both from shared memory an m64n32k16 reads 3
//     KiB, and the chunked passes' stage times followed those reads and
//     TMA's writes, not the corpus's bytes (PERF.md §6); its
//     stages always hold all their slabs (TMA's zero fill past the row), so
//     a stage's k16 steps are a constant. Every
//     CTA brings its query rows from L2 with every stage, so a stage of one
//     tile moved as many query bytes as corpus bytes, and the pass ran at
//     the SMs' L2 bandwidth (24-26 bytes a clock an SM at B=256,
//     d = 3,072-8,192, scripts/ab_scan_wgmma_torch.py), not the corpus's
//     HBM bound. The placements and tiles give the same floats bit for bit,
//     as the accumulators keep each dot product one chain in k order.
//   - a consumer warpgroup issues one tile's products (every unit's),
//     waits, and runs the mode's epilogue from the accumulator registers
//     (the other warpgroup's products run meanwhile): K1's inserts (push3:
//     selects only, so the pairs interleave) or its compare and queue, K11's
//     running block minimum, or K2's counts behind one test of each query's
//     smallest distance against tau. Issuing the next tile before the
//     epilogue made ptxas serialize the products (it injects waits on the
//     epilogue's divergent paths). setmaxnreg gives the consumers 224
//     registers of the launch bound's 168 a thread, the producer 56.
//   - the grid is one wave of (query block, class group, split) CTAs, one
//     CTA an SM, with the query blocks innermost, so the CTAs that read one
//     corpus slice run together and find it in L2. K11's splits start on
//     block boundaries.
//
// The first tensor-core design (scan_mma_kernel: mma.sync m16n8k16 with
// ldmatrix from a 2-stage cp.async ring, up to 128 queries a CTA) stays for
// timing only (the _mma_v1 / tree_v1 wrappers).
//
// The exactness proof (scan_fused.py:17-21) needs K2 to recompute, bit for
// bit, the float K1 produced for every (query, row). Tensor-core sums are
// deterministic but not IEEE-sequential, so K1, K2 and K11 share one
// __device__ tile function (wg_dist_tile; mma_dist_tile in the first
// design) with the same instruction, the same k order and the same
// row-to-fragment mapping (a query's row of the unit's M, a class's column
// of its N), and the same rounded epilogue (kernel_space): every wgmma plan
// (query placement, query tiles, units, tiles and slabs a stage) gives each
// (query, row) the same float, which the cuda tests hold bit for bit, so
// K1 and K2 may each take their own stages and slabs, and K11 the narrow
// tile beside K1's wide one. Against
// the plain versions (cuBLAS f32 GEMM) they agree bit for bit only where
// every partial sum is exact (integer-valued data); elsewhere each distance
// is within 2 d 2^-23 sum_k |q_k x_k| (times 2 for L2, times cs for cosine)
// of the exact one.
//
// f32 corpora of any width stay on the CUDA cores in full f32: each
// (query, row) dot product is one __fmaf_rn chain over k = 0..d-1 in order
// whatever the geometry, so K1 and K2 may each take their own. The floats
// equal the first FMA design's bit for bit (where it fits: d <= 7,264), and
// the plain versions' where cuBLAS's f32 product sums each output in k
// order too (the main paths' shapes; not at one query, a short last row
// chunk or d = 768, where it sums otherwise). The same kernels instantiated
// for bf16 took bf16 rows past d = 2,400 before the tensor cores took every
// width; they stay for timing (kernels/scan_fused.bin_candidates_fma /
// count_below_fma). This design (scan_fma_kernel, the second) is a
// register-tiled f32 product over staged corpus tiles:
//
//   - a CTA of 256 threads takes a block of qb queries and a class group of
//     g rows of every 256-row tile of its split (qb g = 256 TM); a warp's
//     lanes are 8 classes x 4 queries. A thread owns one class and TN
//     queries, and its TM x TN micro-tile of accumulators is its class's row
//     in each of a stage's TM consecutive tiles against those queries. Each
//     k step reads TM corpus and TN query values from shared memory as
//     16-byte vectors (8 bytes for bf16 rows) that the warp's other lanes
//     read too (broadcast), and feeds each corpus value to TN FMAs and each
//     query value to TM.
//   - the stage's rows (TM tiles' class-group rows, whole or a k chunk of kc
//     values when d > kc) stream through a ring of 2-4 shared-memory stages
//     by 16-byte cp.async (plain loads where rows are not 16-byte aligned),
//     one barrier a stage, the next stages' copies in flight while the
//     current one is multiplied. The query block is staged once (d <= kc) or
//     rides in each stage with its k chunk; the accumulators stay in
//     registers across k chunks, so each stays one chain in k order.
//   - K1 keeps its exact per-class top-3 in registers: a thread owns the
//     same TN (query, class) pairs in every tile, and folds the rows of its
//     class in tile order, so rows grow along the loop. Taking the
//     micro-tile's rows from TM tiles of one class, not TM classes of one
//     tile, keeps those pairs to TN (6 TN tier registers) beside an 8 x 8
//     tile: with TM classes a thread would own TM TN pairs, 384 tier
//     registers at 8 x 8, so K1 would be held to 4 x 4 (its first version,
//     36% of the f32 pipe against K2's 55% at 8 x 8; ab_scan_fma_torch.py).
//     A distance tile folded from shared memory in a second thread mapping
//     would need the same registers or 24 bytes of shared memory a pair.
//   - batches of up to 16 queries take a 4 x 4 tile (a byte-bound pass,
//     every query in one block), larger ones 8 x 8. The grid is (query
//     block, class group, split) with the query blocks innermost, so the
//     CTAs that read one corpus slice run together and find it in L2;
//     kernels/scan_fused.fma_plan sizes it (one wave) and the stages, from
//     scripts/ab_scan_fma_torch.py's sweep.
//
// q reaches the FMA kernels already rounded to the storage dtype (the
// wrapper rounds it, as the plain versions do). The first FMA design (one
// thread a row, 8 queries a CTA, __ldg loads with no stage in flight, 8 FMAs
// a corpus value and two shared-memory loads of q every 8 FMAs:
// bin_candidates_kernel, count_below_kernel) stays for timing only (the _v1
// wrappers); it rounds q itself.
//
// Bounds on the H100 at B=256, d=128, n=2^20: 68.7 GFLOP a pass, 0.069 ms on
// the tensor cores at 989 TFLOP/s, against 0.080 ms for reading a bf16
// corpus once at 3.35 TB/s: on bf16 both passes are bound by the corpus
// bytes. On an f32 corpus the CUDA cores' 67 TFLOP/s bound the pass at
// 1.026 ms (the first FMA design took 8.2-8.3 ms there, PERF.md); at small B
// the corpus bytes bound it (0.160 ms at B=8). All are built by one nvcc
// call without --use_fast_math, and no TF32 or 3xTF32 product: either would
// change the floats.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "class_top3.cuh"

namespace {

constexpr int kTB = 8;  // queries per CTA of the first FMA design
constexpr int kL2 = 0, kIP = 1, kCos = 2;

// ---------------------------------------------------------------------------
// the first FMA design (timing only: the _v1 wrappers)
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
  // L2: one FMA equals bias - fl(2 acc) rounded, since 2 acc is exact
  if (METRIC == kL2) return __fmaf_rn(-2.0f, acc, bias);
  if (METRIC == kIP) return __fsub_rn(bias, acc);
  return __fsub_rn(bias, __fmul_rn(acc, colscale));
}

// Kernel-space distances of one corpus row to the CTA's 8 queries. The one
// distance function of the first FMA design's kernels.
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

// K1, first FMA design: grid (query block, split), kClasses threads (thread t
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

// K2, first FMA design: grid (query block, split), kClasses threads. lt/le must be
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
// the wgmma design (bf16 corpora of any width: K1, K2 and K11)
// ---------------------------------------------------------------------------

constexpr int kWgConsumers = 2;                    // consumer warpgroups a CTA
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgThreads = kWgConsumerThreads + 128;  // + one producer warpgroup
// setmaxnreg: the producer warpgroup gives up registers the consumers take
// (the launch bound alone allows 168 a thread: 65,536 / 384)
constexpr int kConsumerRegs = 224, kProducerRegs = 56;
constexpr int kWgN = 32;         // classes of a unit: the wgmma's N
constexpr int kWgPairs = kWgN / 2;  // (query, class) pairs a consumer thread owns in a unit
constexpr int kSlab = 64;        // bf16 k values of one 128-byte swizzled row
constexpr int kWgMaxStages = 8;
constexpr int kWgHeader = 2048;  // barriers, then slack to align the regions to 1024 bytes
// K1's tiers out of registers (the wide tile): a tier's row is kept as its
// tile's index in the split, 10 bits, kWgNoTile for none, so a split holds
// at most kWgMaxSplitTiles tiles
constexpr int kWgTileBits = 10, kWgNoTile = (1 << kWgTileBits) - 1;
constexpr int kWgMaxSplitTiles = kWgNoTile;

// The geometry kernels/scan_fused.wgmma_plan chose.
struct WgPlan {
  int qt;       // 64-query tiles a CTA (1, 2, or 4 with units = 2)
  int units;    // 64-query tiles a consumer warpgroup multiplies (1 or 2)
  int a_regs;   // k16 steps of the query block held in registers (4 or 8); 0: shared memory
  int chunked;  // 1: the query block's k chunk rides in each stage (wide rows)
  int cs;       // 64-value k slabs a stage holds (every slab unless chunked)
  int tps;      // 256-row tiles a stage holds (chunked: multiplied at once)
  int stages;   // ring stages, 2..kWgMaxStages
  int queue;    // K1's hit queue (entries a thread) where its tiers are out of registers
  int splits, tiles_per_split, block_tiles;
};

// K1 keeps its tiers out of registers (the wide tile: 32 pairs a thread, or
// chunked stages of more than 2 tiles' accumulators)
__host__ __device__ constexpr bool wg_queued(int units, int tps) { return units > 1 || tps > 2; }

// K11's tiers in shared memory: a distance and a row in each of 3 tiers of
// each consumer thread's 16 pairs, [pair][tier][thread] (a thread reads and
// writes only its own column)
constexpr int kWgTierBytes = 2 * kWgPairs * kTiers * kWgConsumerThreads * 4;
// K1's tiers out of registers: 4 words a pair, [pair][word][thread]: the 3
// tiers' distances and their 3 tile indices packed kWgTileBits apart
constexpr int kWgTierWords = 4;
// one queued hit: the distance and (tile index << 5 | pair)
constexpr int kWgQueueEntry = 8;

// Shared memory of a wgmma CTA past the header: the query block once (its
// k slabs [slab][query][64], when it is neither in registers nor chunked),
// K11's or K1's tiers (`tiers`), K1's hit queue ([entry][thread]), then
// `stages` ring stages of: cs slabs of the tps tiles' class-block rows
// ([slab][tile][class][64]), the query block's cs slabs when chunked, and
// the tiles' bias and colscale [tile][class] (f32). Rows are 128 bytes,
// swizzled as TMA's 128-byte swizzle writes them; every part starts on 1024
// bytes (bias and colscale on 128).
struct WgLayout {
  int g, qb, slabs, q_res, tiers, queue, x_slab, x_bytes, q_bytes, b_off, c_off, stage_bytes,
      total;
};

__host__ __device__ inline WgLayout wg_layout(int d, const WgPlan& p, int mode) {
  WgLayout l;
  const bool queued = mode == kModeTop3 && wg_queued(p.units, p.chunked ? p.tps : 1);
  l.g = p.units * kWgConsumers * kWgN / p.qt;
  l.qb = 64 * p.qt;
  l.slabs = (d + kSlab - 1) / kSlab;
  l.q_res = (p.a_regs == 0 && !p.chunked) ? l.slabs * l.qb * 128 : 0;
  l.tiers = mode == kModeTree ? kWgTierBytes
            : queued ? kWgTierWords * 4 * kWgPairs * p.units * kWgConsumerThreads : 0;
  l.queue = queued ? p.queue * kWgQueueEntry * kWgConsumerThreads : 0;
  l.x_slab = p.tps * l.g * 128;
  l.x_bytes = p.cs * l.x_slab;
  l.q_bytes = p.chunked ? p.cs * l.qb * 128 : 0;
  const int bb = (p.tps * l.g * 4 + 127) & ~127;
  l.b_off = l.x_bytes + l.q_bytes;
  l.c_off = l.b_off + bb;
  l.stage_bytes = (l.c_off + bb + 1023) & ~1023;
  l.total = kWgHeader + l.q_res + l.tiers + l.queue + p.stages * l.stage_bytes;
  return l;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes (a lost arrival) traps after about 2^35 clocks, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                      uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                      int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma's shared-memory operand: K-major rows of 128 bytes in 128-byte
// swizzle, 8-row atoms 1024 bytes apart, from `addr` (a k16 step inside a
// slab adds 32 bytes to the start, as the swizzle is a function of the
// address).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (64 queries x 32 classes, f32) (+)= a (64 x 16 k, shared memory) b^T.
// N = 32 reaches about 90% of the tensor cores' rate from registers (16 runs
// at about half; scripts/ab_flat_tree_torch.py --wgmma-rates).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with a from registers (the m16n8k16 A fragment of each warp's 16 rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product's fence and wait.
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// K1's insert in a thread's own stream, where each row lies above every row
// the tiers hold: (v, row) goes in iff v < td[2] (so v is finite), below
// every tier it is smaller than. Equal to insert3 there, with no row
// compares and no branch (selects only: the wgmma pipeline may be in
// flight, and a branch would make ptxas serialize it).
__device__ __forceinline__ void push3(float (&td)[kTiers], int (&ti)[kTiers], float v, int row) {
  const bool c2 = v < td[2], c1 = v < td[1], c0 = v < td[0];  // c0 => c1 => c2
  td[2] = c1 ? td[1] : (c2 ? v : td[2]);
  ti[2] = c1 ? ti[1] : (c2 ? row : ti[2]);
  td[1] = c0 ? td[0] : (c1 ? v : td[1]);
  ti[1] = c0 ? ti[0] : (c1 ? row : ti[1]);
  td[0] = c0 ? v : td[0];
  ti[0] = c0 ? row : ti[0];
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The one distance tile of K1, K2 and K11 on this design: the warpgroup's
// 64 queries against its 32 classes of one ring tile over the stage's k
// steps (k order from the stage's first slab; accumulate = 0 starts the
// sums), issued and not waited for. a: the query block's A fragments
// (KS > 0: the whole row's, or a chunked stage's KS k16 steps) or its query
// rows' first slab in shared memory (qa, slab stride qstride); xb: the
// class rows' first slab in the stage (slab stride xstride).
template <int KS, bool STAGE_A = false>
__device__ __forceinline__ void wg_dist_tile(float (&acc)[16], const uint32_t (&a)[KS > 0 ? KS : 1][4],
                                             uint32_t qa, int qstride, uint32_t xb, int xstride,
                                             int nks, int accumulate) {
  if constexpr (KS > 0) {
    // A of the whole row starts each sum; a chunked stage's (STAGE_A) goes on
    // with `accumulate`
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wgmma_rs(acc, a[ks], sw128_desc(xb + (ks >> 2) * xstride + (ks & 3) * 32),
               (STAGE_A && accumulate) || ks > 0);
    }
  } else {
    for (int ks = 0; ks < nks; ++ks) {
      wgmma_ss(acc, sw128_desc(qa + (ks >> 2) * qstride + (ks & 3) * 32),
               sw128_desc(xb + (ks >> 2) * xstride + (ks & 3) * 32), accumulate | (ks > 0));
    }
  }
}

// K1 (MODE kModeTop3), K11 (kModeTree) and K2 (kModeCount) on Hopper's
// asynchronous tensor cores. Grid (query block of 64 qt, class group of
// g = 64 U / qt, split), kWgThreads threads: warpgroups 0 and 1 consume,
// warpgroup 2 produces (setmaxnreg moves its registers to the consumers).
// Consumer warpgroup w multiplies U units, units U w .. U w + U - 1 of the
// CTA; unit i is 64-query tile i % qt against 32-class block i / qt, one
// m64n32k16 accumulator (warp i of the warpgroup: queries 16 i + lane / 4
// (+ 8), classes 2 (lane % 4) + 8 j (+ 1)), the same pairs in every tile.
// K1 keeps its tiers in registers where a thread's 16 pairs beside one or
// two accumulators leave room (U = 1, TPS <= 2); past that (the wide tile:
// U = 2, or TPS > 2) one register a pair, its third tier's distance, which
// every distance is tested against, and the tiers in shared memory behind a
// queue of the hits (wg_queued). K11's tiers are in shared memory. The
// producer fills a ring of stages through TMA (one thread; the corpus by a
// 3-D tensor map [tile][class][k], bias and colscale by 2-D maps), or,
// where rows are not 16-byte aligned, copies the corpus rows itself into the
// same swizzled layout (all 128 threads, one stage's copies in flight behind
// the next's) before its first thread issues the rest; full barriers
// complete on the copies' bytes, every consumer warp arrives on a stage's
// empty barrier once done with it. The query block, rounded to bf16 by the
// consumers, sits in registers as A fragments (KS > 0), in shared memory for
// the whole pass, or (chunked: a wrapper-made padded copy) rides in each
// stage with its k chunk beside the k chunk of TPS ring tiles' class rows,
// so each query chunk brought from L2 serves TPS tiles; a warpgroup holds
// TPS accumulators across the chunks (TPS = 2 or 4 for wide rows; 1 where
// the block is resident or in registers, whose stages' tiles run one after
// another). K1/K11 write per-split tiers to part_[dist|row]
// [split][query][tier][class]; K2 adds into lt/le, which must be zeroed.
template <int METRIC, int MODE, int KS, int TPS, int U>
__global__ void __launch_bounds__(kWgThreads, 1)
    scan_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap cmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const float* __restrict__ q, const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ thresh, int nq, int d, int ntiles, WgPlan p,
                      int tma_x, float* __restrict__ part_dist, int* __restrict__ part_row,
                      int* __restrict__ lt, int* __restrict__ le) {
  static_assert(U == 1 || (TPS == 1 && KS > 0), "two units a warpgroup take A from registers");
  // a chunked stage's query chunk read into registers (the wide tile): its
  // stages always hold KS / 4 slabs, TMA's zero fill past the row
  constexpr bool kStageA = KS > 0 && TPS > 1;
  extern __shared__ float4 smem_v4[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_v4);
  const WgLayout L = wg_layout(d, p, MODE);
  const uint32_t raw = smem_addr(smem);
  const uint32_t full0 = raw, empty0 = raw + 8 * kWgMaxStages;
  const uint32_t qres = (raw + 256 + 1023) & ~1023u;
  const uint32_t ring = qres + L.q_res + L.tiers + L.queue;
  const int q0 = blockIdx.x * L.qb;
  const int c0 = blockIdx.y * L.g;
  const int split = blockIdx.z;
  const int t0 = split * p.tiles_per_split;
  const int ntl = min(t0 + p.tiles_per_split, ntiles) - t0;
  const int nk = p.chunked ? (L.slabs + p.cs - 1) / p.cs : 1;  // ring stages a tile group takes
  const int total = (ntl + p.tps - 1) / p.tps * nk;
  const int wg = threadIdx.x >> 7;  // consumer warpgroup 0 or 1; 2: the producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWgConsumerThreads / 32);  // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - kWgConsumerThreads;
    const uint32_t tx_fixed = p.tps * L.g * 4 * (METRIC == kCos ? 2 : 1);
    if (tma_x && pt != 0) return;
    // stage s: ring slot, first slab and slabs of its k chunk, first tile
    auto stage_of = [&](int s, int& slot, int& sl0, int& nsl, int& tile0) {
      const int grp = s / nk;
      slot = s % p.stages;
      sl0 = (s - grp * nk) * p.cs;
      nsl = kStageA ? p.cs : min(p.cs, L.slabs - sl0);
      tile0 = t0 + grp * p.tps;
    };
    // the TMA copies of stage s onto its full barrier: the corpus rows (when
    // TMA-fed), the query block's k chunk (chunked), bias and colscale
    auto issue = [&](int s) {
      int slot, sl0, nsl, tile0;
      stage_of(s, slot, sl0, nsl, tile0);
      const uint32_t st = ring + slot * L.stage_bytes;
      const uint32_t fb = full0 + 8 * slot;
      mbar_expect(fb, tx_fixed + nsl * (tma_x ? L.x_slab : 0) + (p.chunked ? nsl * L.qb * 128 : 0));
      if (tma_x) {
        for (int j = 0; j < nsl; ++j) {
          tma3d(st + j * L.x_slab, &xmap, (sl0 + j) * kSlab, c0, tile0, fb);
        }
      }
      if (p.chunked) {
        for (int j = 0; j < nsl; ++j) {
          tma2d(st + L.x_bytes + j * L.qb * 128, &qmap, (sl0 + j) * kSlab, q0, fb);
        }
      }
      tma2d(st + L.b_off, &bmap, c0, tile0, fb);
      if (METRIC == kCos) tma2d(st + L.c_off, &cmap, c0, tile0, fb);
    };
    if (tma_x) {
      for (int s = 0; s < total; ++s) {
        if (s >= p.stages) mbar_wait(empty0 + 8 * (s % p.stages), ((s / p.stages) - 1) & 1);
        issue(s);
      }
      return;
    }
    // Rows TMA cannot address: the producer's 128 threads copy them, V
    // values (2 V bytes) a copy, by cp.async where V > 1 (zero-filled past
    // d), with two stages in flight: element (row r of the stage, k) of slab
    // j lands at byte r * 128 + (((k % 64) / 8) ^ (r % 8)) * 16 + (k % 8) * 2
    // (a slot holds other k chunks' slabs before, so k past d is written 0).
    auto copy = [&](int s, auto vec) {
      constexpr int V = decltype(vec)::value;
      int slot, sl0, nsl, tile0;
      stage_of(s, slot, sl0, nsl, tile0);
      const uint32_t st = ring + slot * L.stage_bytes;
      const int k0 = sl0 * kSlab;
      const int per = nsl * kSlab / V;  // copies a row
      for (int i = pt; i < p.tps * L.g * per; i += 128) {
        const int r = i / per;
        const int k = V * (i - r * per);
        const int tile = tile0 + r / L.g;
        if (tile >= ntiles) continue;
        const bool in = k0 + k < d;  // d % V == 0: all V values or none
        const __nv_bfloat16* src =
            x + (in ? (static_cast<size_t>(tile) * kClasses + c0 + r % L.g) * d + k0 + k : 0);
        const uint32_t dst =
            st + (k >> 6) * L.x_slab + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
        if constexpr (V > 1) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                       "n"(2 * V), "r"(in ? 2 * V : 0)
                       : "memory");
        } else {
          const unsigned short v = in ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
        }
      }
    };
    const uintptr_t base = reinterpret_cast<uintptr_t>(x);
    const int vec = d % 4 == 0 && base % 8 == 0 ? 4 : (d % 2 == 0 && base % 4 == 0 ? 2 : 1);
    for (int s = 0; s <= total; ++s) {
      if (s < total) {
        if (s >= p.stages) mbar_wait(empty0 + 8 * (s % p.stages), ((s / p.stages) - 1) & 1);
        if (vec == 4) {
          copy(s, std::integral_constant<int, 4>{});
        } else if (vec == 2) {
          copy(s, std::integral_constant<int, 2>{});
        } else {
          copy(s, std::integral_constant<int, 1>{});
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // stage s - 1's copies landed
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      if (s > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
        if (pt == 0) issue(s - 1);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3;  // warp of the warpgroup: its 16 query rows of a unit
  const int gq = lane >> 2, tq = lane & 3;
  // Unit u's query tile mq[u] and class block cb[u]; the thread's queries
  // in it are qrow[u] and qrow[u] + kHi. A warp whose 16 rows of a unit hold
  // no query skips that unit's epilogues, and one whose second 8 hold none
  // skips that half (a small batch: spreading it over the 4 warps measured
  // slower).
  constexpr int kHi = 8;
  constexpr int kP = kWgPairs * U;  // (query, class) pairs a thread owns
  int mq[U], cb[U], qrow[U];
  bool live[U], hi_live[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int unit = wg * U + u;
    mq[u] = unit % p.qt;
    cb[u] = unit / p.qt;
    const int r0 = q0 + mq[u] * 64 + 16 * wq;
    qrow[u] = r0 + gq;
    live[u] = r0 < nq;
    hi_live[u] = r0 + kHi < nq;
  }
  // q rounded to bf16 once a CTA: two consecutive k of query `row` as the
  // packed pair wgmma reads (0 past nq and d)
  auto qpair = [&](int row, int k) -> uint32_t {
    const float* qr = q + static_cast<size_t>(row) * d;
    const float lo = row < nq && k < d ? qr[k] : 0.0f;
    const float hi = row < nq && k + 1 < d ? qr[k + 1] : 0.0f;
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  };

  // each unit's A fragments (KS > 0): queries qrow (+ 8), k pairs 2 tq (+ 8)
  // of each k16 step, once (or each stage's: kStageA, below); or (resident
  // in shared memory) the block's k slabs written by the consumers in the
  // 128-byte swizzle, once
  uint32_t a[KS > 0 ? U : 1][KS > 0 ? KS : 1][4];
  if constexpr (kStageA) {
  } else if constexpr (KS > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[u][ks][0] = qpair(qrow[u], 16 * ks + 2 * tq);
        a[u][ks][1] = qpair(qrow[u] + kHi, 16 * ks + 2 * tq);
        a[u][ks][2] = qpair(qrow[u], 16 * ks + 8 + 2 * tq);
        a[u][ks][3] = qpair(qrow[u] + kHi, 16 * ks + 8 + 2 * tq);
      }
    }
  } else if (!p.chunked) {
    const int pairs = L.slabs * kSlab / 2;  // k pairs a row
    for (int i = threadIdx.x; i < L.qb * pairs; i += 128 * kWgConsumers) {
      const int r = i / pairs;
      const int k = 2 * (i - r * pairs);
      const uint32_t off = (k >> 6) * L.qb * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) +
                           ((k & 7) << 1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(qres + off), "r"(qpair(q0 + r, k))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumerThreads) : "memory");
  }

  // per pair pp = 16 u + 4 j + e of unit u: query qrow[u] + 8 (e / 2),
  // class 32 cb[u] + 8 j + 2 tq + e % 2
  constexpr bool kQueued = MODE == kModeTop3 && wg_queued(U, TPS);
  constexpr bool kRegTiers = MODE == kModeTop3 && !kQueued;
  // K1's tiers in registers (U = 1); K11's, touched once a block, in shared
  // memory (tier k of pair pp at [pp][k][thread]), so that its query
  // block's A fragments fit in registers beside its block minima
  float td[kRegTiers ? kWgPairs : 1][kTiers];
  int ti[kRegTiers ? kWgPairs : 1][kTiers];
  uint8_t* const tier_base = smem + (qres - raw) + L.q_res;
  float* const tds = reinterpret_cast<float*>(tier_base) + threadIdx.x;
  int* const tis = reinterpret_cast<int*>(tds) + kWgPairs * kTiers * kWgConsumerThreads;
  auto tier = [](auto* t, int pp, int k) -> auto& { return t[(pp * kTiers + k) * kWgConsumerThreads]; };
  // K1's wide tile: the tiers of pair k in words [k][w][thread] (w = 0..2
  // the distances, 3 their tiles' indices in the split), the third tier's
  // distance also in thr[k], and the thread's queued hits, entry i at
  // queue[i][thread]
  constexpr uint32_t kNoTiles = kWgNoTile | (kWgNoTile << kWgTileBits) | (kWgNoTile << (2 * kWgTileBits));
  uint32_t* const tw = reinterpret_cast<uint32_t*>(tier_base) + threadIdx.x;
  auto word = [&](int k, int w) -> uint32_t& { return tw[(k * kWgTierWords + w) * kWgConsumerThreads]; };
  uint2* const queue = reinterpret_cast<uint2*>(tier_base + L.tiers) + threadIdx.x;
  const uint32_t queue_at = smem_addr(queue);
  float thr[kQueued ? kP : 1];
  int queued = 0;
  float m1[MODE == kModeTree ? kWgPairs : 1];
  int r1[MODE == kModeTree ? kWgPairs : 1];  // the block minima's rows
  float tau[2 * U];
  int n_lt[2 * U], n_le[2 * U];
  if constexpr (MODE != kModeCount) {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int u = k / kWgPairs, pp = k % kWgPairs;
      // a query past nq takes nothing: no distance beats a tier
      const float init = qrow[u] + kHi * ((pp >> 1) & 1) >= nq ? -INFINITY : INFINITY;
      if constexpr (kQueued) {
#pragma unroll
        for (int w = 0; w < kTiers; ++w) word(k, w) = __float_as_uint(init);
        word(k, kTiers) = kNoTiles;
        thr[k] = init;
      } else {
#pragma unroll
        for (int t = 0; t < kTiers; ++t) {
          if constexpr (kRegTiers) {
            td[pp][t] = init;
            ti[pp][t] = kInvalidId;
          } else {
            tier(tds, pp, t) = init;
            tier(tis, pp, t) = kInvalidId;
          }
        }
      }
    }
  }
  if constexpr (MODE == kModeTree) {
#pragma unroll
    for (int pp = 0; pp < kWgPairs; ++pp) m1[pp] = INFINITY;
  }
  if constexpr (MODE == kModeCount) {
#pragma unroll
    for (int i = 0; i < 2 * U; ++i) {
      const int qi = qrow[i >> 1] + kHi * (i & 1);
      tau[i] = qi < nq ? thresh[qi] : -INFINITY;
      n_lt[i] = 0;
      n_le[i] = 0;
    }
  }

  // K1's wide tile: fold the thread's queued hits into its tiers in the
  // order they came (each pair's rows grow along it, so push3's strict <
  // keeps (dist, row) order; a hit a stale threshold let in changes
  // nothing), then reload its thresholds. Off the products' path: each
  // warpgroup runs it with none of its products in flight, all its warps
  // at once (wg_any), since its next products wait for the slowest warp.
  // The fold is pipelined: the next entry and its pair's tiers are read
  // before this entry's tiers are written back (another pair's do not
  // alias them; the same pair's take this entry's result instead).
  auto flush = [&]() {
    const int n = queued;
    uint2 e = queue[0];
    int k = e.y & 31;
    uint32_t w[kWgTierWords];
#pragma unroll
    for (int t = 0; t < kWgTierWords; ++t) w[t] = word(k, t);
    for (int i = 0; i < n; ++i) {
      const uint2 en = queue[min(i + 1, n - 1) * kWgConsumerThreads];
      const int kn = en.y & 31;
      const float v = __uint_as_float(e.x);
      const uint32_t j = e.y >> 5;
      const float d0 = __uint_as_float(w[0]), d1 = __uint_as_float(w[1]);
      const float d2 = __uint_as_float(w[2]);
      const uint32_t i0 = w[3] & kWgNoTile, i1 = (w[3] >> kWgTileBits) & kWgNoTile;
      const uint32_t i2 = w[3] >> (2 * kWgTileBits);
      const bool c2 = v < d2, c1 = v < d1, c0 = v < d0;  // c0 => c1 => c2
      uint32_t nw[kWgTierWords];
      nw[0] = __float_as_uint(c0 ? v : d0);
      nw[1] = __float_as_uint(c0 ? d0 : (c1 ? v : d1));
      nw[2] = __float_as_uint(c1 ? d1 : (c2 ? v : d2));
      nw[3] = (c0 ? j : i0) | ((c0 ? i0 : (c1 ? j : i1)) << kWgTileBits) |
              ((c1 ? i1 : (c2 ? j : i2)) << (2 * kWgTileBits));
      uint32_t next[kWgTierWords];
#pragma unroll
      for (int t = 0; t < kWgTierWords; ++t) next[t] = word(kn, t);
#pragma unroll
      for (int t = 0; t < kWgTierWords; ++t) word(k, t) = nw[t];
#pragma unroll
      for (int t = 0; t < kWgTierWords; ++t) w[t] = kn == k ? nw[t] : next[t];
      e = en;
      k = kn;
    }
    queued = 0;
#pragma unroll
    for (int k = 0; k < kP; ++k) thr[k] = __uint_as_float(word(k, 2));
  };
  // any thread of this consumer warpgroup (its 128 threads on named barrier
  // 3 + wg; every one of them takes each vote)
  auto wg_any = [&](bool pred) -> bool {
    uint32_t any;
    asm volatile(
        "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
        "bar.red.or.pred p, %2, 128, q;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(any)
        : "r"(static_cast<uint32_t>(pred)), "r"(3 + wg)
        : "memory");
    return any != 0;
  };

  // The mode's step for unit u's accumulator of split tile j (ring tile r
  // of the stage at st), with no product in flight (the epilogue is on each
  // warpgroup's critical path): K1's inserts without a branch (tiers in
  // registers) or one compare a pair and the hits queued (the wide tile),
  // K11's running block minimum, or K2's counts behind one test of each
  // query's smallest distance against tau (at or below it: about k rows of
  // the corpus a query). Rows past nq take nothing (their tiers are -inf,
  // their tau -inf); the second half of rows is skipped when it holds no
  // query.
  auto epilogue = [&](const float (&acc)[16], int u, int j, int r, uint32_t st) {
    const int tile = t0 + j;
    if (!kQueued && !live[u]) {
      if constexpr (MODE == kModeTree) {
        if ((tile + 1) % p.block_tiles == 0) {
#pragma unroll
          for (int pp = 0; pp < kWgPairs; ++pp) m1[pp] = INFINITY;
        }
      }
      return;
    }
    const int cls = cb[u] * kWgN + 2 * tq;  // the thread's classes cls + 8 jj (+ 1) of the group
    const float* sb = reinterpret_cast<const float*>(smem + (st - raw) + L.b_off) + r * L.g + cls;
    const float* sc = reinterpret_cast<const float*>(smem + (st - raw) + L.c_off) + r * L.g + cls;
    const int row = tile * kClasses + c0 + cls;
    // pair pp = 4 jj + e: query qrow + 8 (e / 2), class cls + 8 jj + e % 2
    float b[kWgPairs / 2], c[kWgPairs / 2];
#pragma unroll
    for (int jj = 0; jj < kWgN / 8; ++jj) {
      const float2 bb = *reinterpret_cast<const float2*>(sb + 8 * jj);
      const float2 cc = METRIC == kCos ? *reinterpret_cast<const float2*>(sc + 8 * jj)
                                       : make_float2(0.f, 0.f);
      b[2 * jj] = bb.x;
      b[2 * jj + 1] = bb.y;
      c[2 * jj] = cc.x;
      c[2 * jj + 1] = cc.y;
    }
    auto dist = [&](int pp) {
      return kernel_space<METRIC>(acc[pp], b[2 * (pp >> 2) + (pp & 1)], c[2 * (pp >> 2) + (pp & 1)]);
    };
    // the pairs of `halves` halves of rows (query qrow + 8 h: pairs
    // 4 jj + 2 h (+ 1)), with no branch inside, so they interleave
    auto each_pair = [&](auto halves, auto&& f) {
#pragma unroll
      for (int h = 0; h < decltype(halves)::value; ++h) {
#pragma unroll
        for (int jj = 0; jj < kWgN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) f(4 * jj + 2 * h + e, row + 8 * jj + e);
        }
      }
    };
    auto live_pairs = [&](auto&& f) {
      if (hi_live[u]) {
        each_pair(std::integral_constant<int, 2>{}, f);
      } else {
        each_pair(std::integral_constant<int, 1>{}, f);
      }
    };
    if constexpr (kQueued) {
      // rows only grow along the loop, so (v, row) enters the tiers iff v
      // is below the third tier's distance: one compare a pair, the few
      // hits queued; a half's 8 pairs at a time (a half with no query
      // queues nothing but still votes), and the queue folded once a
      // thread's next 8 might not fit
      auto half = [&](int h, bool queries) {
        if (queries) {
#pragma unroll
          for (int jj = 0; jj < kWgN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int pp = 4 * jj + 2 * h + e;
              const int k = kWgPairs * u + pp;
              const float v = dist(pp);
              const uint32_t hit = v < thr[k];
              // a predicated store, no branch
              asm volatile(
                  "{\n.reg .pred p;\nsetp.ne.u32 p, %0, 0;\n"
                  "@p st.shared.v2.u32 [%1], {%2, %3};\n}\n" ::"r"(hit),
                  "r"(queue_at + queued * (kWgConsumerThreads * kWgQueueEntry)),
                  "r"(__float_as_uint(v)), "r"((j << 5) | k)
                  : "memory");
              queued += hit;
            }
          }
        }
        if (wg_any(queued > p.queue - kWgPairs / 2)) flush();
      };
      half(0, live[u]);
      half(1, hi_live[u]);
    } else if constexpr (kRegTiers) {
      // rows only grow along the loop, so (v, row) beats a tier iff v is
      // smaller; the distances first, then push3, selects only (a branch a
      // pair measured slower). Cosine keeps no distance array (its colscale
      // takes those registers).
      if constexpr (METRIC == kCos) {
        live_pairs([&](int pp, int rw) { push3(td[pp], ti[pp], dist(pp), rw); });
      } else {
        float v[kWgPairs];
        live_pairs([&](int pp, int) { v[pp] = dist(pp); });
        live_pairs([&](int pp, int rw) { push3(td[pp], ti[pp], v[pp], rw); });
      }
    } else if constexpr (MODE == kModeTree) {
#pragma unroll
      for (int pp = 0; pp < kWgPairs; ++pp) {
        // strict <: the first row of the block wins a tie (the JAX eq-scan)
        const float v = dist(pp);
        const bool lower = v < m1[pp];
        m1[pp] = lower ? v : m1[pp];
        r1[pp] = lower ? row + 8 * (pp >> 2) + (pp & 1) : r1[pp];
      }
      if ((tile + 1) % p.block_tiles == 0) {
#pragma unroll
        for (int pp = 0; pp < kWgPairs; ++pp) {
          // rows of a later block lie above the tiers'
          if (m1[pp] < tier(tds, pp, 2)) {
            float d3[kTiers];
            int i3[kTiers];
#pragma unroll
            for (int k = 0; k < kTiers; ++k) {
              d3[k] = tier(tds, pp, k);
              i3[k] = tier(tis, pp, k);
            }
            push3(d3, i3, m1[pp], r1[pp]);
#pragma unroll
            for (int k = 0; k < kTiers; ++k) {
              tier(tds, pp, k) = d3[k];
              tier(tis, pp, k) = i3[k];
            }
          }
          m1[pp] = INFINITY;
        }
      }
    } else {
      float v[kWgPairs];
#pragma unroll
      for (int pp = 0; pp < kWgPairs; ++pp) v[pp] = INFINITY;  // a skipped half counts nothing
      live_pairs([&](int pp, int) { v[pp] = dist(pp); });
      float lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lo[h] = fminf(fminf(fminf(v[2 * h], v[2 * h + 1]), fminf(v[4 + 2 * h], v[5 + 2 * h])),
                      fminf(fminf(v[8 + 2 * h], v[9 + 2 * h]), fminf(v[12 + 2 * h], v[13 + 2 * h])));
      }
      if (lo[0] <= tau[2 * u] || lo[1] <= tau[2 * u + 1]) {
#pragma unroll
        for (int pp = 0; pp < kWgPairs; ++pp) {
          const int h = 2 * u + ((pp >> 1) & 1);
          n_lt[h] += v[pp] < tau[h];  // tau is -inf past nq
          n_le[h] += v[pp] <= tau[h];
        }
      }
    }
  };

  // One tile's products at a time (every unit's), waited for before its
  // epilogues; the other consumer warpgroup's products run meanwhile.
  // (Issuing the next tile before this one's epilogue makes ptxas serialize
  // the products: it injects waits on the pipeline's divergent paths.) With
  // TPS > 1 (chunked) the stage's TPS tiles' products over its k chunk are
  // issued together, each into its own accumulator, and waited for once; a
  // tile past the split's end is multiplied too (its rows are TMA's zero
  // fill or stale) but takes no epilogue.
  float acc[TPS * U][16];
  for (int s = 0; s < total; ++s) {
    const int slot = s % p.stages;
    mbar_wait(full0 + 8 * slot, (s / p.stages) & 1);
    const int grp = s / nk;
    const int kc = s - grp * nk;
    const int nks = 4 * min(p.cs, L.slabs - kc * p.cs);
    const int tiles = min(p.tps, ntl - grp * p.tps);
    const uint32_t st = ring + slot * L.stage_bytes;
    const uint32_t qa = p.chunked ? st + L.x_bytes : qres;
    if constexpr (TPS > 1) {
      if constexpr (kStageA) {
        // the stage's query chunk (rows qrow, qrow + 8 of the unit's tile)
        // into A fragments, read once for its TPS tiles' products
        const int r0 = mq[0] * 64 + 16 * wq + gq;  // the row of the block, in the swizzle
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int r = r0 + 8 * (f & 1);
            const int k = 16 * (ks & 3) + 2 * tq + 8 * (f >> 1);
            const uint32_t addr = qa + (ks >> 2) * L.qb * 128 + r * 128 +
                                  ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
            asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(a[0][ks][f]) : "r"(addr) : "memory");
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TPS; ++r) fence_acc(acc[r]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < TPS; ++r) {
        wg_dist_tile<KS, kStageA>(acc[r], a[0], qa + mq[0] * 64 * 128, L.qb * 128,
                                  st + (r * L.g + cb[0] * kWgN) * 128, L.x_slab, nks, kc > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < TPS; ++r) fence_acc(acc[r]);
      if (kc == nk - 1) {
#pragma unroll
        for (int r = 0; r < TPS; ++r) {
          if (r < tiles) epilogue(acc[r], 0, grp * p.tps + r, r, st);
        }
      }
    } else {
      for (int r = 0; r < tiles; ++r) {
#pragma unroll
        for (int u = 0; u < U; ++u) fence_acc(acc[u]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int u = 0; u < U; ++u) {
          wg_dist_tile<KS>(acc[u], a[KS > 0 ? u : 0], qa + mq[u] * 64 * 128, L.qb * 128,
                           st + (r * L.g + cb[u] * kWgN) * 128, L.x_slab, nks, kc > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wgmma_wait<0>();
#pragma unroll
        for (int u = 0; u < U; ++u) fence_acc(acc[u]);
        if (kc == nk - 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) epilogue(acc[u], u, grp * p.tps + r, r, st);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // the warp is done with the stage
  }

  if constexpr (MODE == kModeCount) {
#pragma unroll
    for (int i = 0; i < 2 * U; ++i) {
      int cl = n_lt[i], ce = n_le[i];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of one query row
        cl += __shfl_xor_sync(0xffffffffu, cl, off);
        ce += __shfl_xor_sync(0xffffffffu, ce, off);
      }
      const int qi = qrow[i >> 1] + kHi * (i & 1);
      if (tq == 0 && qi < nq) {
        if (cl) atomicAdd(lt + qi, cl);
        if (ce) atomicAdd(le + qi, ce);
      }
    }
  } else {
    if constexpr (kQueued) {
      if (wg_any(queued > 0)) flush();
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int u = k / kWgPairs, pp = k % kWgPairs;
      const int qi = qrow[u] + kHi * ((pp & 3) >> 1);
      if (qi >= nq) continue;
      const int c = c0 + cb[u] * kWgN + 2 * tq + 8 * (pp >> 2) + (pp & 1);
#pragma unroll
      for (int t = 0; t < kTiers; ++t) {
        const size_t o = ((static_cast<size_t>(split) * nq + qi) * kTiers + t) * kClasses + c;
        if constexpr (kQueued) {
          const uint32_t i = (word(k, kTiers) >> (kWgTileBits * t)) & kWgNoTile;
          part_dist[o] = __uint_as_float(word(k, t));
          part_row[o] = i == kWgNoTile ? kInvalidId : (t0 + static_cast<int>(i)) * kClasses + c;
        } else if constexpr (kRegTiers) {
          part_dist[o] = td[pp][t];
          part_row[o] = ti[pp][t];
        } else {
          part_dist[o] = tier(tds, pp, t);
          part_row[o] = tier(tis, pp, t);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the FMA design (f32 corpora; bf16 corpora wider than the tensor-core CTA)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaRowLanes = 8;    // a warp's lanes: 8 rows ...
constexpr int kFmaQueryLanes = 4;  // ... x 4 queries
constexpr int kFmaMaxStages = 4;

// The geometry kernels/scan_fused.fma_plan chose.
struct FmaPlan {
  int qb;      // queries a CTA
  int kc;      // k values a stage holds (a multiple of 16); ceil(d / kc) chunks a row
  int stages;  // ring stages, 2..kFmaMaxStages
  int splits, tiles_per_split;
};

// Shared bytes of an FMA CTA whose stages hold tm tiles' g class-group rows:
// the query block once (d <= kc), then `stages` stages of the rows (row
// stride kc + one 16-byte pad, odd in 16-byte units: the 8 rows a warp reads
// at once fall on distinct banks), two f32 a row (bias, colscale) and, when
// d > kc, the query block's k chunk (row stride kc + 4). Every part is a
// multiple of 16 bytes.
template <typename T>
__host__ __device__ inline int fma_smem_bytes(int d, int tm, int g, const FmaPlan& p) {
  const int qbytes = p.qb * (p.kc + 4) * 4;
  const bool chunked = d > p.kc;
  const int rows = tm * g;
  const int stage = rows * (p.kc + 16 / static_cast<int>(sizeof(T))) * static_cast<int>(sizeof(T)) +
                    rows * 8 + (chunked ? qbytes : 0);
  return (chunked ? 0 : qbytes) + p.stages * stage;
}

__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  // every group but the newest stages - 2 has landed
  if (stages >= 4) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (stages == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// A thread's (row, 16-byte chunk) walk over a block of rows x cpr chunks,
// stepped by the CTA's width without a division per copy.
struct ChunkWalk {
  int r, c, dr, dc;
  __device__ __forceinline__ explicit ChunkWalk(int cpr)
      : r(static_cast<int>(threadIdx.x) / cpr), c(static_cast<int>(threadIdx.x) % cpr),
        dr(kFmaThreads / cpr), dc(kFmaThreads % cpr) {}
  __device__ __forceinline__ void next(int cpr) {
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
};

__device__ __forceinline__ float zero_like(const float*) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_like(const __nv_bfloat16*) {
  return __float2bfloat16_rn(0.0f);
}

// 4 consecutive corpus values from shared memory as f32 (bf16 -> f32 is
// exact: the bf16 bits are the high half of the f32).
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// k values [k0, k0 + klen) of the stage's rows: `tiles` 256-row tiles from
// tile0, each the class group's g rows c0.., stored [tile][row][k] with row
// stride kp; with_bias also stages their bias [tile][row] and, for cosine,
// colscale (after `cap` = tm g entries). 16-byte cp.async where rows are
// 16-byte aligned (klen is then a whole number of copies), plain loads
// otherwise, zero-filled up to a multiple of 4 (visible after the next
// __syncthreads).
template <typename T, int METRIC>
__device__ __forceinline__ void fma_load_rows(T* __restrict__ dst, float* __restrict__ sb,
                                              const T* __restrict__ x,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ colscale, int tile0,
                                              int tiles, int c0, int g, int lg_g, int d, int k0,
                                              int klen, int kp, int cap, bool vec, bool with_bias) {
  const int rows = tiles << lg_g;
  if (with_bias) {
    for (int i = threadIdx.x; i < rows; i += kFmaThreads) {
      const int row = (tile0 + (i >> lg_g)) * kClasses + c0 + (i & (g - 1));
      cp_async4(sb + i, bias + row);
      if (METRIC == kCos) cp_async4(sb + cap + i, colscale + row);
    }
  }
  if (vec) {
    constexpr int kEpc = 16 / sizeof(T);
    const int cpr = klen / kEpc;
    for (ChunkWalk w(cpr); w.r < rows; w.next(cpr)) {
      const int row = (tile0 + (w.r >> lg_g)) * kClasses + c0 + (w.r & (g - 1));
      cp_async16(dst + w.r * kp + w.c * kEpc, x + static_cast<size_t>(row) * d + k0 + w.c * kEpc);
    }
  } else {
    const int k4 = (klen + 3) & ~3;
    for (int i = threadIdx.x; i < rows * k4; i += kFmaThreads) {
      const int sr = i / k4;
      const int k = i - sr * k4;
      const int row = (tile0 + (sr >> lg_g)) * kClasses + c0 + (sr & (g - 1));
      dst[sr * kp + k] = k < klen ? x[static_cast<size_t>(row) * d + k0 + k] : zero_like(x);
    }
  }
}

// k values [k0, k0 + klen) of queries q0.. (at most qb, fewer past nq: those
// rows stay zero), stored [query][k] with row stride kq; as fma_load_rows.
__device__ __forceinline__ void fma_load_queries(float* __restrict__ dst,
                                                 const float* __restrict__ q, int q0, int nq,
                                                 int qb, int d, int k0, int klen, int kq,
                                                 bool vec) {
  const int nrows = min(qb, nq - q0);
  if (vec) {
    const int cpr = klen / 4;
    for (ChunkWalk w(cpr); w.r < nrows; w.next(cpr)) {
      cp_async16(dst + w.r * kq + 4 * w.c, q + static_cast<size_t>(q0 + w.r) * d + k0 + 4 * w.c);
    }
  } else {
    const int k4 = (klen + 3) & ~3;
    for (int i = threadIdx.x; i < nrows * k4; i += kFmaThreads) {
      const int r = i / k4;
      const int k = i - r * k4;
      if (k < klen) {
        cp_async4(dst + r * kq + k, q + static_cast<size_t>(q0 + r) * d + k0 + k);
      } else {
        dst[r * kq + k] = 0.0f;
      }
    }
  }
}

// The one product of the FMA design: acc[i][j] += q[j][k] x[i][k] over k
// steps 0..k4n-1 of 4 values, each (i, j) one __fmaf_rn chain in k order.
// xs points at the thread's row 0 (its rows are xstride apart), qs at its
// query 0 (its queries are qstride apart). An 8 x 8 tile has 256 FMAs a step
// to hide the next step's loads; a smaller one unrolls two steps.
template <typename T, int TM, int TN>
__device__ __forceinline__ void fma_chunk(const T* __restrict__ xs, int xstride,
                                          const float* __restrict__ qs, int qstride, int k4n,
                                          float (&acc)[TM][TN]) {
  constexpr int kUnroll = TM * TN >= 64 ? 1 : 2;
#pragma unroll kUnroll
  for (int k4 = 0; k4 < k4n; ++k4) {
    float qv[TN][4], xv[TM][4];
#pragma unroll
    for (int j = 0; j < TN; ++j) lds4(qs + j * qstride + 4 * k4, qv[j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) lds4(xs + i * xstride + 4 * k4, xv[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(qv[j][kk], xv[i][kk], acc[i][j]);
      }
    }
  }
}

// K1 (MODE kModeTop3) and K2 (kModeCount) on the CUDA cores. Grid (query
// block of p.qb, class group of g, split), kFmaThreads threads; warp w is
// query warp w % qwarps of row warp w / qwarps, qwarps = p.qb / (4 TN), and
// g = 8 (8 / qwarps). A ring stage holds TM consecutive tiles' class-group
// rows; thread (row warp rw, query warp qw, lane l) owns class
// c0 + 8 rw + l % 8 and queries q0 + 4 TN qw + l / 8 + 4 j, j < TN: its TM x TN
// micro-tile is its class's row in each of the stage's TM tiles against its
// TN queries. So a K1 thread owns the same TN (query, class) pairs in every
// tile and keeps their per-class top-3 in registers, and the rows it folds
// in grow along the loop. K1 writes per-split tiers to part_[dist|row]
// [split][query][tier][class]; K2 adds into lt/le, which must be zeroed.
template <typename T, int METRIC, int MODE, int TM, int TN>
__global__ void __launch_bounds__(kFmaThreads, 1)
    scan_fma_kernel(const float* __restrict__ q, const T* __restrict__ x,
                    const float* __restrict__ bias, const float* __restrict__ colscale,
                    const float* __restrict__ thresh, int nq, int d, FmaPlan p, int ntiles,
                    bool xvec, bool qvec, float* __restrict__ part_dist,
                    int* __restrict__ part_row, int* __restrict__ lt, int* __restrict__ le) {
  extern __shared__ float4 smem[];
  const int qwarps = p.qb / (kFmaQueryLanes * TN);
  const int g = (kFmaThreads / 32 / qwarps) * kFmaRowLanes;  // classes of the CTA
  const int lg_g = __ffs(g) - 1;
  const int nk = (d + p.kc - 1) / p.kc;  // k chunks a row
  const int kp = p.kc + 16 / static_cast<int>(sizeof(T));
  const int kq = p.kc + 4;
  const int cap = TM * g;  // rows a stage holds
  const int qbytes = p.qb * kq * 4;
  const int xbytes = cap * kp * static_cast<int>(sizeof(T));
  const int stage_bytes = xbytes + cap * 8 + (nk > 1 ? qbytes : 0);
  char* const base = reinterpret_cast<char*>(smem);
  char* const ring = base + (nk > 1 ? 0 : qbytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / qwarps) * kFmaRowLanes + (lane & 7);            // the thread's class
  const int j0 = (warp % qwarps) * (kFmaQueryLanes * TN) + (lane >> 3);  // queries j0 + 4 j
  const int q0 = blockIdx.x * p.qb;
  const int c0 = blockIdx.y * g;
  const int split = blockIdx.z;

  // zero everything: queries past nq stay 0 (their results are dropped)
  {
    const int words = fma_smem_bytes<T>(d, TM, g, p) / 16;
    for (int i = threadIdx.x; i < words; i += kFmaThreads) smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  constexpr bool kTop3 = MODE == kModeTop3;
  float td[kTop3 ? TN : 1][kTiers];
  int ti[kTop3 ? TN : 1][kTiers];
  float tau[kTop3 ? 1 : TN];
  int n_lt[kTop3 ? 1 : TN], n_le[kTop3 ? 1 : TN];
  if constexpr (kTop3) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
#pragma unroll
      for (int t = 0; t < kTiers; ++t) {
        td[j][t] = INFINITY;
        ti[j][t] = kInvalidId;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int qi = q0 + j0 + kFmaQueryLanes * j;
      tau[j] = qi < nq ? thresh[qi] : -INFINITY;
      n_lt[j] = 0;
      n_le[j] = 0;
    }
  }

  const int t0 = split * p.tiles_per_split;
  const int ntl = min(t0 + p.tiles_per_split, ntiles) - t0;
  const int total = (ntl + TM - 1) / TM * nk;  // ring stages this split fills
  auto stage_x = [&](int slot) { return reinterpret_cast<T*>(ring + slot * stage_bytes); };
  auto stage_b = [&](int slot) {
    return reinterpret_cast<float*>(ring + slot * stage_bytes + xbytes);
  };
  auto stage_q = [&](int slot) {
    return reinterpret_cast<float*>(ring + slot * stage_bytes + xbytes + cap * 8);
  };
  // stage s: tiles t0 + TM (s / nk).., k chunk s % nk
  auto load = [&](int s, int slot) {
    const int grp = s / nk;
    const int kc = s - grp * nk;
    const int k0 = kc * p.kc;
    const int klen = min(p.kc, d - k0);
    fma_load_rows<T, METRIC>(stage_x(slot), stage_b(slot), x, bias, colscale, t0 + grp * TM,
                             min(TM, ntl - grp * TM), c0, g, lg_g, d, k0, klen, kp, cap, xvec,
                             kc == nk - 1);
    if (nk > 1) fma_load_queries(stage_q(slot), q, q0, nq, p.qb, d, k0, klen, kq, qvec);
  };
  if (nk == 1) fma_load_queries(reinterpret_cast<float*>(base), q, q0, nq, p.qb, d, 0, d, kq, qvec);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }

  float acc[TM][TN];
  for (int s = 0; s < total; ++s) {
    cp_async_wait_ring(p.stages);
    __syncthreads();  // stage s has landed; stage s - 1's slot is free again
    if (s + p.stages - 1 < total) load(s + p.stages - 1, (s + p.stages - 1) % p.stages);
    cp_async_commit();

    const int slot = s % p.stages;
    const int grp = s / nk;
    const int kc = s - grp * nk;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      }
    }
    // rows of tiles past the split's end hold stale values: their results
    // are dropped below
    fma_chunk<T, TM, TN>(stage_x(slot) + r0 * kp, g * kp,
                         (nk > 1 ? stage_q(slot) : reinterpret_cast<const float*>(base)) + j0 * kq,
                         kFmaQueryLanes * kq, (min(p.kc, d - kc * p.kc) + 3) >> 2, acc);
    if (kc != nk - 1) continue;
    const float* sb = stage_b(slot) + r0;  // this thread's bias in the stage's tile 0
    const int tiles = min(TM, ntl - grp * TM);
    const int row0 = (t0 + grp * TM) * kClasses + c0 + r0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i >= tiles) break;
      const float b = sb[i * g];
      const float cs = METRIC == kCos ? sb[cap + i * g] : 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float v = kernel_space<METRIC>(acc[i][j], b, cs);
        if constexpr (kTop3) {
          // rows only grow along the loop, so (v, row) beats the third tier
          // iff v is smaller: the usual case is one compare and a reject
          if (v < td[j][2]) insert3(td[j], ti[j], v, row0 + i * kClasses);
        } else {
          n_lt[j] += v < tau[j];
          n_le[j] += v <= tau[j];
        }
      }
    }
  }
  cp_async_wait_ring(2);  // no copy may land after the CTA exits

  if constexpr (kTop3) {
    const int c = c0 + r0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int qi = q0 + j0 + kFmaQueryLanes * j;
      if (qi >= nq) continue;
#pragma unroll
      for (int t = 0; t < kTiers; ++t) {
        const size_t o = ((static_cast<size_t>(split) * nq + qi) * kTiers + t) * kClasses + c;
        part_dist[o] = td[j][t];
        part_row[o] = ti[j][t];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int a = n_lt[j], e = n_le[j];
#pragma unroll
      for (int off = 1; off < kFmaRowLanes; off <<= 1) {  // the 8 classes of one query
        a += __shfl_xor_sync(0xffffffffu, a, off);
        e += __shfl_xor_sync(0xffffffffu, e, off);
      }
      const int qi = q0 + j0 + kFmaQueryLanes * j;
      if ((lane & 7) == 0 && qi < nq) {
        if (a) atomicAdd(lt + qi, a);
        if (e) atomicAdd(le + qi, e);
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

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A tensor map over `rank` dims (innermost first; strides in bytes of dims
// 1..rank-1), boxes of `box`, zero fill past the edges.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// scan_wgmma_kernel<METRIC, MODE, KS, TPS, U> under plan p: the tensor maps,
// then the launch. q [nq, d] f32; qpad (chunked plans only) is q rounded to
// bf16, zero-padded to [query blocks x 64 qt, slabs x 64]. The corpus goes
// through TMA where its rows are 16-byte aligned, else through the
// producer's copies.
template <int METRIC, int MODE, int KS, int TPS, int U>
cudaError_t launch_wgmma(const float* q, const void* qpad, const void* x, const float* bias,
                         const float* cs,
                         const float* thresh, int nq, int n, int d, WgPlan p, float* part_dist,
                         int* part_row, int* lt, int* le, cudaStream_t stream) {
  const WgLayout L = wg_layout(d, p, MODE);
  const bool queued = MODE == kModeTop3 && wg_queued(U, TPS);
  if (p.units != U || (U == 1 ? p.qt != 1 && p.qt != 2 : p.qt != 4 || p.chunked) ||
      (queued && (p.queue < kWgPairs / 2 || p.tiles_per_split > kWgMaxSplitTiles)) ||
      p.tps < 1 || p.tps > 256 || p.cs < 1 || p.cs > L.slabs ||
      p.stages < 2 || p.stages > kWgMaxStages || p.splits < 1 || p.tiles_per_split < 1 ||
      p.block_tiles < 1 || (p.chunked && (p.tps != TPS || (KS > 0 && KS != 4 * p.cs))) ||
      (!p.chunked && TPS != 1) || (!p.chunked && p.cs != L.slabs) ||
      (KS > 0 && !p.chunked && KS != 4 * L.slabs) ||
      L.total > 232448 || reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
      (METRIC == kCos && reinterpret_cast<uintptr_t>(cs) % 16 != 0) ||
      (p.chunked && (qpad == nullptr || reinterpret_cast<uintptr_t>(qpad) % 16 != 0))) {
    return cudaErrorInvalidValue;
  }
  const int ntiles = n / kClasses;
  const int qblocks = (nq + L.qb - 1) / L.qb;
  const bool tma_x = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap xmap, bmap, cmap, qmap;
  {
    const cuuint64_t dims[2] = {kClasses, static_cast<cuuint64_t>(ntiles)};
    const cuuint64_t strides[1] = {kClasses * sizeof(float)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(L.g), static_cast<cuuint32_t>(p.tps)};
    cudaError_t err = tensor_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, bias, dims, strides,
                                 box, false);
    if (err != cudaSuccess) return err;
    cmap = bmap;
    if (METRIC == kCos) {
      err = tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, cs, dims, strides, box, false);
      if (err != cudaSuccess) return err;
    }
  }
  qmap = xmap = bmap;  // unused unless chunked / TMA-fed
  if (p.chunked) {
    const cuuint64_t kpad = static_cast<cuuint64_t>(L.slabs) * kSlab;
    const cuuint64_t dims[2] = {kpad, static_cast<cuuint64_t>(qblocks) * L.qb};
    const cuuint64_t strides[1] = {kpad * 2};
    const cuuint32_t box[2] = {kSlab, static_cast<cuuint32_t>(L.qb)};
    const cudaError_t err =
        tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qpad, dims, strides, box, true);
    if (err != cudaSuccess) return err;
  }
  if (tma_x) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), kClasses,
                                static_cast<cuuint64_t>(ntiles)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(d) * 2 * kClasses};
    const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(L.g), static_cast<cuuint32_t>(p.tps)};
    const cudaError_t err =
        tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box, true);
    if (err != cudaSuccess) return err;
  }
  auto kernel = scan_wgmma_kernel<METRIC, MODE, KS, TPS, U>;
  const size_t smem = static_cast<size_t>(L.total);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(qblocks, kClasses / L.g, p.splits);
  kernel<<<grid, kWgThreads, smem, stream>>>(xmap, bmap, cmap, qmap, q,
                                             static_cast<const __nv_bfloat16*>(x), thresh, nq, d,
                                             ntiles, p, tma_x ? 1 : 0, part_dist, part_row, lt, le);
  return cudaGetLastError();
}

// f(integral_constant<METRIC>, integral_constant<KS>, integral_constant<TPS>,
// integral_constant<U>) for a runtime metric (K11: L2 and IP only),
// query-block placement (a_regs 0, 4 or 8; cosine K1 at U = 1 takes 0 only:
// its tiers and colscale leave no registers for the A fragments,
// kernels/scan_fused.wgmma_placement), the tiles a warpgroup multiplies at
// once (tps: 2 or 4 for K1's and K2's chunked plans, else 1) and its units
// (2: the wide tile of A fragments in registers; K1 and K2 only).
template <int MODE, typename F>
cudaError_t with_metric_ks(int metric, int a_regs, int tps, int units, F&& f) {
  using L2 = std::integral_constant<int, kL2>;
  using IP = std::integral_constant<int, kIP>;
  using Cos = std::integral_constant<int, kCos>;
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using K0 = std::integral_constant<int, 0>;
  using K4 = std::integral_constant<int, 4>;
  using K8 = std::integral_constant<int, 8>;
  using K12 = std::integral_constant<int, 12>;
  auto by_ks = [&](auto m) -> cudaError_t {
    constexpr bool kRegs = !(MODE == kModeTop3 && decltype(m)::value == kCos);
    if (units == 2) {
      if constexpr (MODE != kModeTree) {
        if (tps == 1 && a_regs == 4) return f(m, K4{}, One{}, Two{});
        if (tps == 1 && a_regs == 8) return f(m, K8{}, One{}, Two{});
      }
      return cudaErrorInvalidValue;
    }
    if (units != 1) return cudaErrorInvalidValue;
    if (a_regs == 0) {
      if (tps == 1) return f(m, K0{}, One{}, One{});
      if constexpr (MODE != kModeTree) {
        if (tps == 2) return f(m, K0{}, Two{}, One{});
      }
      return cudaErrorInvalidValue;
    }
    if (tps == 4) {  // the wide tile's chunked stages, A read into registers a stage
      if constexpr (MODE != kModeTree) {
        if (a_regs == 8) return f(m, K8{}, K4{}, One{});
        if (a_regs == 12) return f(m, K12{}, K4{}, One{});
      }
      return cudaErrorInvalidValue;
    }
    if (tps != 1) return cudaErrorInvalidValue;
    if constexpr (kRegs) {
      if (a_regs == 4) return f(m, K4{}, One{}, One{});
      if (a_regs == 8) return f(m, K8{}, One{}, One{});
    }
    return cudaErrorInvalidValue;
  };
  if (metric == kL2) return by_ks(L2{});
  if (metric == kIP) return by_ks(IP{});
  if constexpr (MODE != kModeTree) {
    if (metric == kCos) return by_ks(Cos{});
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t wgmma_dispatch(int metric, const float* q, const void* qpad, const void* x,
                           const float* bias,
                           const float* cs, const float* thresh, int nq, int n, int d, WgPlan p,
                           float* part_dist, int* part_row, int* lt, int* le,
                           cudaStream_t stream) {
  // a chunked plan's tiles a stage are the kernel's TPS; other plans run
  // their stages' tiles one after another (TPS = 1)
  return with_metric_ks<MODE>(metric, p.a_regs, p.chunked ? p.tps : 1, p.units,
                              [&](auto m, auto ks, auto tps, auto u) {
    return launch_wgmma<decltype(m)::value, MODE, decltype(ks)::value, decltype(tps)::value,
                        decltype(u)::value>(q, qpad, x, bias, cs, thresh, nq, n, d, p, part_dist,
                                            part_row, lt, le, stream);
  });
}

template <int MODE>
cudaError_t wgmma_attributes(int metric, int a_regs, int tps, int units, int* regs,
                             int* local_bytes) {
  return with_metric_ks<MODE>(metric, a_regs, tps, units, [&](auto m, auto ks, auto t, auto u) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(
        &a, scan_wgmma_kernel<decltype(m)::value, MODE, decltype(ks)::value, decltype(t)::value,
                              decltype(u)::value>);
    if (err == cudaSuccess) {
      *regs = a.numRegs;
      *local_bytes = static_cast<int>(a.localSizeBytes);
    }
    return err;
  });
}

template <typename T, int METRIC>
cudaError_t launch_v1_bin(const float* q, const void* x, const float* bias, const float* cs,
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
cudaError_t launch_v1_count(const float* q, const void* x, const float* bias, const float* cs,
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

// f(T{}, integral_constant<METRIC>) for a runtime dtype (0 = f32, 1 = bf16)
// and metric.
template <typename F>
cudaError_t with_dtype_metric(int dtype, int metric, F&& f) {
  using L2 = std::integral_constant<int, kL2>;
  using IP = std::integral_constant<int, kIP>;
  using Cos = std::integral_constant<int, kCos>;
  if (dtype == 0 && metric == kL2) return f(float{}, L2{});
  if (dtype == 0 && metric == kIP) return f(float{}, IP{});
  if (dtype == 0 && metric == kCos) return f(float{}, Cos{});
  if (dtype == 1 && metric == kL2) return f(__nv_bfloat16{}, L2{});
  if (dtype == 1 && metric == kIP) return f(__nv_bfloat16{}, IP{});
  if (dtype == 1 && metric == kCos) return f(__nv_bfloat16{}, Cos{});
  return cudaErrorInvalidValue;
}

int scan_bin(const float* q, const void* x, const float* bias, const float* cs, int nq, int n,
             int d, int dtype, int metric, MmaGrid g, float* part_dist, int* part_row,
             cudaStream_t stream) {
  if (g.qwarps == 0) {  // the first FMA design
    return static_cast<int>(with_dtype_metric(dtype, metric, [&](auto t, auto m) {
      return launch_v1_bin<decltype(t), decltype(m)::value>(
          q, x, bias, cs, nq, n, d, g.splits, g.tiles_per_split, part_dist, part_row, stream);
    }));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma_metric<kModeTop3>(
      metric, q, x, bias, cs, nullptr, nq, n, d, g, part_dist, part_row, nullptr, nullptr,
      stream));
}

int scan_count(const float* q, const void* x, const float* bias, const float* cs,
               const float* thresh, int nq, int n, int d, int dtype, int metric, MmaGrid g,
               int* lt, int* le, cudaStream_t stream) {
  if (g.qwarps == 0) {  // the first FMA design
    return static_cast<int>(with_dtype_metric(dtype, metric, [&](auto t, auto m) {
      return launch_v1_count<decltype(t), decltype(m)::value>(
          q, x, bias, cs, thresh, nq, n, d, g.splits, g.tiles_per_split, lt, le, stream);
    }));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma_metric<kModeCount>(
      metric, q, x, bias, cs, thresh, nq, n, d, g, nullptr, nullptr, lt, le, stream));
}

// The FMA design (scan_fma_kernel with a TM x TM micro-tile) under plan p.
template <typename T, int METRIC, int MODE, int TM>
cudaError_t launch_fma(const float* q, const void* x, const float* bias, const float* cs,
                       const float* thresh, int nq, int n, int d, FmaPlan p, float* part_dist,
                       int* part_row, int* lt, int* le, cudaStream_t stream) {
  const int qwarps = p.qb / (kFmaQueryLanes * TM);
  if (qwarps < 1 || p.qb % (kFmaQueryLanes * TM) != 0 || (kFmaThreads / 32) % qwarps != 0 ||
      p.kc < 16 || p.kc % 16 != 0 || p.stages < 2 || p.stages > kFmaMaxStages || p.splits < 1 ||
      p.tiles_per_split < 1) {
    return cudaErrorInvalidValue;
  }
  const int g = (kFmaThreads / 32 / qwarps) * kFmaRowLanes;
  auto kernel = scan_fma_kernel<T, METRIC, MODE, TM, TM>;
  const size_t smem = static_cast<size_t>(fma_smem_bytes<T>(d, TM, g, p));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool xvec = static_cast<size_t>(d) * sizeof(T) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool qvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((nq + p.qb - 1) / p.qb, kClasses / g, p.splits);
  kernel<<<grid, kFmaThreads, smem, stream>>>(q, static_cast<const T*>(x), bias, cs, thresh, nq,
                                              d, p, n / kClasses, xvec, qvec, part_dist,
                                              part_row, lt, le);
  return cudaGetLastError();
}

template <int MODE, int TM>
cudaError_t fma_dispatch(int dtype, int metric, const float* q, const void* x, const float* bias,
                         const float* cs, const float* thresh, int nq, int n, int d, FmaPlan p,
                         float* part_dist, int* part_row, int* lt, int* le, cudaStream_t stream) {
  return with_dtype_metric(dtype, metric, [&](auto t, auto m) {
    return launch_fma<decltype(t), decltype(m)::value, MODE, TM>(
        q, x, bias, cs, thresh, nq, n, d, p, part_dist, part_row, lt, le, stream);
  });
}

template <int MODE, int TM>
cudaError_t fma_attributes(int dtype, int metric, int* regs, int* local_bytes) {
  return with_dtype_metric(dtype, metric, [&](auto t, auto m) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(
        &a, scan_fma_kernel<decltype(t), decltype(m)::value, MODE, TM, TM>);
    if (err == cudaSuccess) {
      *regs = a.numRegs;
      *local_bytes = static_cast<int>(a.localSizeBytes);
    }
    return err;
  });
}

}  // namespace

extern "C" {

// K1. q [nq, d] f32; x [n, d] (dtype), n a multiple of 256; bias, colscale
// [n] f32 (colscale read for cosine only); part_* [splits, nq, 3, 256]
// scratch; out_* [nq, 3, 256]. qwarps = 0 runs the first FMA design (timing
// only); otherwise the tensor-core design (bf16) with qwarps x cwarps
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

// K1 (mode 0), K11 (mode 1: bf16, L2 or IP) and K2 (mode 2) on the wgmma
// design under the plan of kernels/scan_fused.wgmma_plan (units: 64-query
// tiles a consumer warpgroup; queue: K1's hit queue, entries a thread, where
// its tiers are out of registers). q [nq, d] f32
// (rounded to bf16 by the kernel); qpad, for chunked plans only, is q
// rounded to bf16 and zero-padded to [query blocks x 64 qt, slabs x 64]
// (16-byte aligned); x [n, d] bf16, n a multiple of 256 (of 256 block_tiles for
// K11); bias and colscale [n] f32, 16-byte aligned (colscale read for
// cosine only). K1/K11: part_* [splits, nq, 3, 256] scratch, out_* [nq, 3,
// 256]; K2: thresh [nq], lt/le [nq] int32 zeroed by the caller. Returns
// cudaGetLastError().
int vi_scan_wgmma(int mode, const void* q, const void* qpad, const void* x, const void* bias,
                  const void* colscale, const void* thresh, int nq, int n, int d, int metric,
                  int qt, int units, int a_regs, int chunked, int cs, int tps, int stages,
                  int queue, int splits, int tiles_per_split, int block_tiles, void* part_dist,
                  void* part_row, void* out_dist, void* out_row, void* lt, void* le,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WgPlan p{qt, units, a_regs, chunked, cs, tps, stages, queue, splits, tiles_per_split,
                 block_tiles};
  const auto* qf = static_cast<const float*>(q);
  const auto* bf = static_cast<const float*>(bias);
  const auto* cf = static_cast<const float*>(colscale);
  float* pd = static_cast<float*>(part_dist);
  int* pr = static_cast<int*>(part_row);
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kModeCount) {
    return static_cast<int>(wgmma_dispatch<kModeCount>(
        metric, qf, qpad, x, bf, cf, static_cast<const float*>(thresh), nq, n, d, p, nullptr,
        nullptr, static_cast<int*>(lt), static_cast<int*>(le), s));
  }
  if (mode == kModeTop3) {
    err = wgmma_dispatch<kModeTop3>(metric, qf, qpad, x, bf, cf, nullptr, nq, n, d, p, pd, pr,
                                    nullptr, nullptr, s);
  } else if (mode == kModeTree) {
    if (tiles_per_split % block_tiles != 0 || (n / kClasses) % block_tiles != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = wgmma_dispatch<kModeTree>(metric, qf, qpad, x, bf, cf, nullptr, nq, n, d, p, pd, pr,
                                    nullptr, nullptr, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_splits(pd, pr, nq, splits, static_cast<float*>(out_dist),
                                              static_cast<int*>(out_row), s));
}

// Registers a thread and local (spilled) bytes of the wgmma design's kernel
// for metric, mode (0 K1, 1 K11, 2 K2), a_regs (0, 4, 8), the tiles a
// warpgroup multiplies at once (tps 1, or 2 or 4 for K1's and K2's chunked
// plans) and its units (1, or 2 for K1's and K2's wide tile).
int vi_scan_wgmma_attributes(int metric, int mode, int a_regs, int tps, int units, int* regs,
                             int* local_bytes) {
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kModeTop3) {
    err = wgmma_attributes<kModeTop3>(metric, a_regs, tps, units, regs, local_bytes);
  } else if (mode == kModeTree) {
    err = wgmma_attributes<kModeTree>(metric, a_regs, tps, units, regs, local_bytes);
  } else if (mode == kModeCount) {
    err = wgmma_attributes<kModeCount>(metric, a_regs, tps, units, regs, local_bytes);
  }
  return static_cast<int>(err);
}

// K1, FMA design: as vi_bin_candidates, with q [nq, d] already rounded to
// the storage dtype, micro-tile edge tm (4 or 8) and the plan of
// kernels/scan_fused.fma_plan.
int vi_bin_candidates_fma(const void* q, const void* x, const void* bias, const void* colscale,
                          int nq, int n, int d, int dtype, int metric, int tm, int qb, int kc,
                          int stages, int splits, int tiles_per_split, void* part_dist,
                          void* part_row, void* out_dist, void* out_row, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FmaPlan p{qb, kc, stages, splits, tiles_per_split};
  const auto* qf = static_cast<const float*>(q);
  const auto* bf = static_cast<const float*>(bias);
  const auto* cf = static_cast<const float*>(colscale);
  float* pd = static_cast<float*>(part_dist);
  int* pr = static_cast<int*>(part_row);
  cudaError_t err = cudaErrorInvalidValue;
  if (tm == 4) {
    err = fma_dispatch<kModeTop3, 4>(dtype, metric, qf, x, bf, cf, nullptr, nq, n, d, p, pd, pr,
                                     nullptr, nullptr, s);
  } else if (tm == 8) {
    err = fma_dispatch<kModeTop3, 8>(dtype, metric, qf, x, bf, cf, nullptr, nq, n, d, p, pd, pr,
                                     nullptr, nullptr, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_splits(pd, pr, nq, splits, static_cast<float*>(out_dist),
                                              static_cast<int*>(out_row), s));
}

// K2, FMA design: as vi_count_below, with q rounded as for
// vi_bin_candidates_fma and micro-tile edge tm (4 or 8).
int vi_count_below_fma(const void* q, const void* x, const void* bias, const void* colscale,
                       const void* thresh, int nq, int n, int d, int dtype, int metric, int tm,
                       int qb, int kc, int stages, int splits, int tiles_per_split, void* lt,
                       void* le, void* stream) {
  const FmaPlan p{qb, kc, stages, splits, tiles_per_split};
  const auto* qf = static_cast<const float*>(q);
  const auto* bf = static_cast<const float*>(bias);
  const auto* cf = static_cast<const float*>(colscale);
  const auto* tf = static_cast<const float*>(thresh);
  int* l = static_cast<int*>(lt);
  int* e = static_cast<int*>(le);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm == 4) {
    return static_cast<int>(fma_dispatch<kModeCount, 4>(dtype, metric, qf, x, bf, cf, tf, nq, n,
                                                        d, p, nullptr, nullptr, l, e, s));
  }
  if (tm == 8) {
    return static_cast<int>(fma_dispatch<kModeCount, 8>(dtype, metric, qf, x, bf, cf, tf, nq, n,
                                                        d, p, nullptr, nullptr, l, e, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spilled) bytes of the FMA design's kernel
// for dtype, metric, K1 (mode 0) or K2 (mode 2) and tm (4 or 8).
int vi_scan_fma_attributes(int dtype, int metric, int mode, int tm, int* regs, int* local_bytes) {
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kModeTop3 && tm == 4) {
    err = fma_attributes<kModeTop3, 4>(dtype, metric, regs, local_bytes);
  } else if (mode == kModeTop3 && tm == 8) {
    err = fma_attributes<kModeTop3, 8>(dtype, metric, regs, local_bytes);
  } else if (mode == kModeCount && tm == 4) {
    err = fma_attributes<kModeCount, 4>(dtype, metric, regs, local_bytes);
  } else if (mode == kModeCount && tm == 8) {
    err = fma_attributes<kModeCount, 8>(dtype, metric, regs, local_bytes);
  }
  return static_cast<int>(err);
}

const char* vi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
