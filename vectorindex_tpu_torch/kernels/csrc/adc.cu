// Full-corpus ADC kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/adc.py:
//
//   K6 adc_scan_u8     replaces adc.py:adc_scan_pallas (body _adc_kernel)
//   K7 adc_scan_u4     replaces adc.py:adc_scan_u4_pallas (body _adc_u4_kernel)
//   K8 adc_topk_fused  replaces adc.py:adc_topk_fused (body _adc_candidates_kernel)
//                      (adc_topk_fused_v1 keeps K8's first design for the A/B)
//
// K6 and K7 compute, for B queries' LUTs lut [B, m, ks] f32 over a code array
// of n rows (u8 [n, m], or packed u4 [n, m / 2] with ks <= 16),
//
//   out[b, i] = sum_{j=0..m-1} lut[b, j, code(i, j)]                  [B, n] f32
//
// with the sum of adc_sum.cuh: j in order from 0.0f, every add rounded
// apart, exactly as K9/K10 and the plain versions in kernels/adc.py add. The
// TPU contracts a one-hot matrix with a bf16 LUT on the MXU; here the LUT
// stays f32 in shared memory and is looked up. K7 reads the pack_u4 layout
// directly (the TPU's lo|hi LUT permutation is a Mosaic workaround).
//
// K8 is K6's scan fused with K1's selection (class_top3.cuh): per query and
// per class c = row mod 256 the 3 smallest finite (dist, row) pairs over the
// rows < n, in strict (dist, row) order, unfilled tiers (+inf, INVALID_ID).
// Rows >= n are never read (the TPU pads the code array and masks them to
// +inf). Its distances come from the same __device__ row_sums as K6's, so a
// K8 candidate's distance equals K6's output at that row bit for bit. The
// TPU keeps 2 rows per class per 1,024-row tile and then 3 tiers, so it can
// drop the third of three nearest rows that share a class and a tile; the
// exact per-class top-3 kept here is a superset of what it keeps. The
// wrapper takes the strict top-min(k, 512) of the [B, 768] candidates.
//
// K6/K7 design: grid (query block of qb <= 8 queries, corpus split); each
// CTA stages its queries' LUTs in dynamic shared memory as [b][m][ks] (qb *
// m * ks f32: 8 KB a query for m=8, ks=256, so qb = 8 takes 64 KB) and each
// thread scores one row at a time: one 8- or 16-byte load of its code bytes
// where the row width and alignment allow it, then m shared-memory lookups
// and adds per query, qb independent chains. They write out[b, row]
// coalesced along the rows. K8's first design (adc_candidates_kernel, now
// adc_topk_fused_v1) is the same scan with 256 threads owning the 256
// classes (a 256-row tile holds one row of each), top-3s in registers.
//
// K8's design (adc_qlane_candidates_kernel): queries on the lanes. In the
// first design a warp's 32 lanes scored 32 rows for one query, so one
// lookup instruction read 32 random entries of one 256-float subspace table:
// 8 entries on each of the 32 banks, about 3.2 wavefronts a lookup on PQ
// codes. Here the wrapper passes the LUTs as [m, ks, B] and a CTA stages its
// QB queries as [m][KSP][QB], each subspace's table padded to KSP = 16 or
// 256 entries; lane l scores query l % QB of one of 32 / QB rows, so the
// lanes that share a row read one code (a broadcast load) and one lookup
// instruction touches 32 / QB segments of QB consecutive floats:
// conflict-free at QB = 32, 1.5 wavefronts expected at QB = 16 (two
// segments land on one half of the banks with probability 1/2), about 2.1
// at QB = 8. QB is the largest power of two <= 32 whose LUTs fit in shared
// memory (16 for m=8, ks=256: 128 KB, one CTA an SM). A thread owns kPairs
// (query, class) pairs, one query and kPairs classes, so its tiers are 4 x 3
// x (dist, row) registers and no loop depends on the block's query count;
// lanes of queries past nq (a ragged last block) read zeros and write
// nothing. A warp covers kPairs * 32 / QB classes; a CTA up to kK8Warps
// warps, and the rest of the 256 classes go to class groups of the grid
// (query block, class group, split), whose split count the wrapper sizes to
// whole waves of resident CTAs (kernels/adc.k8_grid).
//
// With the banks fixed, instructions and stalls bounded it (PERF.md, PR 6),
// so the loop is lean: the subspace stride is a constant and a lookup is one
// shift, one mask-and-OR (code * QB * 4 | 4 q), the load and the add; rows
// of 8 and 16 codes (PQ8, PQ16) take a loop compiled for their width, with
// no branch among the adds; the next tile's codes load while this tile's are
// summed; and since a thread's rows only grow, a sum below its third tier is
// the whole test before an insert. The adds are add_byte's: j in order from
// 0.0f, each add rounded, so the distances equal K6's bit for bit; only the
// index arithmetic differs.
//
// Bounds on the H100: K6/K7 write 4 B per (query, row) and read m (or m/2)
// bytes per row, so at B=64 they are bound by the output bytes. K8 writes
// almost nothing; the f32 adds (B * n * m at 67 TFLOP/s) are its nominal
// bound, but every add needs a shared-memory lookup first: B * n * m * 4 B
// over 132 SMs x 128 B a clock is its real floor (the lookup floor,
// chip_smoke.py), which bank conflicts multiply. A one-hot product on the
// tensor cores would cost m * ks MACs per (query, row), above that floor, and
// would not keep K8 equal to K6 bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "adc_sum.cuh"
#include "class_top3.cuh"

namespace {

constexpr int kScanThreads = 256;  // rows in flight per K6/K7 CTA
constexpr int kMaxQB = 8;          // queries per CTA

// The LUTs of queries [q0, q0 + nqb) into shared memory, [b][m][ks].
__device__ __forceinline__ void stage_luts(float* __restrict__ slut, const float* __restrict__ lut,
                                           int q0, int nqb, int lut_len) {
  const float* src = lut + static_cast<size_t>(q0) * lut_len;
  for (int i = threadIdx.x; i < nqb * lut_len; i += blockDim.x) slut[i] = src[i];
  __syncthreads();
}

// acc[b] = the ADC sum of one row (mb code bytes at c) for the CTA's nqb
// queries. The one distance function of K6, K7 and K8: each query's adds run
// over j in order, whatever vec, nqb or the row's place in the grid.
template <bool PACKED>
__device__ __forceinline__ void row_sums(const float* __restrict__ slut, int lut_len, int ks,
                                         const uint8_t* __restrict__ c, int mb, int vec, int nqb,
                                         float (&acc)[kMaxQB]) {
#pragma unroll
  for (int b = 0; b < kMaxQB; ++b) acc[b] = 0.0f;
  for (int i0 = 0; i0 < mb; i0 += 16) {
    const int cnt = min(16, mb - i0);
    uint32_t w[4];
    load_chunk(c + i0, cnt, vec, w);
#pragma unroll
    for (int b = 0; b < kMaxQB; ++b) {
      if (b >= nqb) break;
      const float* sl = slut + b * lut_len;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < cnt) {
          acc[b] = add_byte<PACKED>(acc[b], sl, ks, i0 + i, (w[i >> 2] >> (8 * (i & 3))) & 0xffu);
        }
      }
    }
  }
}

// K6/K7: grid (query block, split), kScanThreads threads; split s covers
// rows [s * rows_per_split, (s + 1) * rows_per_split) of the n.
template <bool PACKED>
__global__ void __launch_bounds__(kScanThreads)
    adc_scan_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes, int nq,
                    int n, int m, int ks, int mb, int qb, int rows_per_split, int vec,
                    float* __restrict__ out) {
  extern __shared__ float slut[];
  const int q0 = blockIdx.x * qb;
  const int nqb = min(qb, nq - q0);
  const int lut_len = m * ks;
  stage_luts(slut, lut, q0, nqb, lut_len);
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(r0 + rows_per_split, n);
  for (int row = r0 + threadIdx.x; row < r1; row += kScanThreads) {
    float acc[kMaxQB];
    row_sums<PACKED>(slut, lut_len, ks, codes + static_cast<size_t>(row) * mb, mb, vec, nqb, acc);
#pragma unroll
    for (int b = 0; b < kMaxQB; ++b) {
      if (b >= nqb) break;
      out[static_cast<size_t>(q0 + b) * n + row] = acc[b];
    }
  }
}

// K8 scan, first design (adc_topk_fused_v1): grid (query block, split),
// kClasses threads; split s covers tiles [s * tiles_per_split, ...) of 256
// rows. Writes per-split top-3s to part_[dist|row] laid out
// [split][query][tier][class].
__global__ void __launch_bounds__(kClasses)
    adc_candidates_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                          int nq, int n, int m, int ks, int qb, int ntiles, int tiles_per_split,
                          int vec, float* __restrict__ part_dist, int* __restrict__ part_row) {
  extern __shared__ float slut[];
  const int q0 = blockIdx.x * qb;
  const int nqb = min(qb, nq - q0);
  const int lut_len = m * ks;
  const int split = blockIdx.y;
  const int c = threadIdx.x;
  stage_luts(slut, lut, q0, nqb, lut_len);

  float td[kMaxQB][kTiers];
  int ti[kMaxQB][kTiers];
#pragma unroll
  for (int b = 0; b < kMaxQB; ++b) {
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
    if (row >= n) break;  // the ragged last tile: rows >= n are masked
    float acc[kMaxQB];
    row_sums<false>(slut, lut_len, ks, codes + static_cast<size_t>(row) * m, m, vec, nqb, acc);
#pragma unroll
    for (int b = 0; b < kMaxQB; ++b) {
      if (b >= nqb) break;
      insert3(td[b], ti[b], acc[b], row);
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxQB; ++b) {
    if (b >= nqb) break;
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      const size_t o = ((static_cast<size_t>(split) * nq + q0 + b) * kTiers + t) * kClasses + c;
      part_dist[o] = td[b][t];
      part_row[o] = ti[b][t];
    }
  }
}

constexpr int kPairs = 4;    // (query, class) pairs a K8 thread owns
constexpr int kK8Warps = 16;  // most warps in a K8 CTA

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

// K8 stages each subspace's table padded to KSP = 16 or 256 entries, so the
// subspace stride is a constant.
__host__ __device__ constexpr int k8_ks_pad(int ks) { return ks <= 16 ? 16 : 256; }

// Code bytes [i0, i0 + cnt) of the rows row0 + p * 32 / QB (p < kPairs) into
// w[p] (byte i in word i / 4); rows >= n are not read. NW = 2: rows of
// exactly 8 codes, read as one 8-byte load where aligned; NW = 4: up to 16.
template <int QB, int NW>
__device__ __forceinline__ void qlane_load(const uint8_t* __restrict__ codes, int row0, int n,
                                           int m, int i0, int cnt, int vec,
                                           uint32_t (&w)[kPairs][NW]) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int row = row0 + p * (32 / QB);
    const uint8_t* c = codes + static_cast<size_t>(row) * m + i0;
    if constexpr (NW == 2) {
      w[p][0] = w[p][1] = 0u;
      if (row < n && vec >= 8) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(c));
        w[p][0] = u.x;
        w[p][1] = u.y;
      } else if (row < n) {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[p][i >> 2] |= static_cast<uint32_t>(__ldg(c + i)) << (8 * (i & 3));
      }
    } else if (row < n) {
      load_chunk(c, cnt, vec, w[p]);
    } else {
      w[p][0] = w[p][1] = w[p][2] = w[p][3] = 0u;
    }
  }
}

// The LUT entry of code byte i of word w for the thread's query: sl points at
// subspace i's table in the [m][KSP][QB] LUTs (as bytes); the entry lies
// code * QB * 4 bytes in, plus qoff = 4 q. Both fit in one shift, one mask
// and one OR, as qoff < QB * 4.
template <int QB>
__device__ __forceinline__ float qlane_entry(const char* __restrict__ sl, uint32_t w, int i,
                                             uint32_t qoff) {
  constexpr int kShift = ilog2(QB) + 2;  // code * QB * 4 = code << kShift
  const uint32_t at = 8 * i >= kShift ? w >> (8 * i - kShift) : w << (kShift - 8 * i);
  return *reinterpret_cast<const float*>(sl + ((at & (0xffu << kShift)) | qoff));
}

// acc[p] += the LUT entries of code bytes [i0, i0 + cnt) of pair p (words
// w[p]), in j order, each add rounded, as add_byte's. sl points at subspace
// i0's table. CNT > 0 fixes cnt at compile time, so the adds have no
// branch and their loads schedule freely; CNT = 0 takes cnt at run time,
// one branch per 4 codes (a row's last word may hold fewer).
template <int QB, int KSP, int CNT, int NW>
__device__ __forceinline__ void qlane_add(const char* __restrict__ sl, uint32_t qoff,
                                          int run_cnt, const uint32_t (&w)[kPairs][NW],
                                          float (&acc)[kPairs]) {
  constexpr int kSub = KSP * QB * 4;  // bytes of one subspace's table
  const int cnt = CNT > 0 ? CNT : run_cnt;
#pragma unroll
  for (int wi = 0; wi < NW; ++wi) {
    if (4 * wi >= cnt) break;
    if (4 * wi + 4 <= cnt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          acc[p] = __fadd_rn(acc[p], qlane_entry<QB>(sl + (4 * wi + i) * kSub, w[p][wi], i, qoff));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (4 * wi + i < cnt) {
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            acc[p] = __fadd_rn(acc[p], qlane_entry<QB>(sl + (4 * wi + i) * kSub, w[p][wi], i, qoff));
          }
        }
      }
    }
  }
}

// The thread's pairs over tiles [t0, t1): per tile the ADC sums of rows
// tile * 256 + c0 + p * 32 / QB, folded into the tiers. CNT = 8 or 16 fixes
// the row width (PQ8, PQ16) at compile time; CNT = 0 reads m at run time, 16
// codes at a time. The first 16 code bytes of the next tile's rows load while
// this tile's are summed. Rows only grow, so a sum below the third tier is the
// whole test before an insert (insert3 then orders ties by row).
template <int QB, int KSP, int CNT>
__device__ __forceinline__ void qlane_scan(const char* __restrict__ sl, uint32_t qoff,
                                           const uint8_t* __restrict__ codes, int n, int m,
                                           int vec, int c0, int t0, int t1,
                                           float (&td)[kPairs][kTiers],
                                           int (&ti)[kPairs][kTiers]) {
  constexpr int kRows = 32 / QB;
  constexpr int kWords = CNT > 0 ? (CNT + 3) / 4 : 4;
  const int cnt = CNT > 0 ? CNT : min(16, m);
  uint32_t w[kPairs][kWords];
  if (t0 < t1) qlane_load<QB, kWords>(codes, t0 * kClasses + c0, n, m, 0, cnt, vec, w);
  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * kClasses + c0;
    uint32_t next[kPairs][kWords] = {};
    if (tile + 1 < t1) qlane_load<QB, kWords>(codes, row0 + kClasses, n, m, 0, cnt, vec, next);
    float acc[kPairs] = {};
    qlane_add<QB, KSP, CNT, kWords>(sl, qoff, cnt, w, acc);
    if (CNT == 0) {
      for (int i0 = 16; i0 < m; i0 += 16) {  // rows of more than 16 codes
        uint32_t more[kPairs][4];
        qlane_load<QB, 4>(codes, row0, n, m, i0, min(16, m - i0), vec, more);
        qlane_add<QB, KSP, 0, 4>(sl + i0 * KSP * QB * 4, qoff, min(16, m - i0), more, acc);
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int row = row0 + p * kRows;
      if (row < n && acc[p] < td[p][2]) insert3(td[p], ti[p], acc[p], row);
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[p][k] = next[p][k];
    }
  }
}

// K8 scan, queries on the lanes: grid (query block of QB queries, class
// group, split), 32 * warps threads; split s covers tiles [s *
// tiles_per_split, ...) of 256 rows. lut_t [m, ks, nq], staged as [m][KSP][QB]
// (entries past ks zero, never read). Writes per-split top-3s to
// part_[dist|row] laid out [split][query][tier][class].
template <int QB, int KSP>
__global__ void __launch_bounds__(32 * kK8Warps, 1)
    adc_qlane_candidates_kernel(const float* __restrict__ lut_t,
                                const uint8_t* __restrict__ codes, int nq, int n, int m, int ks,
                                int ntiles, int tiles_per_split, int vec,
                                float* __restrict__ part_dist, int* __restrict__ part_row) {
  constexpr int kRows = 32 / QB;
  extern __shared__ float slut[];
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, nq - q0);
  for (int i = threadIdx.x; i < m * KSP * QB; i += blockDim.x) {
    const int e = i / QB;  // j * KSP + code
    const int b = i % QB;
    const int code = e % KSP;
    slut[i] = (b < nqb && code < ks)
                  ? lut_t[static_cast<size_t>(e / KSP * ks + code) * nq + q0 + b]
                  : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = lane % QB;
  const uint32_t qoff = 4u * q;
  const char* sl = reinterpret_cast<const char*>(slut);
  const int warp = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int c0 = warp * kPairs * kRows + lane / QB;  // the class of pair p is c0 + p * kRows
  float td[kPairs][kTiers];
  int ti[kPairs][kTiers];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      td[p][t] = INFINITY;
      ti[p][t] = kInvalidId;
    }
  }
  const int t0 = blockIdx.z * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, ntiles);
  if (m == 8) {
    qlane_scan<QB, KSP, 8>(sl, qoff, codes, n, m, vec, c0, t0, t1, td, ti);
  } else if (m == 16) {
    qlane_scan<QB, KSP, 16>(sl, qoff, codes, n, m, vec, c0, t0, t1, td, ti);
  } else {
    qlane_scan<QB, KSP, 0>(sl, qoff, codes, n, m, vec, c0, t0, t1, td, ti);
  }
  if (q >= nqb) return;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      const size_t o = ((static_cast<size_t>(blockIdx.z) * nq + q0 + q) * kTiers + t) * kClasses +
                       c0 + p * kRows;
      part_dist[o] = td[p][t];
      part_row[o] = ti[p][t];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Widest load the rows allow: 16 or 8 bytes at a time, else 1.
int code_vec(const void* codes, int mb) {
  const auto addr = reinterpret_cast<uintptr_t>(codes);
  if (mb % 16 == 0 && addr % 16 == 0) return 16;
  if (mb % 8 == 0 && addr % 8 == 0) return 8;
  return 1;
}

// The K8 kernel for a runtime QB (a power of two <= 32) and padded table
// size (16 or 256), or nullptr.
using QlaneKernel = void (*)(const float*, const uint8_t*, int, int, int, int, int, int, int,
                             float*, int*);
template <int KSP>
QlaneKernel qlane_kernel_ks(int qb) {
  switch (qb) {
    case 1: return adc_qlane_candidates_kernel<1, KSP>;
    case 2: return adc_qlane_candidates_kernel<2, KSP>;
    case 4: return adc_qlane_candidates_kernel<4, KSP>;
    case 8: return adc_qlane_candidates_kernel<8, KSP>;
    case 16: return adc_qlane_candidates_kernel<16, KSP>;
    case 32: return adc_qlane_candidates_kernel<32, KSP>;
    default: return nullptr;
  }
}

QlaneKernel qlane_kernel(int qb, int ks) {
  return k8_ks_pad(ks) == 16 ? qlane_kernel_ks<16>(qb) : qlane_kernel_ks<256>(qb);
}

template <bool PACKED>
cudaError_t launch_scan(const float* lut, const uint8_t* codes, int nq, int n, int m, int ks,
                        int mb, int qb, int splits, int rows_per_split, float* out,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(qb) * m * ks * sizeof(float);
  const cudaError_t err = allow_smem(adc_scan_kernel<PACKED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + qb - 1) / qb, splits);
  adc_scan_kernel<PACKED><<<grid, kScanThreads, smem, stream>>>(
      lut, codes, nq, n, m, ks, mb, qb, rows_per_split, code_vec(codes, mb), out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 and K7. lut [nq, m, ks] f32; codes [n, mb] uint8 (mb = m, or m / 2 with
// packed_u4); qb queries per CTA (qb * m * ks * 4 bytes of shared memory);
// out [nq, n] f32.
int vi_adc_scan(const void* lut, const void* codes, int nq, int n, int m, int ks, int mb,
                int packed_u4, int qb, int splits, int rows_per_split, void* out, void* stream) {
  const auto* l = static_cast<const float*>(lut);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (qb < 1 || qb > kMaxQB) return static_cast<int>(cudaErrorInvalidValue);
  if (packed_u4) {
    return static_cast<int>(launch_scan<true>(l, c, nq, n, m, ks, mb, qb, splits, rows_per_split, o, st));
  }
  return static_cast<int>(launch_scan<false>(l, c, nq, n, m, ks, mb, qb, splits, rows_per_split, o, st));
}

// K8 (scan and merge), queries on the lanes. lut_t [m, ks, nq] f32 (the
// LUTs by entry); codes [n, m] uint8; qb queries per CTA (a power of two <=
// 32, qb * m * KSP * 4 bytes of shared memory, KSP = k8_ks_pad(ks)); warps per CTA and class
// groups with warps * groups * kPairs * 32 / qb = 256; part_* [splits, nq, 3,
// 256] scratch; out_* [nq, 3, 256].
int vi_adc_topk_qlanes(const void* lut_t, const void* codes, int nq, int n, int m, int ks,
                       int qb, int warps, int groups, int splits, int tiles_per_split,
                       void* part_dist, void* part_row, void* out_dist, void* out_row,
                       void* stream) {
  const QlaneKernel kernel = qlane_kernel(qb, ks);
  if (kernel == nullptr || ks > 256 || warps < 1 || warps > kK8Warps ||
      warps * groups * kPairs * (32 / qb) != kClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(qb) * m * k8_ks_pad(ks) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (n + kClasses - 1) / kClasses;
  const dim3 grid((nq + qb - 1) / qb, groups, splits);
  kernel<<<grid, 32 * warps, smem, st>>>(static_cast<const float*>(lut_t),
                                         static_cast<const uint8_t*>(codes), nq, n, m, ks,
                                         ntiles, tiles_per_split, code_vec(codes, m),
                                         static_cast<float*>(part_dist),
                                         static_cast<int*>(part_row));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_splits(
      static_cast<const float*>(part_dist), static_cast<const int*>(part_row), nq, splits,
      static_cast<float*>(out_dist), static_cast<int*>(out_row), st));
}

// CTAs of the K8 kernel for this qb that one SM holds at once (registers,
// shared memory and threads), or -1 on an error.
int vi_adc_topk_qlanes_per_sm(int qb, int warps, int m, int ks) {
  const QlaneKernel kernel = qlane_kernel(qb, ks);
  if (kernel == nullptr) return -1;
  const size_t smem = static_cast<size_t>(qb) * m * k8_ks_pad(ks) * sizeof(float);
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * warps, smem) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

// K8's first design (adc_topk_fused_v1: rows on the lanes), scan and merge.
// lut [nq, m, ks] f32; codes [n, m] uint8; part_* [splits, nq, 3, 256]
// scratch; out_* [nq, 3, 256].
int vi_adc_topk_candidates(const void* lut, const void* codes, int nq, int n, int m, int ks,
                           int qb, int splits, int tiles_per_split, void* part_dist,
                           void* part_row, void* out_dist, void* out_row, void* stream) {
  if (qb < 1 || qb > kMaxQB) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(qb) * m * ks * sizeof(float);
  cudaError_t err = allow_smem(adc_candidates_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (n + kClasses - 1) / kClasses;
  const dim3 grid((nq + qb - 1) / qb, splits);
  adc_candidates_kernel<<<grid, kClasses, smem, st>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes), nq, n, m, ks, qb,
      ntiles, tiles_per_split, code_vec(codes, m), static_cast<float*>(part_dist),
      static_cast<int*>(part_row));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_splits(
      static_cast<const float*>(part_dist), static_cast<const int*>(part_row), nq, splits,
      static_cast<float*>(out_dist), static_cast<int*>(out_row), st));
}

}  // extern "C"
