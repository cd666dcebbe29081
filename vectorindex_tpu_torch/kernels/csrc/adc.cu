// Full-corpus ADC kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/adc.py:
//
//   K6 adc_scan_u8     replaces adc.py:adc_scan_pallas (body _adc_kernel)
//   K7 adc_scan_u4     replaces adc.py:adc_scan_u4_pallas (body _adc_u4_kernel)
//   K8 adc_topk_fused  replaces adc.py:adc_topk_fused (body _adc_candidates_kernel):
//                      its kernel is adc_topk.cu's; here are its second design
//                      (adc_topk_fused_v2) and first (adc_topk_fused_v1), kept
//                      for the A/B, and adc_scan_u8_v1 / adc_scan_u4_v1, K6's
//                      and K7's first designs
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
// +inf). Its distances come from the same __device__ qlane_add as K6's
// (and the first designs' row_sums add in the same order), so a K8
// candidate's distance equals K6's output at that row bit for bit. The
// TPU keeps 2 rows per class per 1,024-row tile and then 3 tiers, so it can
// drop the third of three nearest rows that share a class and a tile; the
// exact per-class top-3 kept here is a superset of what it keeps. The
// wrapper takes the strict top-min(k, 512) of the [B, 768] candidates.
//
// K6/K7 design (adc_qlane_scan_kernel): K8's lookups, with the sums leaving
// through shared memory. Queries lie on the lanes as in K8 (below): a CTA
// stages QB queries' LUTs [m][KSP][QB] (the wrapper lays them out per query
// block, kernels/adc.lut_blocks, so staging is one contiguous 16-byte-load
// copy), and the lanes that share a row read one code. A lane scores QL = 2
// queries (q and q + QB / 2, which lut_blocks puts side by side, so one
// 8-byte load reads both entries and one address serves both; QL = 1 where
// QB = 1), and kPairs = 4 consecutive rows a pass, through K8's own
// qlane_load / qlane_at / qlane_add (which also read u4 nibbles, so K7
// shares the body), with the next pass's codes loading while this pass's
// are summed. A direct store of a warp's sums would touch up to 32 output
// rows; instead each lane writes its 4 sums a query as one float4 into an
// output tile [QB][stride] in shared memory (stride padded so a
// quarter-warp's float4s fall on 8 distinct bank groups), and each full tile
// leaves as one bulk async copy per query row segment
// (cp.async.bulk.global.shared::cta, after fence.proxy.async and a barrier
// of the warp group that filled it), double-buffered so tile t's copies run
// while tile t + 1 fills. Where n % 4 != 0 (a row segment's address is then
// not 16-byte aligned) the same kernel writes each tile with coalesced plain
// stores. QB is the largest power of two <= 32 whose LUTs and tiles fit
// (kernels/adc.scan_query_block; 16 for PQ8x8: 128 KB of LUTs, 32 for
// pq16x4); the grid is whole waves of resident CTAs (kernels/adc.scan_grid).
// The first design (adc_scan_kernel, now adc_scan_u8_v1 / adc_scan_u4_v1,
// timed only) put the rows on the lanes: <= 8 queries a CTA as [b][m][ks],
// one row a thread, m lookups a query of 32 random entries of one table
// (about 3.2 wavefronts a lookup on PQ8 codes), writing out[b, row]
// coalesced along the rows.
//
// K8's second design (adc_qlane_candidates_kernel, adc_topk_fused_v2; the
// kernel K8 launches is adc_topk.cu's, which reads four queries a lane, lays
// the LUTs out so that a lookup instruction meets no bank conflict, and takes
// its codes from a ring filled by bulk copies): queries on the lanes. In the
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
// bytes per row, so at B=64 they are bound by the output bytes (256 MB at
// n = 1M); their lookups (B * n * m * 4 B over 132 SMs x 128 B a clock) are
// the next floor. K8 writes
// almost nothing; the f32 adds (B * n * m at 67 TFLOP/s) are its nominal
// bound, but every add needs a shared-memory lookup first: B * n * m * 4 B
// over 132 SMs x 128 B a clock is its real floor (the lookup floor,
// chip_smoke.py), which bank conflicts multiply. A one-hot product on the
// tensor cores would cost m * ks MACs per (query, row), above that floor, and
// would not keep K8 equal to K6 bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "adc_sum.cuh"
#include "class_top3.cuh"

namespace {

constexpr int kScanThreads = 256;  // rows in flight per CTA of K6/K7's first design
constexpr int kMaxQB = 8;          // queries per CTA of the first designs

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

// K6/K7, first design: grid (query block, split), kScanThreads threads; split s covers
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

// Code bytes [i0, i0 + cnt) of the rows row0 + p * rstep (p < kPairs) into
// w[p] (byte i in word i / 4); rows >= n are not read (zeros). K8 steps its
// pairs 32 / QB rows apart, K6/K7 take 4 consecutive rows. NW = 2: rows of
// exactly 8 code bytes, read as one 8-byte load where aligned; NW = 4: up
// to 16.
template <int QB, int NW>
__device__ __forceinline__ void qlane_load(const uint8_t* __restrict__ codes, int row0, int n,
                                           int m, int i0, int cnt, int vec, int rstep,
                                           uint32_t (&w)[kPairs][NW]) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int row = row0 + p * rstep;
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

// Where the LUT entry of code field i (BITS = 8: byte i, a u8 code; BITS =
// 4: nibble i, a packed u4 code, low nibble first as ops/dtypes.pack_u4
// packs) of word w lies for the thread's query: sl points at that field's
// subspace table in the [m][KSP][QB] LUTs (as bytes); the entry lies code *
// QB * 4 bytes in, plus qoff (4 q; 8 x the lane's query pair where a lane
// reads two queries' entries at once). Both fit in one shift, one mask and
// one OR, as qoff < QB * 4.
template <int QB, int BITS = 8>
__device__ __forceinline__ const char* qlane_at(const char* __restrict__ sl, uint32_t w, int i,
                                                uint32_t qoff) {
  constexpr int kShift = ilog2(QB) + 2;  // code * QB * 4 = code << kShift
  constexpr uint32_t kMask = ((1u << BITS) - 1u) << kShift;
  const int pos = BITS * i;
  const uint32_t at = pos >= kShift ? w >> (pos - kShift) : w << (kShift - pos);
  return sl + ((at & kMask) | qoff);
}

// acc += the entry at `at`, rounded: one query's (float), or the two
// queries' side by side (float2, one 8-byte load).
__device__ __forceinline__ void add_entry(float& acc, const char* at) {
  acc = __fadd_rn(acc, *reinterpret_cast<const float*>(at));
}

__device__ __forceinline__ void add_entry(float2& acc, const char* at) {
  const float2 e = *reinterpret_cast<const float2*>(at);
  acc.x = __fadd_rn(acc.x, e.x);
  acc.y = __fadd_rn(acc.y, e.y);
}

// acc[p] += the LUT entries of code fields [f0, f0 + cnt) of pair p (words
// w[p], 32 / BITS fields a word), in subspace order, each add rounded, as
// add_byte's; A = float (one query a lane) or float2 (two). sl points at
// subspace f0's table. CNT > 0 fixes cnt at compile time, so the adds have
// no branch and their loads schedule freely; CNT = 0 takes cnt at run time,
// one branch per word (a row's last word may hold fewer fields).
template <int QB, int KSP, int CNT, int NW, int BITS = 8, typename A>
__device__ __forceinline__ void qlane_add(const char* __restrict__ sl, uint32_t qoff,
                                          int run_cnt, const uint32_t (&w)[kPairs][NW],
                                          A (&acc)[kPairs]) {
  constexpr int kSub = KSP * QB * 4;  // bytes of one subspace's table
  constexpr int kFields = 32 / BITS;  // code fields a word
  const int cnt = CNT > 0 ? CNT : run_cnt;
#pragma unroll
  for (int wi = 0; wi < NW; ++wi) {
    if (kFields * wi >= cnt) break;
    if (kFields * wi + kFields <= cnt) {
#pragma unroll
      for (int i = 0; i < kFields; ++i) {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          add_entry(acc[p], qlane_at<QB, BITS>(sl + (kFields * wi + i) * kSub, w[p][wi], i, qoff));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kFields - 1; ++i) {
        if (kFields * wi + i < cnt) {
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            add_entry(acc[p],
                      qlane_at<QB, BITS>(sl + (kFields * wi + i) * kSub, w[p][wi], i, qoff));
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
  if (t0 < t1) qlane_load<QB, kWords>(codes, t0 * kClasses + c0, n, m, 0, cnt, vec, kRows, w);
  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * kClasses + c0;
    uint32_t next[kPairs][kWords] = {};
    if (tile + 1 < t1) {
      qlane_load<QB, kWords>(codes, row0 + kClasses, n, m, 0, cnt, vec, kRows, next);
    }
    float acc[kPairs] = {};
    qlane_add<QB, KSP, CNT, kWords>(sl, qoff, cnt, w, acc);
    if (CNT == 0) {
      for (int i0 = 16; i0 < m; i0 += 16) {  // rows of more than 16 codes
        uint32_t more[kPairs][4];
        qlane_load<QB, 4>(codes, row0, n, m, i0, min(16, m - i0), vec, kRows, more);
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

// ---------------------------------------------------------------------------
// K6/K7, queries on the lanes (adc_qlane_scan_kernel)
// ---------------------------------------------------------------------------

constexpr int kScanWarps = 16;  // warps of a K6/K7 CTA

// Rows one pass of a warp group of `wpg` warps scores: 32 * ql / qb row
// slots a warp (ql queries a lane), kPairs consecutive rows a slot.
__host__ __device__ constexpr int scan_pass_rows(int qb, int ql, int wpg) {
  return wpg * (32 * ql / qb) * kPairs;
}

// Floats between two queries' rows in an output tile of `rows` rows (a
// multiple of 32): a multiple of 4, so each query's segment is 16-byte
// aligned for the bulk copy, and padded so that the 8 lanes of each
// quarter-warp's float4 stores hit 8 distinct 16-byte bank groups.
// lpr = qb / ql lanes share a row.
__host__ __device__ constexpr int scan_tile_stride(int lpr, int rows) {
  return rows + 32 / (lpr < 8 ? lpr : 8);
}

// Shared memory of a K6/K7 CTA: its QB queries' LUTs [m][KSP][QB] and two
// output tiles [QB][stride] a warp group.
__host__ __device__ constexpr size_t scan_smem(int qb, int ql, int m, int ksp, int groups,
                                               int rows) {
  return 4 * (static_cast<size_t>(qb) * m * ksp +
              2 * static_cast<size_t>(groups) * qb * scan_tile_stride(qb / ql, rows));
}

// Sum h of a lane's accumulator (one query's, or the pair's).
__device__ __forceinline__ float lane_sum(float a, int) { return a; }
__device__ __forceinline__ float lane_sum(float2 a, int h) { return h ? a.y : a.x; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The async proxy's view of shared memory catches up with this thread's
// ordinary stores: needed before a bulk copy reads them.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gdst),
               "r"(smem_addr(ssrc)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk copies have read their shared memory (READ) or
// finished writing (otherwise).
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// A barrier of warp group g's wpg warps (named barrier g + 1; one warp
// syncs as a warp).
__device__ __forceinline__ void group_sync(int g, int wpg) {
  if (wpg == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(wpg * 32) : "memory");
  }
}

// K6/K7: out[q0 + q, row] for the CTA's QB queries over the rows of its
// split. grid (query block, split), 32 * kScanWarps threads in `groups`
// warp groups. A CTA step covers groups * tile_rows rows, group g the g-th
// tile_rows of them (a multiple of 32 and of scan_pass_rows(QB, QL, wpg));
// split s covers steps [s * tiles_per_split, ...). lut_blk [query blocks][m]
// [KSP][QB]: each CTA's LUTs staged as they lie, 16 bytes a load (entries
// past ks and queries past nq zero; with QL = 2 column 2 q + h holds query q
// + h * QB / 2). Lane l scores queries l % (QB / QL) + h * QB / QL (h < QL)
// over rows trow + p (p < kPairs) of each pass and writes a float4 of sums
// per query into its group's tile [QB][stride]; each full tile leaves by one
// bulk copy per query (bulk = 1, which needs n % 4 == 0 and out 16-byte
// aligned), issued after the proxy fence and the group's barrier while the
// group fills its other tile, or else by the group's coalesced stores.
// BITS = 8: u8 codes [n, mb = m]; 4: packed u4 [n, mb = m / 2]. CNT = m
// fixes the row width at compile time; 0 reads it at run time, 16 code
// bytes at a time.
template <int QB, int KSP, int CNT, int BITS, int QL>
__global__ void __launch_bounds__(32 * kScanWarps, 1)
    adc_qlane_scan_kernel(const float* __restrict__ lut_blk, const uint8_t* __restrict__ codes,
                          int nq, int n, int m, int mb, int groups, int tile_rows,
                          int tiles_per_split, int vec, int bulk, float* __restrict__ out) {
  constexpr int kLanes = QB / QL;      // lanes that share a row
  constexpr int kRows = 32 / kLanes;  // row slots of a warp
  constexpr int kPerByte = 8 / BITS;  // code fields a byte
  constexpr int kWords = CNT > 0 ? (CNT / kPerByte + 3) / 4 : 4;
  using Acc = typename std::conditional<QL == 2, float2, float>::type;
  extern __shared__ __align__(16) float smem[];
  const int lut_len = m * KSP * QB;
  {
    const auto* src =
        reinterpret_cast<const float4*>(lut_blk + static_cast<size_t>(blockIdx.x) * lut_len);
    auto* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < lut_len / 4; i += blockDim.x) dst[i] = __ldg(src + i);
  }
  __syncthreads();
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, nq - q0);
  const int lane = threadIdx.x & 31;
  const int q = lane % kLanes;  // the lane's queries: q + h * kLanes (h < QL)
  const uint32_t qoff = 4u * QL * q;  // lut_blocks puts them side by side
  const char* sl = reinterpret_cast<const char*>(smem);
  const int wpg = kScanWarps / groups;  // warps a group
  const int g = (threadIdx.x >> 5) / wpg;
  const int gwarp = (threadIdx.x >> 5) % wpg;
  const int trow = (gwarp * kRows + lane / kLanes) * kPairs;  // first row in a pass
  const int pass_rows = scan_pass_rows(QB, QL, wpg);
  const int passes = tile_rows / pass_rows;
  const int span = groups * tile_rows;  // rows of a CTA step
  const int nsteps = (n + span - 1) / span;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nsteps);
  const int stride = scan_tile_stride(kLanes, tile_rows);
  float* const gtiles = smem + lut_len + static_cast<size_t>(g) * 2 * QB * stride;
  const int cntb = CNT > 0 ? CNT / kPerByte : min(16, mb);  // code bytes of the first chunk
  // lanes 0..nqb-1 of a group's first warp issue its queries' copies
  const bool issuer = bulk && gwarp == 0 && lane < nqb;

  uint32_t w[kPairs][kWords];
  if (t0 < t1) {
    qlane_load<QB, kWords>(codes, t0 * span + g * tile_rows + trow, n, mb, 0, cntb, vec, 1, w);
  }
  for (int tile = t0; tile < t1; ++tile) {
    const int base = tile * span + g * tile_rows;
    float* const buf = gtiles + ((tile - t0) & 1) * QB * stride;
    for (int pass = 0; pass < passes; ++pass) {
      const int row0 = base + pass * pass_rows + trow;
      uint32_t next[kPairs][kWords] = {};
      if (tile + 1 < t1 || pass + 1 < passes) {
        const int nrow = row0 + pass_rows + (pass + 1 < passes ? 0 : span - tile_rows);
        qlane_load<QB, kWords>(codes, nrow, n, mb, 0, cntb, vec, 1, next);
      }
      Acc acc[kPairs] = {};
      qlane_add<QB, KSP, CNT, kWords, BITS>(sl, qoff, cntb * kPerByte, w, acc);
      if (CNT == 0) {
        for (int i0 = 16; i0 < mb; i0 += 16) {  // rows of more than 16 code bytes
          uint32_t more[kPairs][4];
          qlane_load<QB, 4>(codes, row0, n, mb, i0, min(16, mb - i0), vec, 1, more);
          qlane_add<QB, KSP, 0, 4, BITS>(sl + i0 * kPerByte * KSP * QB * 4, qoff,
                                         min(16, mb - i0) * kPerByte, more, acc);
        }
      }
#pragma unroll
      for (int h = 0; h < QL; ++h) {
        *reinterpret_cast<float4*>(buf + (q + h * kLanes) * stride + pass * pass_rows + trow) =
            make_float4(lane_sum(acc[0], h), lane_sum(acc[1], h), lane_sum(acc[2], h),
                        lane_sum(acc[3], h));
      }
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[p][k] = next[p][k];
      }
    }
    // the group's tile is complete: write it out
    const int rows = min(tile_rows, n - base);  // <= 0 past the last row
    if (bulk) {
      fence_proxy_async_smem();
      if (issuer) bulk_wait_all<true>();  // the other tile's copies have read it
    }
    group_sync(g, wpg);
    if (issuer && rows > 0) {
      bulk_store(out + static_cast<size_t>(q0 + lane) * n + base, buf + lane * stride,
                 static_cast<uint32_t>(rows) * 4u);
      bulk_commit();
    } else if (!bulk) {
      for (int b = 0; b < nqb; ++b) {
        float* o = out + static_cast<size_t>(q0 + b) * n + base;
        for (int r = gwarp * 32 + lane; r < rows; r += wpg * 32) o[r] = buf[b * stride + r];
      }
    }
  }
  if (issuer) bulk_wait_all<false>();
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

// The K6/K7 kernel for a runtime QB (a power of two <= 32), queries a lane,
// row width and code type, or nullptr. Rows of 8 and 16 u8 codes of 256-entry tables and
// of 16 and 32 u4 codes (PQ8, PQ16, pq16x4, pq32x4) take a loop compiled
// for their width.
using ScanKernel = void (*)(const float*, const uint8_t*, int, int, int, int, int, int, int, int,
                            int, float*);
template <int KSP, int CNT, int BITS, int QL>
ScanKernel scan_kernel_qb(int qb) {
  switch (qb) {
    case 1: return QL == 1 ? adc_qlane_scan_kernel<1, KSP, CNT, BITS, 1> : nullptr;
    case 2: return adc_qlane_scan_kernel<2, KSP, CNT, BITS, QL>;
    case 4: return adc_qlane_scan_kernel<4, KSP, CNT, BITS, QL>;
    case 8: return adc_qlane_scan_kernel<8, KSP, CNT, BITS, QL>;
    case 16: return adc_qlane_scan_kernel<16, KSP, CNT, BITS, QL>;
    case 32: return adc_qlane_scan_kernel<32, KSP, CNT, BITS, QL>;
    default: return nullptr;
  }
}

template <int QL>
ScanKernel scan_kernel_ql(int qb, int m, int ks, int packed_u4) {
  if (packed_u4) {
    if (m == 16) return scan_kernel_qb<16, 16, 4, QL>(qb);
    if (m == 32) return scan_kernel_qb<16, 32, 4, QL>(qb);
    return scan_kernel_qb<16, 0, 4, QL>(qb);
  }
  if (k8_ks_pad(ks) == 16) return scan_kernel_qb<16, 0, 8, QL>(qb);  // u8 codes of small tables
  if (m == 8) return scan_kernel_qb<256, 8, 8, QL>(qb);
  if (m == 16) return scan_kernel_qb<256, 16, 8, QL>(qb);
  return scan_kernel_qb<256, 0, 8, QL>(qb);
}

ScanKernel scan_kernel(int qb, int ql, int m, int ks, int packed_u4) {
  if (ks < 1 || ks > 256 || m < 1 || (packed_u4 && (ks > 16 || m % 2))) return nullptr;
  if (ql == 1) return scan_kernel_ql<1>(qb, m, ks, packed_u4);
  if (ql == 2) return scan_kernel_ql<2>(qb, m, ks, packed_u4);
  return nullptr;
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

// K6 and K7, queries on the lanes. lut_blk [ceil(nq / qb), m, KSP, qb] f32
// (kernels/adc.lut_blocks, KSP = k8_ks_pad(ks), for ql queries a lane);
// codes [n, mb] uint8 (mb = m, or m / 2 with packed_u4); qb a power of two
// <= 32; ql = 1 or 2 (2 needs qb >= 2); `groups` warp groups (a power of two
// <= kScanWarps) of tile_rows rows each, a multiple of 32 and of
// scan_pass_rows(qb, ql, kScanWarps / groups); scan_smem(...) bytes of shared
// memory; grid (query blocks, splits) of tiles_per_split CTA steps each;
// bulk = 1 writes the tiles by bulk copies (plain stores where n % 4 != 0 or
// out is not 16-byte aligned), 0 by plain stores; out [nq, n] f32.
int vi_adc_scan_qlanes(const void* lut_blk, const void* codes, int nq, int n, int m, int ks,
                       int mb, int packed_u4, int qb, int ql, int groups, int tile_rows,
                       int splits, int tiles_per_split, int bulk, void* out, void* stream) {
  const ScanKernel kernel = scan_kernel(qb, ql, m, ks, packed_u4);
  if (kernel == nullptr || groups < 1 || groups > kScanWarps || kScanWarps % groups ||
      tile_rows < 1 || tile_rows % 32 || tile_rows % scan_pass_rows(qb, ql, kScanWarps / groups) ||
      mb != (packed_u4 ? m / 2 : m) || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = scan_smem(qb, ql, m, k8_ks_pad(ks), groups, tile_rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + qb - 1) / qb, splits);
  kernel<<<grid, 32 * kScanWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut_blk), static_cast<const uint8_t*>(codes), nq, n, m, mb, groups,
      tile_rows, tiles_per_split, code_vec(codes, mb), bulk && aligned ? 1 : 0,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the K6/K7 kernel for these settings that one SM holds at once, or -1.
int vi_adc_scan_qlanes_per_sm(int qb, int ql, int m, int ks, int packed_u4, int groups,
                              int tile_rows) {
  const ScanKernel kernel = scan_kernel(qb, ql, m, ks, packed_u4);
  if (kernel == nullptr || groups < 1) return -1;
  const size_t smem = scan_smem(qb, ql, m, k8_ks_pad(ks), groups, tile_rows);
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * kScanWarps, smem) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

// K6 and K7 in their first design (adc_scan_u8_v1 / adc_scan_u4_v1: rows on
// the lanes). lut [nq, m, ks] f32; codes [n, mb] uint8 (mb = m, or m / 2
// with packed_u4); qb queries per CTA (qb * m * ks * 4 bytes of shared
// memory); out [nq, n] f32.
int vi_adc_scan_v1(const void* lut, const void* codes, int nq, int n, int m, int ks, int mb,
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
