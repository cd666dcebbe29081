// K8, the full-corpus ADC top-k, for Hopper (sm_90a): the CUDA counterpart of
// vectorindex_tpu/kernels/adc.py:adc_topk_fused (body _adc_candidates_kernel).
// adc.cu keeps K8's two earlier designs, timed against this one
// (adc_topk_fused_v2: queries on the lanes, one a lane, codes by the
// threads' own loads; adc_topk_fused_v1: rows on the lanes).
//
// Contract (as adc.cu's): B queries' LUTs [B, m, ks] f32 over u8 codes
// [n, m] (every code < ks <= 256); per query and class c = row mod 256 the 3
// smallest finite (dist, row) over the rows < n in strict (dist, row) order,
// unfilled tiers (+inf, INVALID_ID); dist = sum_{j=0..m-1} lut[b, j, code]
// in j order from 0.0f, every add rounded apart (adc_sum.cuh), so a
// candidate's distance equals K6's output at its row bit for bit. Rows >= n
// are never read. The split merge then folds each query's partial top-3s.
//
// Design (adc_ring_candidates_kernel<QB, KSP, QL, S, CNT>; the plan is
// kernels/adc.k8_plan; the ratios are device times at bench_adc's shape, B =
// 256 over 1M PQ8x8 rows, on an H100 80GB HBM3 at 700 W, from
// scripts/ab_adc_torch.py's variants). A CTA holds QB queries' LUTs in shared
// memory and scores them against one class group's rows of each 256-row
// tile:
//
//  - Queries on the lanes, QL = 4 a lane (QB where QB < 4): lane q of a row
//    slot scores queries q + h * QB / QL (h < QL), whose entries lie side by
//    side, so one 16-byte load and one address serve four lookups. A lookup
//    step is one byte permute, one multiply-add of the code onto the lane's
//    32-bit base (the subspace offset rides in the load's immediate), the
//    load and QL adds. Two and one query a lane are A/B variants (1.2x and
//    1.7x the time).
//  - Lookups free of bank conflicts by construction (S = 32 / QB row slots
//    share one 128-byte wavefront at QB = 8, 16: a quarter-warp's 16-byte
//    loads, a half-warp's 8-byte ones). Their segments of QB floats would
//    fall on the same banks whenever their codes agree mod S. The LUTs are
//    laid out [i][code][h][QB] (kernels/adc.lut_blocks): line (i, code) of
//    128 bytes holds, in its S segments, the entries of subspaces h * mb + i,
//    h < S, where the row's m subspaces (padded with zero tables to mb * S)
//    form S sub-blocks of mb. Slot s of a group runs s phases behind slot 0:
//    in phase f it adds sub-block h = (f - s) mod S of its row (of the
//    previous tile's row while f < s), so the S slots of one instruction read
//    S different segments: one wavefront a group, whatever the codes. Each
//    row still adds j = 0..m-1 in order (a padded subspace adds +0.0f, which
//    leaves every sum's bits as they are: a sum from +0.0f is never -0.0f),
//    so no bit moves; slots s > 0 finish the segment's last rows in one more
//    iteration (the drain). S = 1 is the plain layout [j][code][QB].
//  - Codes by bulk async copies: a producer warp streams each tile's rows of
//    the class group (contiguous, rows < n only) into a ring of shared-memory
//    stages with cp.async.bulk on mbarriers (the bytes past a multiple of 16,
//    or all where the codes are not 16-byte aligned, by its lanes' loads);
//    the LUTs of a query block are one bulk copy. Consumer warps issue no
//    global load. Where m = 8 or 16 (CNT) a stage holds up to 8 tiles
//    (ring_tps): a thread reads its rows' code words of all of them into
//    registers after one barrier wait and releases the stage, and the tiles'
//    lookups then run as one unrolled block, the next tile's loads issued
//    among this one's adds (each doubling of the tiles a stage, from 1 to 8,
//    was faster). For other m each phase reads its code bytes from the
//    stage, which stays until the next tile is done.
//  - A thread owns kP classes of its queries (2 at QL = 2, 1 at QL = 4), its
//    tiers (QL x kP x 3 x (dist, row)) in registers. A sum below the third
//    tier is the whole test before an insert, and since a thread's rows only
//    grow the insert compares distances alone, branch-free (insert3_grow).
//    Inserts are not rare: a segment of T tiles inserts about 3 ln T times a
//    (query, class), and some lane of a warp inserts at most tests; all the
//    tiers of 4 classes a thread at QL = 2 left ptxas one lookup in flight at
//    the 96 registers a thread of a 17-warp CTA has (5 warps on one SM
//    sub-partition's 16,384). m = 8 and 16 take loops compiled for their
//    width with no branch among the adds, and the skew's row starts and ends
//    are selects, not branches.
//  - Persistent CTAs (kernels/adc.k8_ctas): the CTAs the SMs hold at once,
//    rounded down to whole CTAs a (query block, class group) stream where
//    that keeps 90% of them (128 of 132 at the main shape: a CTA crossing a
//    stream loads a second block's LUTs and starts a second set of tiers,
//    whose inserts cost more than 4 idle SMs). The work, (query block, class
//    group, tile) units in that order, is cut into one contiguous range a
//    CTA; a CTA flushes its tiers into the partial slot of each stream it
//    leaves. merge_segments_kernel folds each stream's partial slots.
//
// Bound on the H100: it writes almost nothing; B * n * m f32 adds (one FMA
// slot each: 67 / 2 TFLOP/s) are its nominal bound, and each add needs a
// 4-byte shared-memory lookup first: B * n * m * 4 bytes over 132 SMs x 128
// bytes a clock is its floor (chip_smoke.py's lookup floor), which this
// layout meets at one wavefront a served group of lanes.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "adc_sum.cuh"
#include "bulk_copy.cuh"
#include "class_top3.cuh"

namespace {

constexpr int kRingWarps = 16;   // most consumer warps of a CTA
constexpr int kRingPairs = 2;    // most classes a thread owns

__host__ __device__ constexpr int ring_ilog2(int v) { return v > 1 ? 1 + ring_ilog2(v / 2) : 0; }

// Row slots of a warp: 32 lanes over QB / QL lanes a row.
__host__ __device__ constexpr int ring_slots(int qb, int ql) { return 32 * ql / qb; }

// Classes a thread owns: enough that kRingWarps warps cover the 256 classes,
// at most kRingPairs and 4 / QL (at most 4 (query, class) tiers a thread).
__host__ __device__ constexpr int ring_pairs(int qb, int ql) {
  const int want = kClasses / (kRingWarps * ring_slots(qb, ql));
  const int most = kRingPairs < 4 / ql ? kRingPairs : 4 / ql;
  return want < 1 ? 1 : (want > most ? most : want);
}

// Tiles a ring stage holds: where m = 8, 16, 32 or 64 (CNT) a thread reads
// its rows' code words of all the stage's tiles into registers at once (16
// words, 8 tiles at most; one tile of 64 codes), so one barrier wait and
// release serve them all; else 1.
__host__ __device__ constexpr int ring_tps(int cnt, int pairs) {
  const int fit = cnt > 0 ? 64 / (cnt * pairs) : 1;
  return fit < 1 ? 1 : (fit > 8 ? 8 : fit);
}

// Bytes of a tile in a ring stage: a tile's rows of one class group, padded
// to 16.
__host__ __device__ constexpr int ring_tile_bytes(int rows, int m) { return (rows * m + 15) & ~15; }

// Bytes of the ring and the 16 bytes past it that a phase of padded
// subspaces may read; the barriers follow.
__host__ __device__ constexpr int ring_bar_offset(int rows, int m, int stages, int tps) {
  return stages * tps * ring_tile_bytes(rows, m) + 16;
}

// Shared memory of a CTA: the LUTs [mb][KSP][S][QB], the ring and its
// barriers (full and empty a stage, the LUTs' two).
__host__ __device__ constexpr size_t ring_smem(int qb, int ksp, int skew, int mb, int rows, int m,
                                               int stages, int tps) {
  return 4 * static_cast<size_t>(qb) * mb * skew * ksp + ring_bar_offset(rows, m, stages, tps) +
         8 * (2 * stages + 2);
}

// The CTA whose unit range holds unit u: CTA k covers [k U / P, (k + 1) U / P).
__host__ __device__ inline int ring_cta_of(long long u, long long units, int ctas) {
  return static_cast<int>(((u + 1) * ctas - 1) / units);
}

struct RingArgs {
  const float* lut;       // [ceil(nq / QB)][mb][KSP][S][QB] (kernels/adc.lut_blocks)
  const uint8_t* codes;   // [n, m]
  float* part_dist;       // [slots][nq][3][256]: a stream's partial top-3s
  int* part_row;
  long long units;        // query blocks x class groups x tiles
  int nq, n, m, mb;       // mb: subspaces a phase (m padded to mb * S)
  int ntiles, groups, ctas, stages;
  int bulk;               // codes 16-byte aligned: bulk copies
};

// A CTA's stretch of one (query block, class group) stream: tiles [tb, te)
// from unit u on, and the stream's partial slot it writes.
struct Segment {
  int qblk, g, tb, te, slot;
};

__device__ __forceinline__ Segment ring_segment(const RingArgs& a, long long u, long long u1) {
  const long long st = u / a.ntiles;
  Segment s;
  s.tb = static_cast<int>(u - st * a.ntiles);
  s.te = static_cast<int>(min(static_cast<long long>(a.ntiles), s.tb + (u1 - u)));
  s.qblk = static_cast<int>(st / a.groups);
  s.g = static_cast<int>(st % a.groups);
  s.slot = static_cast<int>(blockIdx.x) - ring_cta_of(st * a.ntiles, a.units, a.ctas);
  return s;
}

// The producer warp: per segment the query block's LUTs (one bulk copy, once
// the consumers are done with the last block's), then per stage of TPS tiles
// (the segment's drain, which copies nothing, among them) the class group's
// rows < n of each tile into the next stage once the consumers have released
// it.
template <int S, int TPS>
__device__ __forceinline__ void ring_produce(const RingArgs& a, unsigned char* smem,
                                             unsigned char* ring, uint64_t* full, uint64_t* empty,
                                             uint64_t* lut_full, uint64_t* lut_empty,
                                             int lut_bytes, int tile_bytes, int rows_g,
                                             long long u0, long long u1) {
  const int lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t round = 0;  // fills of the ring so far: stage's last use was round - 1
  int sg = 0;
  for (long long u = u0; u < u1; ++sg) {
    const Segment s = ring_segment(a, u, u1);
    if (lane == 0) {
      if (sg > 0) mbar_wait(lut_empty, (sg - 1) & 1);
      mbar_arrive_tx(lut_full, lut_bytes);
      bulk_load(smem, a.lut + static_cast<size_t>(s.qblk) * (lut_bytes / 4), lut_bytes, lut_full);
    }
    const int tend = s.te + (S > 1);
    for (int t0 = s.tb; t0 < tend; t0 += TPS) {
      if (round > 0) mbar_wait(empty + stage, (round - 1) & 1);
#pragma unroll
      for (int j = 0; j < TPS; ++j) {
        const int t = t0 + j;
        const long long row0 = static_cast<long long>(t) * kClasses + s.g * rows_g;
        const int rows =
            t < s.te ? static_cast<int>(max(0LL, min(static_cast<long long>(rows_g), a.n - row0)))
                     : 0;
        const int bytes = rows * a.m;
        const int bulk = a.bulk ? bytes & ~15 : 0;
        unsigned char* dst = ring + (stage * TPS + j) * tile_bytes;
        const uint8_t* src = a.codes + row0 * a.m;
        for (int i = bulk + lane; i < bytes; i += 32) dst[i] = __ldg(src + i);
        if (lane == 0 && bulk) {
          mbar_expect_tx(full + stage, bulk);
          bulk_load(dst, src, bulk, full + stage);
        }
      }
      mbar_arrive(full + stage);
      if (++stage == a.stages) {
        stage = 0;
        ++round;
      }
    }
    u += s.te - s.tb;
  }
}

// Word k of the code bytes a lane of skew s adds in phase F: sub-block S + F
// - s of its concatenated [previous row, this row] (NW words a row, NW / S a
// sub-block). The predicate s == r is the same every tile, so this is S - 1
// selects.
template <int S, int NW>
__device__ __forceinline__ uint32_t phase_word(const uint32_t (&prev)[NW],
                                               const uint32_t (&cur)[NW], int s, int f, int k) {
  constexpr int kNw = NW / S;
  uint32_t v = cur[f * kNw + k];
#pragma unroll
  for (int r = 1; r < S; ++r) {
    const int e = (S - r + f) * kNw + k;
    v = s == r ? (e < NW ? prev[e] : cur[e - NW]) : v;
  }
  return v;
}

// Code byte b of word w, masked to the padded table: KSP = 256 takes the byte
// as it is (one byte permute); KSP = 16 masks it (a no-op on codes < ks),
// so no stale byte of a row that is never kept reads past the tables.
template <int KSP>
__device__ __forceinline__ uint32_t code_at(uint32_t w, int b) {
  if constexpr (KSP == 256) return __byte_perm(w, 0u, 0x4440u | b);
  return (w >> (8 * b)) & (KSP - 1u);
}

// acc += the entry at shared-memory address `at` + OFF (OFF a constant, so
// it rides in the load's immediate and the address is one multiply-add of the
// code onto a 32-bit base), rounded: one query's (float), or the two
// queries' side by side (float2, one 8-byte load). Volatile keeps the load
// after the barrier wait that made the LUTs visible.
template <int OFF>
__device__ __forceinline__ void ring_add(float& acc, uint32_t at) {
  float e;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(e) : "r"(at), "n"(OFF));
  acc = __fadd_rn(acc, e);
}

template <int OFF>
__device__ __forceinline__ void ring_add(float2& acc, uint32_t at) {
  float x, y;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2+%3];\n" : "=f"(x), "=f"(y) : "r"(at), "n"(OFF));
  acc.x = __fadd_rn(acc.x, x);
  acc.y = __fadd_rn(acc.y, y);
}

template <int OFF>
__device__ __forceinline__ void ring_add(float4& acc, uint32_t at) {
  float x, y, z, w;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+%5];\n"
               : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
               : "r"(at), "n"(OFF));
  acc.x = __fadd_rn(acc.x, x);
  acc.y = __fadd_rn(acc.y, y);
  acc.z = __fadd_rn(acc.z, z);
  acc.w = __fadd_rn(acc.w, w);
}

__device__ __forceinline__ float ring_sum(float a, int) { return a; }
__device__ __forceinline__ float ring_sum(float2 a, int h) { return h ? a.y : a.x; }
__device__ __forceinline__ float ring_sum(float4 a, int h) {
  return h == 0 ? a.x : (h == 1 ? a.y : (h == 2 ? a.z : a.w));
}

// One subspace step of a phase for the thread's kP pairs: code byte B of
// each pair's word, the entry OFF bytes past its line.
template <int kShift, int KSP, int OFF, int B, int kP, typename Acc>
__device__ __forceinline__ void ring_step(Acc (&acc)[kP], const uint32_t (&w)[kP],
                                          uint32_t base) {
#pragma unroll
  for (int p = 0; p < kP; ++p) ring_add<OFF>(acc[p], base + (code_at<KSP>(w[p], B) << kShift));
}

// Word K and on of phase f's sub-block (NW / S words, 4 subspaces each), in
// subspace order.
template <int K, int S, int kShift, int KSP, int kStep, int kP, int NW, typename Acc>
__device__ __forceinline__ void ring_words(Acc (&acc)[kP], const uint32_t (&prev)[kP][NW],
                                           const uint32_t (&cur)[kP][NW], int s, int f,
                                           uint32_t base) {
  if constexpr (K < NW / S) {
    uint32_t w[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) w[p] = phase_word<S, NW>(prev[p], cur[p], s, f, K);
    ring_step<kShift, KSP, 4 * K * kStep, 0>(acc, w, base);
    ring_step<kShift, KSP, (4 * K + 1) * kStep, 1>(acc, w, base);
    ring_step<kShift, KSP, (4 * K + 2) * kStep, 2>(acc, w, base);
    ring_step<kShift, KSP, (4 * K + 3) * kStep, 3>(acc, w, base);
    ring_words<K + 1, S, kShift, KSP, kStep>(acc, prev, cur, s, f, base);
  }
}

// Insert (v, row) into a top-3 whose rows are all below row (a thread's rows
// only grow) and whose third distance v is below: insert3's result with the
// lexicographic compares reduced to distances, branch-free.
__device__ __forceinline__ void insert3_grow(float (&td)[kTiers], int (&ti)[kTiers], float v,
                                             int row) {
  const bool a0 = v < td[0];
  const bool a1 = v < td[1];
  td[2] = a1 ? td[1] : v;
  ti[2] = a1 ? ti[1] : row;
  td[1] = a0 ? td[0] : (a1 ? v : td[1]);
  ti[1] = a0 ? ti[0] : (a1 ? row : ti[1]);
  td[0] = a0 ? v : td[0];
  ti[0] = a0 ? row : ti[0];
}

// The consumer warps: per segment the tiers start empty; per tile each thread
// reads its kP rows' codes, runs the S phases, and tests the sums of the rows
// that ended against its tiers (a sum below the third tier is the whole test:
// rows only grow); at the segment's end the tiers go to the stream's partial
// slot.
template <int QB, int KSP, int QL, int S, int CNT>
__device__ __forceinline__ void ring_consume(const RingArgs& a, const unsigned char* smem,
                                             const unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, uint64_t* lut_full,
                                             uint64_t* lut_empty, int tile_bytes, int rows_g,
                                             long long u0, long long u1) {
  constexpr int kLanes = QB / QL;          // lanes of a row slot
  constexpr int kSlots = 32 / kLanes;      // row slots of a warp
  constexpr int kP = ring_pairs(QB, QL);
  constexpr int kTPS = ring_tps(CNT, kP);
  const int stage_bytes = kTPS * tile_bytes;
  constexpr int kLine = S * QB * 4;        // bytes of a line: S segments of QB floats
  constexpr int kShift = ring_ilog2(kLine);
  constexpr int kStep = KSP * kLine;       // bytes between two subspaces of a sub-block
  constexpr int kNW = CNT > 0 ? CNT / 4 : 1;  // code words a row
  using Acc = typename std::conditional<
      QL == 4, float4, typename std::conditional<QL == 2, float2, float>::type>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane % kLanes;             // the lane's queries: q + h * kLanes (h < QL)
  const int slot = lane / kLanes;
  const int s = slot % S;                  // phases behind slot 0 of its wavefront group
  const int lr0 = warp * kP * kSlots + slot;  // its pair p's row in the group: lr0 + p * kSlots
  uint32_t lbase[S];  // per phase: its sub-block's segment in a line, plus its queries' entries
#pragma unroll
  for (int f = 0; f < S; ++f) lbase[f] = smem_u32(smem) + ((f - s + S) % S) * QB * 4 + 4 * QL * q;
  float td[kP][QL][kTiers];
  int ti[kP][QL][kTiers];
  Acc acc[kP];
  Acc done[kP];  // the sums of the rows that ended this tile
  uint32_t cur[kP][kNW];
  uint32_t prev[kP][kNW];
  int stage = 0;
  int pstage = a.stages - 1;  // the previous tile's stage
  uint32_t round = 0;         // passes over the ring so far
  bool held = false;          // CNT = 0, S > 1: the previous tile's stage is still held
  int sg = 0;
  for (long long u = u0; u < u1; ++sg) {
    const Segment seg = ring_segment(a, u, u1);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      acc[p] = Acc{};
      done[p] = Acc{};
#pragma unroll
      for (int k = 0; k < kNW; ++k) prev[p][k] = 0u;
#pragma unroll
      for (int h = 0; h < QL; ++h) {
#pragma unroll
        for (int t = 0; t < kTiers; ++t) {
          td[p][h][t] = INFINITY;
          ti[p][h][t] = kInvalidId;
        }
      }
    }
    const int gbase = seg.g * rows_g + lr0;  // its pair 0's class
    // the rows pair p's test may keep: tiles [tb, te) and rows < n, as one
    // unsigned compare of row - lo - p * kSlots against span[p] (a row of
    // tile tb - 1 wraps past it)
    const uint32_t lo = static_cast<uint32_t>(seg.tb) * kClasses + gbase;
    uint32_t span[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const long long end = static_cast<long long>(seg.te) * kClasses + gbase + p * kSlots;
      const long long keep_end = min(end, static_cast<long long>(a.n));
      span[p] = static_cast<uint32_t>(max(0LL, keep_end - lo - p * kSlots));
    }
    mbar_wait(lut_full, sg & 1);
    const int tend = seg.te + (S > 1);
    for (int t0 = seg.tb; t0 < tend; t0 += kTPS) {
      mbar_wait(full + stage, round & 1);
      uint32_t cw[kTPS][kP][kNW];  // CNT > 0: the stage's tiles' code words of the thread's rows
      if constexpr (CNT > 0) {     // read, then the stage goes back
#pragma unroll
        for (int j = 0; j < kTPS; ++j) {
          const unsigned char* cst = ring + stage * stage_bytes + j * tile_bytes;
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const unsigned char* c = cst + (lr0 + p * kSlots) * CNT;
            if constexpr (CNT == 8) {
              const uint2 v = *reinterpret_cast<const uint2*>(c);
              cw[j][p][0] = v.x;
              cw[j][p][1] = v.y;
            } else {
#pragma unroll
              for (int k = 0; k < CNT / 16; ++k) {
                const uint4 v = reinterpret_cast<const uint4*>(c)[k];
                cw[j][p][4 * k] = v.x;
                cw[j][p][4 * k + 1] = v.y;
                cw[j][p][4 * k + 2] = v.z;
                cw[j][p][4 * k + 3] = v.w;
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
      }
#pragma unroll
      for (int j = 0; j < kTPS; ++j) {
        const int t = t0 + j;
        if (j > 0 && t >= tend) break;
        if constexpr (CNT > 0) {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
#pragma unroll
            for (int k = 0; k < kNW; ++k) cur[p][k] = cw[j][p][k];
          }
        }
        // S phases; with S > 1 a row starts and one ends at the lane's own
        // phases, selected (not branched), so the adds stay one block
#pragma unroll
        for (int f = 0; f < S; ++f) {
          if constexpr (CNT > 0) {
            ring_words<0, S, kShift, KSP, kStep>(acc, prev, cur, s, f, lbase[f]);
          } else {
            const int h = (f - s + S) % S;
            const unsigned char* c =
                ring + (f >= s ? stage : pstage) * stage_bytes + lr0 * a.m + h * a.mb;
            uint32_t si = lbase[f];
            for (int i = 0; i < a.mb; ++i, si += kStep) {
#pragma unroll
              for (int p = 0; p < kP; ++p) {
                const uint32_t code = c[p * kSlots * a.m + i] & (KSP - 1u);
                ring_add<0>(acc[p], si + (code << kShift));
              }
            }
          }
          if constexpr (S > 1) {  // phase f ends the row of a lane of skew f + 1 (mod S)
            const bool ends = (f + 1) % S == s;
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              done[p] = ends ? acc[p] : done[p];
              acc[p] = ends ? Acc{} : acc[p];
            }
          }
        }
        // test the ended rows' sums: a lagging lane's row is the previous tile's
        const uint32_t row0 = static_cast<uint32_t>(t - (s > 0 ? 1 : 0)) * kClasses + gbase;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const uint32_t row = row0 + p * kSlots;
          const bool keep = row - lo - p * kSlots < span[p];
#pragma unroll
          for (int h = 0; h < QL; ++h) {
            const float v = ring_sum(S > 1 ? done[p] : acc[p], h);
            if (keep && v < td[p][h][2]) insert3_grow(td[p][h], ti[p][h], v, static_cast<int>(row));
          }
          if constexpr (S == 1) acc[p] = Acc{};
        }
        if constexpr (CNT > 0) {
#pragma unroll
          for (int p = 0; p < kP; ++p) {
#pragma unroll
            for (int k = 0; k < kNW; ++k) prev[p][k] = cur[p][k];
          }
        }
      }
      if constexpr (CNT == 0) {  // release the stage no phase reads again
        __syncwarp();
        if (lane == 0) {
          if (S == 1) {
            mbar_arrive(empty + stage);
          } else if (held) {
            mbar_arrive(empty + pstage);
          }
        }
        held = true;
      }
      pstage = stage;
      if (++stage == a.stages) {
        stage = 0;
        ++round;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(lut_empty);
    const int q0 = seg.qblk * QB;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int h = 0; h < QL; ++h) {
        const int qi = q0 + q + h * kLanes;
        if (qi >= a.nq) continue;
#pragma unroll
        for (int t = 0; t < kTiers; ++t) {
          const size_t o =
              ((static_cast<size_t>(seg.slot) * a.nq + qi) * kTiers + t) * kClasses + gbase +
              p * kSlots;
          a.part_dist[o] = td[p][h][t];
          a.part_row[o] = ti[p][h][t];
        }
      }
    }
    u += seg.te - seg.tb;
  }
}

// K8: grid = a.ctas persistent CTAs, 32 * (warps + 1) threads: `warps`
// consumer warps and one producer warp (the last).
template <int QB, int KSP, int QL, int S, int CNT>
__global__ void __launch_bounds__(32 * (kRingWarps + 1), 1)
    adc_ring_candidates_kernel(const RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kP = ring_pairs(QB, QL);
  const int warps = static_cast<int>(blockDim.x >> 5) - 1;
  const int rows_g = warps * kP * ring_slots(QB, QL);
  const int lut_bytes = 4 * QB * a.mb * S * KSP;
  constexpr int kTPS = ring_tps(CNT, kP);
  const int tile_bytes = ring_tile_bytes(rows_g, a.m);
  unsigned char* ring = smem + lut_bytes;
  auto* full = reinterpret_cast<uint64_t*>(ring + ring_bar_offset(rows_g, a.m, a.stages, kTPS));
  uint64_t* empty = full + a.stages;
  uint64_t* lut_full = empty + a.stages;
  uint64_t* lut_empty = lut_full + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, warps);
    }
    mbar_init(lut_full, 1);
    mbar_init(lut_empty, warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long u0 = blockIdx.x * a.units / a.ctas;
  const long long u1 = (blockIdx.x + 1) * a.units / a.ctas;
  if (static_cast<int>(threadIdx.x >> 5) == warps) {
    ring_produce<S, kTPS>(a, smem, ring, full, empty, lut_full, lut_empty, lut_bytes, tile_bytes,
                          rows_g, u0, u1);
  } else {
    ring_consume<QB, KSP, QL, S, CNT>(a, smem, ring, full, empty, lut_full, lut_empty,
                                      tile_bytes, rows_g, u0, u1);
  }
}

// Merge: grid (query, 256 / 32), 32 x kMergeGroups threads. Thread (g, lane)
// folds partial slots g, g + 8, ... of class blockIdx.y * 32 + lane's stream
// (the CTAs whose unit ranges cut it, from ring_cta_of), then group 0 folds
// the 8 partial top-3s. Output [query][tier][class].
__global__ void __launch_bounds__(32 * kMergeGroups)
    merge_segments_kernel(const float* __restrict__ part_dist, const int* __restrict__ part_row,
                          int nq, int qb, int groups, int rows_g, int ntiles, long long units,
                          int ctas, float* __restrict__ out_dist, int* __restrict__ out_row) {
  __shared__ float sd[kMergeGroups][kTiers][32];
  __shared__ int si[kMergeGroups][kTiers][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const long long u = (static_cast<long long>(b / qb) * groups + c / rows_g) * ntiles;
  const int first = ring_cta_of(u, units, ctas);
  const int slots = ring_cta_of(u + ntiles - 1, units, ctas) - first + 1;
  float td[kTiers] = {INFINITY, INFINITY, INFINITY};
  int ti[kTiers] = {kInvalidId, kInvalidId, kInvalidId};
  for (int s = g; s < slots; s += kMergeGroups) {
#pragma unroll
    for (int t = 0; t < kTiers; ++t) {
      const size_t o = ((static_cast<size_t>(s) * nq + b) * kTiers + t) * kClasses + c;
      insert3(td, ti, part_dist[o], part_row[o]);
    }
  }
#pragma unroll
  for (int t = 0; t < kTiers; ++t) {
    sd[g][t][lane] = td[t];
    si[g][t][lane] = ti[t];
  }
  __syncthreads();
  if (g != 0) return;
  for (int h = 1; h < kMergeGroups; ++h) {
#pragma unroll
    for (int t = 0; t < kTiers; ++t) insert3(td, ti, sd[h][t][lane], si[h][t][lane]);
  }
#pragma unroll
  for (int t = 0; t < kTiers; ++t) {
    const size_t o = (static_cast<size_t>(b) * kTiers + t) * kClasses + c;
    out_dist[o] = td[t];
    out_row[o] = ti[t];
  }
}

using RingKernel = void (*)(RingArgs);

struct RingEntry {
  int qb, ksp, ql, skew, cnt;
  RingKernel kernel;
};

// Every kernel kernels/adc.k8_plan can choose (each m, ks <= 256 and B), and
// the A/B's variants at bench_adc's shape and at PQ16: one query a lane,
// skew off. tests/test_torch_adc.py reads this table.
#define VI_RING(QB, KSP, QL, S, CNT) \
  { QB, KSP, QL, S, CNT, adc_ring_candidates_kernel<QB, KSP, QL, S, CNT> }
const RingEntry kRingKernels[] = {
    VI_RING(32, 256, 4, 1, 0),
    VI_RING(16, 256, 4, 2, 8), VI_RING(16, 256, 4, 2, 0), VI_RING(16, 256, 4, 1, 0),
    VI_RING(8, 256, 4, 1, 8), VI_RING(8, 256, 4, 4, 16), VI_RING(8, 256, 4, 4, 0),
    VI_RING(8, 256, 4, 1, 0),
    VI_RING(4, 256, 4, 1, 8), VI_RING(4, 256, 4, 1, 16), VI_RING(4, 256, 4, 1, 0),
    VI_RING(2, 256, 2, 1, 8), VI_RING(2, 256, 2, 1, 16), VI_RING(2, 256, 2, 1, 0),
    VI_RING(1, 256, 1, 1, 8), VI_RING(1, 256, 1, 1, 16), VI_RING(1, 256, 1, 1, 0),
    VI_RING(4, 256, 4, 1, 32), VI_RING(2, 256, 2, 1, 32), VI_RING(1, 256, 1, 1, 32),
    VI_RING(2, 256, 2, 1, 64), VI_RING(1, 256, 1, 1, 64),
    VI_RING(32, 16, 4, 1, 8), VI_RING(32, 16, 4, 1, 16), VI_RING(32, 16, 4, 1, 0),
    VI_RING(16, 16, 4, 2, 8), VI_RING(16, 16, 4, 2, 16), VI_RING(16, 16, 4, 2, 0),
    VI_RING(16, 16, 4, 1, 0),
    VI_RING(8, 16, 4, 1, 8), VI_RING(8, 16, 4, 4, 16), VI_RING(8, 16, 4, 4, 0),
    VI_RING(8, 16, 4, 1, 0),
    VI_RING(4, 16, 4, 1, 8), VI_RING(4, 16, 4, 1, 16), VI_RING(4, 16, 4, 1, 0),
    VI_RING(2, 16, 2, 1, 8), VI_RING(2, 16, 2, 1, 16), VI_RING(2, 16, 2, 1, 0),
    VI_RING(1, 16, 1, 1, 8), VI_RING(1, 16, 1, 1, 16), VI_RING(1, 16, 1, 1, 0),
    VI_RING(32, 16, 4, 1, 32), VI_RING(16, 16, 4, 2, 32), VI_RING(8, 16, 4, 4, 32),
    VI_RING(4, 16, 4, 1, 32), VI_RING(2, 16, 2, 1, 32), VI_RING(1, 16, 1, 1, 32),
    VI_RING(32, 16, 4, 1, 64), VI_RING(16, 16, 4, 2, 64), VI_RING(8, 16, 4, 4, 64),
    VI_RING(4, 16, 4, 1, 64), VI_RING(2, 16, 2, 1, 64), VI_RING(1, 16, 1, 1, 64),
    // A/B only, at bench_adc's shape and at PQ16: skew off; two or one query
    // a lane
    VI_RING(16, 256, 4, 1, 8), VI_RING(16, 256, 2, 2, 8), VI_RING(16, 256, 2, 1, 8),
    VI_RING(16, 256, 1, 2, 8), VI_RING(16, 256, 1, 1, 8), VI_RING(8, 256, 4, 1, 16),
    VI_RING(8, 256, 2, 4, 16),
};
#undef VI_RING

// Where a row of m codes takes a loop compiled for its width: m = 8, 16, 32
// or 64, its sub-blocks whole words.
int ring_cnt(int m, int skew) {
  return (m == 8 || m == 16 || m == 32 || m == 64) && (m / skew) % 4 == 0 ? m : 0;
}

const RingEntry* ring_entry(int qb, int ksp, int ql, int skew, int cnt) {
  for (const RingEntry& e : kRingKernels) {
    if (e.qb == qb && e.ksp == ksp && e.ql == ql && e.skew == skew && e.cnt == cnt) return &e;
  }
  return nullptr;
}

// The kernel of a plan of kernels/adc.k8_plan, or nullptr where the plan's
// warps and class groups do not cover the 256 classes.
const RingEntry* ring_check(int m, int ks, int qb, int ql, int skew, int warps, int groups,
                            int stages) {
  if (m < 1 || ks < 1 || ks > 256 || stages < 2 || warps < 1 || warps > kRingWarps) {
    return nullptr;
  }
  const int cnt = ring_cnt(m, skew);
  const RingEntry* e = ring_entry(qb, ks <= 16 ? 16 : 256, ql, skew, cnt);
  if (e == nullptr || warps * groups * ring_pairs(qb, ql) * ring_slots(qb, ql) != kClasses) {
    return nullptr;
  }
  return e;
}

}  // namespace

extern "C" {

// K8 (scan and merge). lut_blk [ceil(nq / qb), mb, KSP, skew, qb] f32
// (kernels/adc.lut_blocks, KSP = 16 or 256, mb = ceil(m / skew)); codes
// [n, m] uint8; the plan (qb, ql, skew, warps, groups, stages) of
// kernels/adc.k8_plan; ctas persistent CTAs; part_* [slots, nq, 3, 256]
// scratch (slots >= the most CTAs that cut one stream); out_* [nq, 3, 256].
int vi_adc_topk_ring(const void* lut_blk, const void* codes, int nq, int n, int m, int ks, int qb,
                     int ql, int skew, int warps, int groups, int stages, int ctas,
                     void* part_dist, void* part_row, void* out_dist, void* out_row,
                     void* stream) {
  const RingEntry* e = ring_check(m, ks, qb, ql, skew, warps, groups, stages);
  if (e == nullptr || nq < 1 || n < 1 || ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a;
  a.lut = static_cast<const float*>(lut_blk);
  a.codes = static_cast<const uint8_t*>(codes);
  a.part_dist = static_cast<float*>(part_dist);
  a.part_row = static_cast<int*>(part_row);
  a.nq = nq;
  a.n = n;
  a.m = m;
  a.mb = (m + skew - 1) / skew;
  a.ntiles = (n + kClasses - 1) / kClasses;
  a.groups = groups;
  a.units = static_cast<long long>((nq + qb - 1) / qb) * groups * a.ntiles;
  a.ctas = ctas;
  a.stages = stages;
  a.bulk = reinterpret_cast<uintptr_t>(codes) % 16 == 0 ? 1 : 0;
  if (ctas > a.units) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_g = kClasses / groups;
  const size_t smem =
      ring_smem(qb, e->ksp, skew, a.mb, rows_g, m, stages, ring_tps(e->cnt, ring_pairs(qb, ql)));
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(e->kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  e->kernel<<<ctas, 32 * (warps + 1), smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_segments_kernel<<<dim3(nq, kClasses / 32), 32 * kMergeGroups, 0, st>>>(
      a.part_dist, a.part_row, nq, qb, groups, rows_g, a.ntiles, a.units, ctas,
      static_cast<float*>(out_dist), static_cast<int*>(out_row));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the K8 kernel for this plan that one SM holds at once, or -1.
int vi_adc_topk_ring_per_sm(int m, int ks, int qb, int ql, int skew, int warps, int groups,
                            int stages) {
  const RingEntry* e = ring_check(m, ks, qb, ql, skew, warps, groups, stages);
  if (e == nullptr) return -1;
  const size_t smem = ring_smem(qb, e->ksp, skew, (m + skew - 1) / skew, kClasses / groups, m,
                                stages, ring_tps(e->cnt, ring_pairs(qb, ql)));
  if (allow_smem(e->kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e->kernel, 32 * (warps + 1), smem) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

// Kernel i of the table: key[5] = (qb, ksp, ql, skew, cnt), its registers a
// thread and local (spill) bytes a thread; cudaErrorInvalidValue past the end.
int vi_adc_topk_ring_attributes(int i, int* key, int* regs, int* local_bytes) {
  if (i < 0 || i >= static_cast<int>(sizeof(kRingKernels) / sizeof(kRingKernels[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RingEntry& e = kRingKernels[i];
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, e.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  key[0] = e.qb;
  key[1] = e.ksp;
  key[2] = e.ql;
  key[3] = e.skew;
  key[4] = e.cnt;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
