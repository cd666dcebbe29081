// Full-corpus ADC kernels for Hopper (sm_90a), the CUDA counterparts of
// vectorindex_tpu/kernels/adc.py:
//
//   K6 adc_scan_u8     replaces adc.py:adc_scan_pallas (body _adc_kernel)
//   K7 adc_scan_u4     replaces adc.py:adc_scan_u4_pallas (body _adc_u4_kernel)
//   K8 adc_topk_fused  replaces adc.py:adc_topk_fused (body _adc_candidates_kernel)
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
// Design: grid (query block of qb <= 8 queries, corpus split); each CTA
// stages its queries' LUTs in dynamic shared memory (qb * m * ks f32: 8 KB a
// query for m=8, ks=256, so qb = 8 takes 64 KB) and each thread scores one
// row at a time: one 8- or 16-byte load of its code bytes where the row
// width and alignment allow it, then m shared-memory lookups and adds per
// query, qb independent chains. K6/K7 write out[b, row] coalesced along the
// rows. K8's 256 threads own the 256 classes (a 256-row tile holds one row
// of each) and keep their top-3s in registers; a second small launch merges
// the splits.
//
// Bounds on the H100: K6/K7 write 4 B per (query, row) and read m (or m/2)
// bytes per row, so at B=64 they are bound by the output bytes. K8 writes
// almost nothing; its limit is the B * n * m shared-memory lookups (random
// entries of a 256-float table, so bank conflicts), with bytes and f32 adds
// well below their peaks. A one-hot product on the tensor cores (wgmma) or a
// register-blocked LUT is later work.

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

// K8 scan: grid (query block, split), kClasses threads; split s covers tiles
// [s * tiles_per_split, ...) of 256 rows. Writes per-split top-3s to
// part_[dist|row] laid out [split][query][tier][class].
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

// K8 (scan and merge). lut [nq, m, ks] f32; codes [n, m] uint8; part_*
// [splits, nq, 3, 256] scratch; out_* [nq, 3, 256].
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
