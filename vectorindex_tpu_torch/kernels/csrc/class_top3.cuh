// Per-class top-3 selection shared by the binned top-k kernels K1
// (scan_fused.cu) and K8 (adc.cu).
//
// A query's candidates are kept per residue class c = row mod kClasses: the
// 3 smallest finite (dist, row) pairs in strict (dist, row) order, unfilled
// tiers (+inf, kInvalidId). A scan CTA keeps them for its corpus split in
// registers (thread t owns class t) and writes them as
// part_[dist|row][split][query][tier][class]; merge_splits_kernel folds the
// splits into [query][tier][class]. Per-class top-3 is decomposable and the
// lexicographic insert is order-free, so the result does not depend on the
// split count.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kClasses = 256;    // classes per query = threads per scan CTA = rows per tile
constexpr int kTiers = 3;        // candidates kept per (query, class)
constexpr int kInvalidId = 0x7fffffff;
constexpr int kMergeGroups = 8;  // split groups per class in the merge launch

__device__ __forceinline__ bool lex_less(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// Keep the 3 smallest finite (dist, row) pairs in strict (dist, row) order.
__device__ __forceinline__ void insert3(float (&td)[kTiers], int (&ti)[kTiers], float v, int row) {
  if (!(v < INFINITY) || !lex_less(v, row, td[2], ti[2])) return;
  if (lex_less(v, row, td[1], ti[1])) {
    td[2] = td[1];
    ti[2] = ti[1];
    if (lex_less(v, row, td[0], ti[0])) {
      td[1] = td[0];
      ti[1] = ti[0];
      td[0] = v;
      ti[0] = row;
    } else {
      td[1] = v;
      ti[1] = row;
    }
  } else {
    td[2] = v;
    ti[2] = row;
  }
}

// Merge: grid (query, kClasses / 32), 32 x kMergeGroups threads. Thread
// (g, lane) folds splits g, g + 8, ... of class blockIdx.y * 32 + lane, then
// group 0 folds the 8 partial top-3s. Output [query][tier][class].
__global__ void __launch_bounds__(32 * kMergeGroups)
    merge_splits_kernel(const float* __restrict__ part_dist, const int* __restrict__ part_row,
                        int nq, int splits, float* __restrict__ out_dist,
                        int* __restrict__ out_row) {
  __shared__ float sd[kMergeGroups][kTiers][32];
  __shared__ int si[kMergeGroups][kTiers][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  float td[kTiers] = {INFINITY, INFINITY, INFINITY};
  int ti[kTiers] = {kInvalidId, kInvalidId, kInvalidId};
  for (int s = g; s < splits; s += kMergeGroups) {
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

// Launch the merge of `splits` partial top-3s of nq queries.
inline cudaError_t launch_merge_splits(const float* part_dist, const int* part_row, int nq,
                                       int splits, float* out_dist, int* out_row,
                                       cudaStream_t stream) {
  merge_splits_kernel<<<dim3(nq, kClasses / 32), 32 * kMergeGroups, 0, stream>>>(
      part_dist, part_row, nq, splits, out_dist, out_row);
  return cudaGetLastError();
}

}  // namespace
