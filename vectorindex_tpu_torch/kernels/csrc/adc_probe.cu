// IVF-PQ ADC probe kernel for Hopper (sm_90a), the CUDA counterpart of
// vectorindex_tpu/kernels/adc_probe.py:
//
//   K9  adc_probe_scores          replaces adc_probe.py:adc_probe_scores
//                                 (body _adc_probe_kernel)
//   K10 adc_probe_scores_rankseg  replaces adc_probe.py:adc_probe_scores_rankseg
//                                 (body _adc_rankseg_kernel)
//
// Both compute, for every (query b, probe p, slot o) of a CSR code store,
//
//   out[b, p * probe_cap + o] = (sum_{j=0..m-1} lut[b, j, code(row, j)]) + tcorr[row]
//
// with row = starts[b, p] + o when o < lives[b, p], and +inf otherwise (a
// dead row is never read). The coarse term base(q, list) is added by the
// caller. Codes are u8 [n, m] or packed u4 [n, m / 2], subspace 2i in the
// low nibble of byte i (ops/dtypes.pack_u4); the TPU kernels' lo|hi LUT
// permutation and block-transposed code array are Mosaic layouts and are
// not needed here. The LUT stays f32 (the TPU casts it to bf16 for the MXU).
//
// The sum runs in order j = 0..m-1 from 0.0f, every add rounded apart
// (__fadd_rn, add_byte in adc_sum.cuh, shared with K6/K7/K8), then
// + tcorr[row]: the plain PyTorch version in kernels/adc_probe.py does the
// same adds in the same order, so kernel and plain version agree bit for bit.
//
// Design: grid (pair = query * nprobe + probe, row chunk of kChunk slots),
// kThreads threads. A CTA whose chunk holds no live row writes +inf and
// exits; the others stage their query's LUT (m * ks floats: 16 KB for
// m=16, ks=256; 2 KB for m=32, ks=16) in shared memory, then each thread
// scores one row at a time: one 16-byte load of its code bytes where the
// row width allows it, m shared-memory lookups and adds. The TPU's two grids
// (per pair for large batches, rank-segment for B <= 16) exist to batch
// DMAs; on Hopper one kernel serves both, and the two Python wrappers keep
// their own launch counts.
//
// Bounds on the H100: per live probed row it reads m (or m/2) code bytes
// and a 4-byte correction and does m adds; it writes B * nprobe * probe_cap
// floats. So it is bound by bytes (output included). The adds are a
// dependent chain of m shared-memory lookups per row; coalesced 16-byte code
// loads and enough CTAs in flight are what this simple design does about
// it. Sharing the LUT across the probes of a query and skipping the dead
// output (a compacted candidate list) are left to later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "adc_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // output slots per CTA

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
    adc_probe_kernel(const float* __restrict__ lut, const int* __restrict__ starts,
                     const int* __restrict__ lives, const uint8_t* __restrict__ codes,
                     const float* __restrict__ tcorr, int nprobe, int probe_cap, int m, int ks,
                     int mb, bool vec, float* __restrict__ out) {
  extern __shared__ float slut[];
  const int pair = blockIdx.x;
  const int live = lives[pair];
  float* o = out + static_cast<size_t>(pair) * probe_cap;
  const int o0 = blockIdx.y * kChunk;
  const int o1 = min(o0 + kChunk, probe_cap);
  if (o0 >= live) {
    for (int off = o0 + threadIdx.x; off < o1; off += kThreads) o[off] = INFINITY;
    return;
  }
  const float* lq = lut + static_cast<size_t>(pair / nprobe) * m * ks;
  for (int i = threadIdx.x; i < m * ks; i += kThreads) slut[i] = lq[i];
  __syncthreads();
  const int start = starts[pair];
  for (int off = o0 + threadIdx.x; off < o1; off += kThreads) {
    float v = INFINITY;
    if (off < live) {
      const int row = start + off;
      const uint8_t* c = codes + static_cast<size_t>(row) * mb;
      float acc = 0.0f;
      int i = 0;
      if (vec) {
        for (; i + 16 <= mb; i += 16) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(c + i));
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc = add_byte<PACKED>(acc, slut, ks, i + 4 * q + r, (w[q] >> (8 * r)) & 0xffu);
            }
          }
        }
      }
      for (; i < mb; ++i) acc = add_byte<PACKED>(acc, slut, ks, i, __ldg(c + i));
      v = __fadd_rn(acc, __ldg(tcorr + row));
    }
    o[off] = v;
  }
}

template <bool PACKED>
cudaError_t launch(const float* lut, const int* starts, const int* lives, const uint8_t* codes,
                   const float* tcorr, int nq, int nprobe, int probe_cap, int m, int ks, int mb,
                   float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * ks * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adc_probe_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec = mb % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const dim3 grid(nq * nprobe, (probe_cap + kChunk - 1) / kChunk);
  adc_probe_kernel<PACKED><<<grid, kThreads, smem, stream>>>(
      lut, starts, lives, codes, tcorr, nprobe, probe_cap, m, ks, mb, vec, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 and K10 (one kernel; the wrappers count their launches apart). lut
// [nq, m, ks] f32; starts, lives [nq, nprobe] int32; codes [n, mb] uint8
// (mb = m, or m / 2 with packed_u4); tcorr [n] f32; out
// [nq, nprobe * probe_cap] f32.
int vi_adc_probe_scores(const void* lut, const void* starts, const void* lives, const void* codes,
                        const void* tcorr, int nq, int nprobe, int probe_cap, int m, int ks,
                        int mb, int packed_u4, void* out, void* stream) {
  const auto* l = static_cast<const float*>(lut);
  const auto* s = static_cast<const int*>(starts);
  const auto* v = static_cast<const int*>(lives);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const float*>(tcorr);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (packed_u4) {
    return static_cast<int>(launch<true>(l, s, v, c, t, nq, nprobe, probe_cap, m, ks, mb, o, st));
  }
  return static_cast<int>(launch<false>(l, s, v, c, t, nq, nprobe, probe_cap, m, ks, mb, o, st));
}

}  // extern "C"
