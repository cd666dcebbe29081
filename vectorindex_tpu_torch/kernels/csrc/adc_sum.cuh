// The ADC sum shared by the IVF-PQ probe kernels K9/K10 (adc_probe.cu) and
// the full-corpus ADC kernels K6/K7/K8 (adc.cu).
//
// A row's distance is sum_{j=0..m-1} lut[j, code_j], added in order
// j = 0..m-1 from 0.0f with every add rounded apart (__fadd_rn, which nvcc
// cannot contract): the plain PyTorch versions do the same adds in the same
// order, so every kernel agrees with its plain version, and K8 with K6, bit
// for bit. Codes are u8 [n, m] or packed u4 [n, m / 2] with subspace 2i in
// the low nibble of byte i (ops/dtypes.pack_u4). allow_smem, the launchers'
// once-per-kernel shared-memory attribute, is shared here too.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

// acc + the LUT entries of code byte i (one u8 code, or two u4 codes with the
// low nibble first). slut holds one query's LUT [m][ks].
template <bool PACKED>
__device__ __forceinline__ float add_byte(float acc, const float* __restrict__ slut, int ks,
                                          int i, uint32_t byte) {
  if (PACKED) {
    acc = __fadd_rn(acc, slut[(2 * i) * ks + (byte & 15u)]);
    return __fadd_rn(acc, slut[(2 * i + 1) * ks + (byte >> 4)]);
  }
  return __fadd_rn(acc, slut[i * ks + byte]);
}

// cnt <= 16 code bytes at p into w (byte i is (w[i / 4] >> 8 (i % 4)) & 0xff).
// vec = 16 or 8: p may be read 16 or 8 bytes at a time (cnt is a multiple of
// vec, p aligned to it); 1: bytewise.
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ p, int cnt, int vec,
                                           uint32_t (&w)[4]) {
  if (vec == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
    return;
  }
  if (vec == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = a.x;
    w[1] = a.y;
    w[2] = w[3] = 0u;
    if (cnt > 8) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(p) + 1);
      w[2] = b.x;
      w[3] = b.y;
    }
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int i = 0; i < cnt; ++i) w[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
}

// Lets `kernel` take `smem` bytes of dynamic shared memory. The attribute
// is set once per (device, kernel) and raised only when a launch needs more,
// so a launch makes no CUDA runtime call here after the first.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> granted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(dev, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = granted.find(key);
  if (it != granted.end() && it->second >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) granted[key] = smem;
  return err;
}

}  // namespace
