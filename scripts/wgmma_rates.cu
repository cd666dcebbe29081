// wgmma m64nNk16 (bf16 in, f32 accumulate) issue rate on the H100: the
// design measurement behind csrc/scan_fused.cu's choice of N = 32 for the
// wgmma scan (scan_wgmma_kernel). Built and run by
// `python3 scripts/ab_flat_tree_torch.py --wgmma-rates`, or by hand:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/wgmma_rates scripts/wgmma_rates.cu && ./build/wgmma_rates
//
// One CTA an SM (132), two warpgroups each issuing `iters` groups of KS
// k-steps into CHAINS independent accumulators (operands in shared memory,
// SS, or A in registers, RS), a wait at the end of each group; printed: the
// clocks a wgmma takes an SM at 1.98 GHz and the rate against the card's
// 989 TFLOP/s dense bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int N>
struct Acc { float d[N / 2]; };


template <int N>
__device__ void mma_ss(Acc<N>& a, uint64_t da, uint64_t db);
template <int N>
__device__ void mma_rs(Acc<N>& a, const uint32_t (&r)[4], uint64_t db);

template <>
__device__ __forceinline__ void mma_ss<16>(Acc<16>& a, uint64_t da, uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
               : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<16>(Acc<16>& a, const uint32_t (&r)[4], uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
               : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_ss<32>(Acc<32>& a, uint64_t da, uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<32>(Acc<32>& a, const uint32_t (&r)[4], uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(db), "r"(1));
}
#define R8(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
template <>
__device__ __forceinline__ void mma_ss<64>(Acc<64>& a, uint64_t da, uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
               : R8(0), R8(8), R8(16), R8(24)
               : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<64>(Acc<64>& a, const uint32_t (&r)[4], uint64_t db) {
  float* d = a.d;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
               : R8(0), R8(8), R8(16), R8(24)
               : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "l"(db), "r"(1));
}

// CHAINS independent accumulators, each KS k-steps a group; wait every group
template <int N, bool RS, int CHAINS, int KS>
__global__ void __launch_bounds__(256, 1) bench(float* out, int iters) {
  extern __shared__ __align__(1024) uint8_t sm[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(sm) + 1023) & ~uintptr_t(1023));
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(base)[i] = 0x3f803f80u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a0 = saddr(base), b0 = saddr(base + 16384);
  uint32_t r[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  Acc<N> acc[CHAINS];
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < N / 2; ++e) acc[c].d[e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        if constexpr (RS) mma_rs<N>(acc[c], r, desc(b0 + (ks & 3) * 32));
        else mma_ss<N>(acc[c], desc(a0 + (ks & 3) * 32), desc(b0 + (ks & 3) * 32));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < N / 2; ++e) s += acc[c].d[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, bool RS, int CHAINS, int KS>
void run(float* out) {
  auto k = bench<N, RS, CHAINS, KS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 70000);
  const int iters = 2048;
  k<<<132, 256, 70000>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  k<<<132, 256, 70000>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double n_mma = double(iters) * KS * CHAINS * 2;  // 2 warpgroups a CTA
  const double clk = ms * 1e-3 * 1.98e9 / n_mma;
  const double flops = 2.0 * 64 * N * 16 * n_mma * 132 / (ms * 1e-3);
  printf("N=%d %s chains=%d ks=%d: %.3f ms, %.1f clk a wgmma an SM (at 1.98 GHz), %.0f TFLOP/s, err=%s\n", N,
         RS ? "RS" : "SS", CHAINS, KS, ms, clk, flops / 1e12, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 256 * 4);
  run<16, true, 1, 8>(out);
  run<16, true, 2, 8>(out);
  run<16, false, 1, 8>(out);
  run<16, false, 2, 8>(out);
  run<32, true, 1, 8>(out);
  run<32, true, 2, 8>(out);
  run<32, false, 1, 8>(out);
  run<32, false, 2, 8>(out);
  run<64, true, 1, 8>(out);
  run<64, true, 2, 8>(out);
  run<64, false, 1, 8>(out);
  run<64, false, 2, 8>(out);
  run<16, true, 4, 8>(out);
  run<32, true, 4, 4>(out);
  return 0;
}
