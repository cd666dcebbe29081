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
// dead row is never read). Two optional epilogue inputs fold the caller's
// passes in: base [nq, nprobe] (the coarse term) is one more rounded add of
// every slot, dead ones included (inf + base), and allow [n] (one byte a CSR
// row) turns a live slot whose row is denied into +inf. Codes are u8 [n, m]
// or packed u4 [n, m / 2], subspace 2i in the low nibble of byte i
// (ops/dtypes.pack_u4); the TPU kernels' lo|hi LUT permutation and
// block-transposed code array are Mosaic layouts and are not needed here.
// The LUT stays f32 (the TPU casts it to bf16 for the MXU).
//
// The sum runs in order j = 0..m-1 from 0.0f, every add rounded apart
// (__fadd_rn, add_byte in adc_sum.cuh, shared with K6/K7/K8), then
// + tcorr[row], then + base: the plain PyTorch version in
// kernels/adc_probe.py does the same adds in the same order, so kernel and
// plain version agree bit for bit.
//
// Design (adc_probe_group_kernel<PACKED, WIDE>): a CTA of 256 threads
// serves one query and G of its probes, one group of 256 / G threads a
// probe, one row a thread a chunk (kernels/adc_probe.probe_plan picks G).
// One thread loads the query's LUT (m * ks floats: 16 KB for m=16, ks=256)
// into shared memory by one bulk async copy (cp.async.bulk, completion on
// an mbarrier; the threads' own loads where the LUT is not 16-byte aligned
// or m * ks % 4 != 0), so the LUT is read once per G probes rather than
// once per (query, probe): at B=256 and nprobe=32 the L2 traffic of the
// LUTs falls from 134 MB to 17 MB (G = 8). The copy leaves first; each
// thread's first row's code bytes (one 16-byte load where mb % 16 == 0),
// correction and allow byte are loaded while it flies, and from then on the
// next chunk's are loaded while the current one is summed (a list longer
// than a chunk of 256 / G rows loops). Every lookup of a row's 16 code
// bytes is issued before its adds. The epilogue (+ tcorr, + base, the allow
// byte, read for live rows only) is applied before the store; the whole
// probe_cap of every probe is written, slots past the last chunk as +inf by
// float4 stores.
//
// Measured on the H100 and left out (PERF.md): a thread block cluster per
// query sharing one LUT read by multicast (its cluster barriers cost more
// than the L2 reads saved), two rows a thread, the LUT by the threads'
// 16-byte loads, and a ring of shared-memory stages filled by bulk copies
// of the list's codes (a bulk copy's issue stalls under load, and the stage
// barriers serialise a CTA's probes) were each slower.
//
// Bounds on the H100: per live probed row it reads m (or m/2) code bytes
// and a 4-byte correction and does m + 1 adds; it writes B * nprobe *
// probe_cap floats, so it is bound by bytes (the output's above all). The
// m lookups of a row are shared-memory reads with the rows on the lanes (32
// random entries of one table an instruction, so bank conflicts: about 3.2
// wavefronts a lookup); the LUT reads from L2 and those conflicts, not the
// bytes of the bound, set its time (PERF.md).
// adc_probe_kernel<PACKED> is the first design (grid (pair, chunk of 1,024
// slots), the LUT staged per (query, probe) by scalar loads), kept behind
// vi_adc_probe_scores_v1 for timing only.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "adc_sum.cuh"
#include "bulk_copy.cuh"

namespace {

// ---------------------------------------------------------------------------
// the first design (adc_probe_scores_v1)
// ---------------------------------------------------------------------------

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
cudaError_t launch_v1(const float* lut, const int* starts, const int* lives, const uint8_t* codes,
                      const float* tcorr, int nq, int nprobe, int probe_cap, int m, int ks, int mb,
                      float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * ks * sizeof(float);
  const cudaError_t err = allow_smem(adc_probe_kernel<PACKED>, smem);
  if (err != cudaSuccess) return err;
  const bool vec = mb % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const dim3 grid(nq * nprobe, (probe_cap + kChunk - 1) / kChunk);
  adc_probe_kernel<PACKED><<<grid, kThreads, smem, stream>>>(
      lut, starts, lives, codes, tcorr, nprobe, probe_cap, m, ks, mb, vec, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the probe-group design (K9 / K10)
// ---------------------------------------------------------------------------

constexpr int kMaxProbes = 8;  // G: at least one warp a probe

struct ProbeArgs {
  const float* lut;       // [nq, m, ks]
  const int* starts;      // [nq, nprobe]
  const int* lives;       // [nq, nprobe]
  const uint8_t* codes;   // [n, mb]
  const float* tcorr;     // [n]
  const float* base;      // [nq, nprobe] (rows base_stride floats apart) or nullptr
  const uint8_t* allow;   // [n] or nullptr
  float* out;             // [nq, nprobe * cap]
  int nprobe, cap, m, ks, mb, base_stride;
  int probes;    // G: probes a CTA serves, one group of kThreads / G threads each
  int groups;    // CTAs a query: ceil(nprobe / G)
  int lut_bulk;  // the LUT 16-byte aligned and m * ks % 4 == 0: one bulk copy (else loads)
  int vec;       // bytes a code load: 16, 8, 4 or 1 (the largest dividing mb and codes' address)
};

// Shared memory of a CTA (kernels/adc_probe.probe_smem computes the same):
// the LUT's mbarrier, padded to 16 bytes, then the LUT.
__host__ __device__ constexpr int group_smem(int m, int ks) { return 16 + 4 * m * ks; }

// cnt (<= 16, a multiple of vec) code bytes at p into w (byte i is
// (w[i / 4] >> 8 (i % 4)) & 0xff); p is aligned to vec. Every index into w
// is a constant after unrolling, so w stays in registers.
__device__ __forceinline__ void row_words(const uint8_t* __restrict__ p, int cnt, int vec,
                                          uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (vec == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if (vec == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (8 * h < cnt) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + h);
        w[2 * h] = u.x;
        w[2 * h + 1] = u.y;
      }
    }
  } else if (vec == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (4 * h < cnt) w[h] = __ldg(reinterpret_cast<const uint32_t*>(p) + h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < cnt) w[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
    }
  }
}

// The LUT entries of code byte i (one u8 code, or two u4 codes with the low
// nibble first) into v[0] (and v[1]).
template <bool PACKED>
__device__ __forceinline__ void lookup_byte(const float* __restrict__ slut, int ks, int i,
                                            uint32_t byte, float* v) {
  if (PACKED) {
    v[0] = slut[(2 * i) * ks + (byte & 15u)];
    v[1] = slut[(2 * i + 1) * ks + (byte >> 4)];
  } else {
    v[0] = slut[i * ks + byte];
  }
}

// A CTA serves query blockIdx.x / groups and G of its probes; group g (the
// g-th kThreads / G threads) owns probe (blockIdx.x % groups) * G + g and
// sums its live rows in chunks of kThreads / G, one row a thread. Registers
// are capped at 64 so that four CTAs share an SM.
//
// WIDE: rows of exactly 16 code bytes read 16 at a time (pq16 u8, pq32x4
// u4), fixed at compile time so the hot path carries no other load width.
template <bool PACKED, bool WIDE>
__global__ void __launch_bounds__(kThreads, 4) adc_probe_group_kernel(const ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* slut = reinterpret_cast<float*>(smem + 16);
  const int tg = kThreads / a.probes;  // threads a group (a multiple of 32)
  const int t = threadIdx.x % tg;
  const int q = blockIdx.x / a.groups;
  const int p = (blockIdx.x % a.groups) * a.probes + threadIdx.x / tg;
  const bool has = p < a.nprobe;  // false in the last CTA's spare groups
  const size_t pair = static_cast<size_t>(q) * a.nprobe + (has ? p : 0);
  const float* lq = a.lut + static_cast<size_t>(q) * a.m * a.ks;
  const int mb = WIDE ? 16 : a.mb;
  const int vec = WIDE ? 16 : a.vec;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (a.lut_bulk) {  // the LUT's copy leaves first
      const uint32_t lut_bytes = 4u * a.m * a.ks;
      mbar_arrive_tx(bar, lut_bytes);
      bulk_load(slut, lq, lut_bytes, bar);
    }
  }
  int start = 0, live = 0;
  if (has) {
    start = __ldg(a.starts + pair);
    live = min(max(__ldg(a.lives + pair), 0), a.cap);
  }
  const float base =
      a.base && has ? __ldg(a.base + static_cast<size_t>(q) * a.base_stride + p) : 0.0f;
  // a chunk's loads: the first 16 code bytes, the correction and the allow
  // byte of the thread's row (zeros past the live rows)
  uint32_t w[4];
  float tc;
  bool allowed;
  const auto load_chunk = [&](int c0) {
    const int r = c0 + t;
    if (r < live) {
      row_words(a.codes + static_cast<size_t>(start + r) * mb, min(16, mb), vec, w);
      tc = __ldg(a.tcorr + start + r);
      allowed = !a.allow || __ldg(a.allow + start + r);
    } else {
      w[0] = w[1] = w[2] = w[3] = 0u;  // a dead slot: summed, not stored
      tc = 0.0f;
      allowed = true;
    }
  };
  load_chunk(0);  // in flight with the LUT's copy
  if (!a.lut_bulk) {  // an unaligned LUT, or m * ks % 4 != 0
    for (int i = threadIdx.x; i < a.m * a.ks; i += kThreads) slut[i] = __ldg(lq + i);
  }
  __syncthreads();  // the barrier is initialised (and a loaded LUT stored)
  bool lut_ready = !a.lut_bulk;
  const auto wait_lut = [&]() {
    if (!lut_ready) mbar_wait(bar, 0);
    lut_ready = true;
  };

  float* o = a.out + pair * a.cap;
  int c0 = 0;
  for (; c0 < live; c0 += tg) {
    uint32_t cw[4] = {w[0], w[1], w[2], w[3]};
    const float ctc = tc;
    const bool cok = allowed;
    if (c0 + tg < live) load_chunk(c0 + tg);  // the next chunk's loads fly meanwhile
    wait_lut();
    // this warp holds a live row (uniform across the warp, so an all-dead
    // warp skips its lookups without divergence)
    const bool warp_live = c0 + (t & ~31) < live;
    float acc = 0.0f;
    for (int i0 = 0; i0 < mb; i0 += 16) {
      const int cnt = min(16, mb - i0);
      if (i0 > 0 && c0 + t < live) {  // rows of more than 16 code bytes
        row_words(a.codes + static_cast<size_t>(start + c0 + t) * mb + i0, cnt, vec, cw);
      }
      if (!warp_live) continue;
      if (cnt == 16) {
        // every lookup of the 16 bytes first (they are independent), then
        // the adds in j order
        constexpr int kEntries = PACKED ? 32 : 16;  // LUT entries of 16 code bytes
        float v[kEntries];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          lookup_byte<PACKED>(slut, a.ks, i0 + i, (cw[i >> 2] >> (8 * (i & 3))) & 0xffu,
                              v + i * kEntries / 16);
        }
#pragma unroll
        for (int e = 0; e < kEntries; ++e) acc = __fadd_rn(acc, v[e]);
      } else {
        // the last bytes of a row whose width is no multiple of 16, in j order
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < cnt) {
            acc = add_byte<PACKED>(acc, slut, a.ks, i0 + i, (cw[i >> 2] >> (8 * (i & 3))) & 0xffu);
          }
        }
      }
    }
    // the epilogue: + tcorr, + base, the allow mask; the chunk's dead slots
    // are inf (+ base)
    if (t < a.cap - c0) {
      float v;
      if (c0 + t < live) {
        v = __fadd_rn(acc, ctc);
        if (a.base) v = __fadd_rn(v, base);
        if (!cok) v = INFINITY;
      } else {
        v = a.base ? __fadd_rn(INFINITY, base) : INFINITY;
      }
      o[c0 + t] = v;
    }
  }
  if (has) {  // the slots past the last chunk, by float4 stores
    const float dead = a.base ? __fadd_rn(INFINITY, base) : INFINITY;
    const float4 d4 = make_float4(dead, dead, dead, dead);
    for (int v = c0 / 4 + t; v < a.cap / 4; v += tg) reinterpret_cast<float4*>(o)[v] = d4;
  }
  wait_lut();  // the LUT's copy has landed before the CTA exits
}

template <bool PACKED, bool WIDE>
cudaError_t launch_group(const ProbeArgs& a, int nq, cudaStream_t stream) {
  const auto kernel = adc_probe_group_kernel<PACKED, WIDE>;
  const size_t smem = group_smem(a.m, a.ks);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nq) * a.groups, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 and K10 (one kernel; the wrappers count their launches apart). lut
// [nq, m, ks] f32; starts, lives [nq, nprobe] int32; codes [n, mb] uint8
// (mb = m, or m / 2 with packed_u4); tcorr [n] f32; base [nq, nprobe] f32
// or null, its rows base_stride floats apart (the coarse-select distances
// are a slice of a wider sort); allow [n] uint8 (bool) or null; out
// [nq, nprobe * probe_cap] f32. probes (G: 1, 2, 4 or 8) probes of one
// query a CTA (kernels/adc_probe.probe_plan).
int vi_adc_probe_scores(const void* lut, const void* starts, const void* lives, const void* codes,
                        const void* tcorr, const void* base, const void* allow, int nq, int nprobe,
                        int base_stride, int probe_cap, int m, int ks, int mb, int packed_u4,
                        int probes, void* out, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (probes < 1 || probes > kMaxProbes || kThreads % (32 * probes) || probe_cap % 4 ||
      !aligned(out) || group_smem(m, ks) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProbeArgs a;
  a.lut = static_cast<const float*>(lut);
  a.starts = static_cast<const int*>(starts);
  a.lives = static_cast<const int*>(lives);
  a.codes = static_cast<const uint8_t*>(codes);
  a.tcorr = static_cast<const float*>(tcorr);
  a.base = static_cast<const float*>(base);
  a.allow = static_cast<const uint8_t*>(allow);
  a.out = static_cast<float*>(out);
  a.nprobe = nprobe;
  a.base_stride = base_stride;
  a.cap = probe_cap;
  a.m = m;
  a.ks = ks;
  a.mb = mb;
  a.probes = probes;
  a.groups = (nprobe + probes - 1) / probes;
  a.lut_bulk = aligned(lut) && (m * ks) % 4 == 0;
  // the widest load that every row's code bytes allow
  const auto addr = reinterpret_cast<uintptr_t>(codes);
  a.vec = 1;
  for (int v = 16; v >= 4; v /= 2) {
    if (mb % v == 0 && addr % v == 0) {
      a.vec = v;
      break;
    }
  }
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = mb == 16 && a.vec == 16;
  cudaError_t err;
  if (packed_u4) {
    err = wide ? launch_group<true, true>(a, nq, st) : launch_group<true, false>(a, nq, st);
  } else {
    err = wide ? launch_group<false, true>(a, nq, st) : launch_group<false, false>(a, nq, st);
  }
  return static_cast<int>(err);
}

// The first design (adc_probe_scores_v1): the same inputs without base and
// allow, for timing.
int vi_adc_probe_scores_v1(const void* lut, const void* starts, const void* lives,
                           const void* codes, const void* tcorr, int nq, int nprobe,
                           int probe_cap, int m, int ks, int mb, int packed_u4, void* out,
                           void* stream) {
  const auto* l = static_cast<const float*>(lut);
  const auto* s = static_cast<const int*>(starts);
  const auto* v = static_cast<const int*>(lives);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const float*>(tcorr);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (packed_u4) {
    return static_cast<int>(launch_v1<true>(l, s, v, c, t, nq, nprobe, probe_cap, m, ks, mb, o, st));
  }
  return static_cast<int>(launch_v1<false>(l, s, v, c, t, nq, nprobe, probe_cap, m, ks, mb, o, st));
}

}  // extern "C"
