// Probe of the tensor-core forms the all-pairs kernel (batch.cu) can take
// on Hopper (sm_90a), in bit pairs a second:
//   RB_PROBE_FORM 0: wgmma int8 m64n256k32 (0/1 bytes; one MAC is one bit pair)
//   RB_PROBE_FORM 1: wgmma b1 m64n256k256 AND-popcount
//   RB_PROBE_FORM 2: mma.sync b1 m16n8k256 AND-popcount
// Each form is compiled on its own (ops/_build.py passes -DRB_PROBE_FORM),
// so a form ptxas refuses leaves the others standing; its entry point is
// then missing from the library.
//
// The wgmma forms run two warpgroups a CTA, each issuing back-to-back
// products of four k-steps on operands already in shared memory (128-byte
// swizzled K-major rows, as batch.cu lays them out), one product group in
// flight behind the one being issued. The mma.sync form runs 16 warps a
// CTA, each with four independent accumulator chains on register
// operands. One CTA an SM; the caller times the launch with CUDA events
// and divides the bit pairs (per CTA and iteration, as chip_smoke.py's
// PROBE_FORMS counts them) by it.
// Each thread writes the sum of its accumulators so nothing is dead.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

#ifndef RB_PROBE_FORM
#define RB_PROBE_FORM 0
#endif

namespace {

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

#if RB_PROBE_FORM == 0 || RB_PROBE_FORM == 1

constexpr int kThreads = 256;                        // two consumer warpgroups
constexpr int kABytes = 2 * 64 * 128;                // each warpgroup's 64 rows of 128 bytes
constexpr int kBBytes = 256 * 128;
constexpr int kSmem = 1024 + kABytes + kBBytes;      // + alignment slack

__global__ void __launch_bounds__(kThreads, 1) probe_kernel(long long iters, uint32_t* out) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_s = rbw::smem_u32(raw);
  const uint32_t base = (raw_s + 1023u) & ~1023u;
  uint32_t* words = reinterpret_cast<uint32_t*>(raw + (base - raw_s));
#if RB_PROBE_FORM == 0
  const uint32_t mask = 0x01010101u;  // 0/1 bytes, as the int8 form holds bits
#else
  const uint32_t mask = 0xFFFFFFFFu;
#endif
  for (int i = threadIdx.x; i < (kABytes + kBBytes) / 4; i += kThreads)
    words[i] = mix(i * 2654435761u + blockIdx.x) & mask;
  rbw::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint32_t sa = base + wg * 64 * 128;
  const uint32_t sb = base + kABytes;
  uint32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0u;
  for (long long it = 0; it < iters; ++it) {
    rbw::fence_acc(d);
    rbw::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#if RB_PROBE_FORM == 0
      rbw::wgmma_s8(d, rbw::sw128_desc(sa + 32 * k), rbw::sw128_desc(sb + 32 * k));
#else
      rbw::wgmma_b1(d, rbw::sw128_desc(sa + 32 * k), rbw::sw128_desc(sb + 32 * k));
#endif
    }
    rbw::wgmma_commit();
    rbw::fence_acc(d);
    rbw::wgmma_wait<1>();
  }
  rbw::wgmma_wait<0>();
  rbw::fence_acc(d);
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

#else  // RB_PROBE_FORM == 2

constexpr int kThreads = 512;  // 16 warps
constexpr int kSmem = 0;
constexpr int kChains = 4;

__global__ void __launch_bounds__(kThreads, 1) probe_kernel(long long iters, uint32_t* out) {
  const uint32_t seed = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t a0 = mix(seed), a1 = mix(seed + 1), a2 = mix(seed + 2), a3 = mix(seed + 3);
  const uint32_t b0 = mix(seed + 4), b1 = mix(seed + 5);
  uint32_t c[kChains][4] = {};
  for (long long it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[ch][0]), "+r"(c[ch][1]), "+r"(c[ch][2]), "+r"(c[ch][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  uint32_t s = 0;
#pragma unroll
  for (int ch = 0; ch < kChains; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

#endif

int launch(int device, int blocks, long long iters, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (kSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rb_mma_probe_<form>: blocks CTAs (one an SM), each running iters
// iterations; out: uint32 [blocks * rb_mma_probe_<form>_threads()].
// Returns the launch's CUDA status.
#if RB_PROBE_FORM == 0
int rb_mma_probe_wgmma_s8(int device, int blocks, long long iters, void* out, void* stream) {
  return launch(device, blocks, iters, out, stream);
}
int rb_mma_probe_wgmma_s8_threads() { return kThreads; }
#elif RB_PROBE_FORM == 1
int rb_mma_probe_wgmma_b1(int device, int blocks, long long iters, void* out, void* stream) {
  return launch(device, blocks, iters, out, stream);
}
int rb_mma_probe_wgmma_b1_threads() { return kThreads; }
#else
int rb_mma_probe_mma_b1(int device, int blocks, long long iters, void* out, void* stream) {
  return launch(device, blocks, iters, out, stream);
}
int rb_mma_probe_mma_b1_threads() { return kThreads; }
#endif

}  // extern "C"
