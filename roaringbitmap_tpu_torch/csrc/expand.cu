// Hand-written Hopper (sm_90a) kernel of the payload expansion.
//
// rb_expand_rows replaces the XLA function the JAX package runs to turn a
// compact container payload into word rows on the device:
//   roaringbitmap_tpu/ops/pallas_kernels.py:expand_rows_device (:1116)
//     (_expand_rows_jit :1086: array values scatter-added as bit masks,
//     runs as start and stop toggles XORed, prefix-XOR within each word and
//     an exclusive parity across words, bitmap rows copied)
// and computes exactly that function: row rows[i] of the output holds the
// 2048 32-bit words of container i. Array containers come as CSR
// (arr_offsets into arr_values, uint16); bitmap containers as 8 KiB word
// rows; run containers as CSR (run_ends, the inclusive running sum of the
// per-container interval counts, into run_starts and run_lengths, uint16),
// each interval covering [start, start + length]. Every output row holds
// exactly one container, so every row is written whole and the output needs
// no memset.
//
// What bounds it: device-memory bandwidth. Each row is written once, 8 KiB
// (2.52 GB for the census-10k working set's 308,100 rows, ~0.75 ms at
// 3.35 TB/s), and the payload is read once; the bit arithmetic is a few
// instructions a value or interval.
//
// The design: one launch, one CTA of 256 threads per container row, its
// segment (array, bitmap or run) from blockIdx.x against the three counts.
// An array or run row is built in an 8 KiB shared-memory tile, zeroed
// first: array threads stride over the container's values and atomicOr one
// bit each; run threads stride over the intervals, store 0xFFFFFFFF into
// every word strictly inside an interval (sorted disjoint runs never share
// an inner word) and atomicOr the masked edge words (adjacent runs share
// them). The tile then goes out as 512 16-byte stores, neighbouring threads
// on neighbouring addresses. A bitmap row needs no tile: 16-byte loads
// straight from bmp_words, 16-byte stores to the output. Offsets are 64-bit
// throughout: rows * 2048 words passes 2^31 past ~1M rows.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;                 // 32-bit words per container row
constexpr int kVecs = kWords / 4;            // 16-byte vectors per row
constexpr int kThreads = 256;
constexpr int kVecsPerThread = kVecs / kThreads;  // 2

__device__ __forceinline__ void zero_tile(uint32_t* tile) {
  uint4* t4 = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) t4[threadIdx.x + k * kThreads] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void store_tile(const uint32_t* tile, uint4* dst) {
  const uint4* t4 = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) dst[threadIdx.x + k * kThreads] = t4[threadIdx.x + k * kThreads];
}

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(long long n_arr, const long long* __restrict__ arr_rows,
                   const long long* __restrict__ arr_offsets,
                   const uint16_t* __restrict__ arr_values, long long n_bmp,
                   const long long* __restrict__ bmp_rows, const uint4* __restrict__ bmp_words,
                   const long long* __restrict__ run_rows, const long long* __restrict__ run_ends,
                   const uint16_t* __restrict__ run_starts,
                   const uint16_t* __restrict__ run_lengths, uint4* __restrict__ out) {
  __shared__ __align__(16) uint32_t tile[kWords];
  long long i = blockIdx.x;
  if (i >= n_arr && i < n_arr + n_bmp) {  // bitmap: a straight row copy
    i -= n_arr;
    const uint4* src = bmp_words + i * kVecs;
    uint4* dst = out + bmp_rows[i] * kVecs;
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int v = threadIdx.x + k * kThreads;
      dst[v] = __ldg(src + v);
    }
    return;
  }
  zero_tile(tile);
  __syncthreads();
  long long row;
  if (i < n_arr) {  // array: one bit per value
    row = arr_rows[i];
    const long long end = arr_offsets[i + 1];
    for (long long j = arr_offsets[i] + threadIdx.x; j < end; j += kThreads) {
      const uint32_t v = __ldg(arr_values + j);
      atomicOr(tile + (v >> 5), 1u << (v & 31u));
    }
  } else {  // run: inner words stored whole, edge words masked
    i -= n_arr + n_bmp;
    row = run_rows[i];
    const long long end = run_ends[i];
    const long long begin = i ? run_ends[i - 1] : 0;
    for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
      const uint32_t s = __ldg(run_starts + j);
      uint32_t e = s + __ldg(run_lengths + j);  // inclusive
      if (e > 0xFFFFu) e = 0xFFFFu;
      const uint32_t ws = s >> 5, we = e >> 5;
      const uint32_t lo = 0xFFFFFFFFu << (s & 31u);
      const uint32_t hi = 0xFFFFFFFFu >> (31u - (e & 31u));
      if (ws == we) {
        atomicOr(tile + ws, lo & hi);
      } else {
        atomicOr(tile + ws, lo);
        for (uint32_t w = ws + 1; w < we; ++w) tile[w] = 0xFFFFFFFFu;
        atomicOr(tile + we, hi);
      }
    }
  }
  __syncthreads();
  store_tile(tile, out + row * kVecs);
}

}  // namespace

extern "C" {

// arr_rows, arr_offsets (n_arr + 1): int64; arr_values: uint16; bmp_rows:
// int64; bmp_words: n_bmp x 8 KiB, 16-byte aligned; run_rows, run_ends:
// int64 (n_run each); run_starts, run_lengths: uint16; out: n_rows x 2048
// 32-bit words, 16-byte aligned, n_rows = n_arr + n_bmp + n_run.
int rb_expand_rows(int device, long long n_arr, const void* arr_rows, const void* arr_offsets,
                   const void* arr_values, long long n_bmp, const void* bmp_rows,
                   const void* bmp_words, long long n_run, const void* run_rows,
                   const void* run_ends, const void* run_starts, const void* run_lengths,
                   void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_arr < 0 || n_bmp < 0 || n_run < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = n_arr + n_bmp + n_run;
  if (n == 0) return 0;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  expand_rows_kernel<<<static_cast<unsigned>(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_arr, static_cast<const long long*>(arr_rows), static_cast<const long long*>(arr_offsets),
      static_cast<const uint16_t*>(arr_values), n_bmp, static_cast<const long long*>(bmp_rows),
      static_cast<const uint4*>(bmp_words), static_cast<const long long*>(run_rows),
      static_cast<const long long*>(run_ends), static_cast<const uint16_t*>(run_starts),
      static_cast<const uint16_t*>(run_lengths), static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
