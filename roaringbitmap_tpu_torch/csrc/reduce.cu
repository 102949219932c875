// Hand-written Hopper (sm_90a) kernels of the N-way aggregation path.
//
// rb_group_reduce<op> replaces the two Pallas kernels the JAX package runs
// on this path:
//   roaringbitmap_tpu/ops/pallas_kernels.py:grouped_reduce_pallas
//     (padded [G, M, 2048] -> [G, 2048]; also the bucketed layout's per-bucket
//     engine and, with a row map, the cold fused gather of
//     fused_gather_reduce)
//   roaringbitmap_tpu/ops/pallas_kernels.py:segmented_reduce_pallas
//     (skewed layout; its caller reads only the segment-end rows, so here it
//     is a segmented reduce over group offsets that writes [G, 2048])
// rb_popcount_rows replaces the XLA popcount epilogue
//   roaringbitmap_tpu/ops/device.py:popcount_rows
//
// What bounds them: both stream every input row from device memory once and
// do one bitwise op (or one popcount) per 4-byte word, far below the card's
// integer rate, so device-memory bandwidth is the bound: live rows * 8192 B
// over 3.35 TB/s.
//
// What the design does about it. The Pallas kernels carry an accumulator in
// VMEM across a sequential grid; Hopper's grid is parallel and unordered, so
// instead the host cuts every segment into chunks of at most R rows (the
// chunk table: group, begin, end) and one CTA folds one chunk. A long
// segment therefore spreads over many CTAs and all SMs stay busy even when
// G is small (the main path has G = 31 and ~10,000 rows per group). Each
// CTA has 512 threads; thread t owns the 16-byte column t of the 8 KiB row,
// so a warp's loads are 512 contiguous bytes (fully coalesced uint4 loads),
// and each thread keeps four rows in flight before folding them into its
// register accumulator. The chunk partials are combined into out[g] with
// atomicOr / atomicAnd / atomicXor; the caller initialises out to the op
// identity. Bitwise atomics are associative and commutative and drop no
// bits, so — unlike float atomics — the result is exact and identical from
// run to run whatever order the CTAs finish in. A partial equal to the
// identity is not sent at all.
//
// The row map (cold fused gather): logical row r reads words row
// row_map[r]; a value >= n_rows is an identity pad and is skipped, so the
// padded [G, M, 2048] block is never built.
//
// The popcount runs one 256-thread block per row: __popc per word, a warp
// shuffle reduction, then a reduction over the 8 warps in shared memory.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, every entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;           // 32-bit words per container row
constexpr int kVecs = kWords / 4;      // uint4 columns per row
constexpr int kReduceThreads = kVecs;  // thread t owns column t
constexpr int kPopThreads = 256;
constexpr int kInFlight = 4;           // rows loaded before folding

enum Op { kOr = 0, kAnd = 1, kXor = 2 };

template <int OP>
__device__ __forceinline__ uint32_t identity() {
  return OP == kAnd ? 0xFFFFFFFFu : 0u;
}

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == kOr) return a | b;
  if (OP == kAnd) return a & b;
  return a ^ b;
}

template <int OP>
__device__ __forceinline__ uint4 apply4(uint4 a, uint4 b) {
  return make_uint4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y),
                    apply<OP>(a.z, b.z), apply<OP>(a.w, b.w));
}

template <int OP, bool ROW_MAP>
__device__ __forceinline__ uint4 fetch(const uint4* __restrict__ words,
                                       long long n_rows,
                                       const long long* __restrict__ row_map,
                                       long long r, int t) {
  long long src = r;
  if (ROW_MAP) {
    src = row_map[r];
    if (src >= n_rows) {
      const uint32_t id = identity<OP>();
      return make_uint4(id, id, id, id);
    }
  }
  return words[src * kVecs + t];
}

template <int OP>
__device__ __forceinline__ void combine(uint32_t* p, uint32_t v) {
  if (v == identity<OP>()) return;
  if (OP == kOr) {
    atomicOr(p, v);
  } else if (OP == kAnd) {
    atomicAnd(p, v);
  } else {
    atomicXor(p, v);
  }
}

template <int OP, bool ROW_MAP>
__global__ void __launch_bounds__(kReduceThreads)
group_reduce_kernel(const uint4* __restrict__ words, long long n_rows,
                    const long long* __restrict__ chunks,
                    const long long* __restrict__ row_map,
                    uint32_t* __restrict__ out) {
  const long long* ch = chunks + 3LL * blockIdx.x;
  const long long g = ch[0];
  const long long end = ch[2];
  long long r = ch[1];
  const int t = threadIdx.x;
  const uint32_t id = identity<OP>();
  uint4 acc = make_uint4(id, id, id, id);
  for (; r + kInFlight <= end; r += kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      v[k] = fetch<OP, ROW_MAP>(words, n_rows, row_map, r + k, t);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) acc = apply4<OP>(acc, v[k]);
  }
  for (; r < end; ++r) {
    acc = apply4<OP>(acc, fetch<OP, ROW_MAP>(words, n_rows, row_map, r, t));
  }
  uint32_t* o = out + g * kWords + 4 * t;
  combine<OP>(o + 0, acc.x);
  combine<OP>(o + 1, acc.y);
  combine<OP>(o + 2, acc.z);
  combine<OP>(o + 3, acc.w);
}

__global__ void __launch_bounds__(kPopThreads)
popcount_rows_kernel(const uint4* __restrict__ words, int* __restrict__ out) {
  const long long row = blockIdx.x;
  const uint4* p = words + row * kVecs;
  int c = 0;
  for (int i = threadIdx.x; i < kVecs; i += kPopThreads) {
    const uint4 v = p[i];
    c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  __shared__ int warp_sums[kPopThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < kPopThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if (lane == 0) out[row] = c;
  }
}

template <int OP, bool ROW_MAP>
void launch_group_reduce(const void* words, long long n_rows, const void* chunks,
                         long long n_chunks, const void* row_map, void* out,
                         cudaStream_t stream) {
  group_reduce_kernel<OP, ROW_MAP><<<static_cast<unsigned>(n_chunks), kReduceThreads, 0, stream>>>(
      static_cast<const uint4*>(words), n_rows,
      static_cast<const long long*>(chunks),
      static_cast<const long long*>(row_map), static_cast<uint32_t*>(out));
}

}  // namespace

extern "C" {

// words: n_rows x 2048 words; chunks: n_chunks x 3 int64 (group, begin, end)
// over logical rows; row_map: int64 per logical row, or null; out: G x 2048
// words already holding the op identity. op: 0 or, 1 and, 2 xor.
int rb_group_reduce(int device, int op, const void* words, long long n_rows,
                    const void* chunks, long long n_chunks, const void* row_map,
                    void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks <= 0) return 0;
  if (n_chunks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rm = row_map != nullptr;
  switch (op) {
    case kOr:
      if (rm) launch_group_reduce<kOr, true>(words, n_rows, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kOr, false>(words, n_rows, chunks, n_chunks, row_map, out, s);
      break;
    case kAnd:
      if (rm) launch_group_reduce<kAnd, true>(words, n_rows, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kAnd, false>(words, n_rows, chunks, n_chunks, row_map, out, s);
      break;
    case kXor:
      if (rm) launch_group_reduce<kXor, true>(words, n_rows, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kXor, false>(words, n_rows, chunks, n_chunks, row_map, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: n_rows x 2048 words; out: n_rows int32 popcounts.
int rb_popcount_rows(int device, const void* words, long long n_rows, void* out,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0) return 0;
  if (n_rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  popcount_rows_kernel<<<static_cast<unsigned>(n_rows), kPopThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* rb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
