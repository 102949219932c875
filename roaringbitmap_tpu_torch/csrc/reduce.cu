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
// and, with a mask (row r counted as words[r] & mask[r % mask_rows]), the
// BSI sum's masked popcount
//   roaringbitmap_tpu/models/bsi.py:_slice_masked_popcounts
//     ([S, K, 2048] & [K, 2048] -> [S, K], without the [S, K, 2048]
//     temporary the XLA version builds; the mask rows are re-read S times
//     but stay in L2)
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
// Row width. A row is 2048 words on a single card; a mesh that splits the
// word axis over a "words" dimension hands each rank rows of 2048 / nw words
// (1024, 512 or 256), a runtime argument. The launch geometry stays that of
// the 2048-word row: 512 threads a CTA, each owning one 16-byte column of
// 2048 / W rows side by side, so a warp's loads stay contiguous (adjacent
// rows are adjacent in memory) and no thread idles. A chunk's rows are
// walked W / 2048 rows of the CTA at a time; at W = 2048 that is the
// original one-row walk, unchanged. Threads that share a column combine
// into the same output word by the same atomics.
//
// The row map (cold fused gather): logical row r reads words row
// row_map[r]; a value >= n_rows is an identity pad and is skipped, so the
// padded [G, M, 2048] block is never built.
//
// The popcount runs one 256-thread block per row (of any of the widths):
// __popc per word (of the word and its mask word when masked), a warp
// shuffle reduction, then a reduction over the 8 warps in shared memory.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, every entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;           // 32-bit words per container row
constexpr int kVecs = kWords / 4;      // uint4 columns of a full row
constexpr int kReduceThreads = kVecs;  // a CTA covers 2048 words of rows
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

// true for the widths a row may have: 2048, 1024, 512 and 256 words
__host__ __device__ inline bool row_width_ok(int row_words) {
  return row_words == 2048 || row_words == 1024 || row_words == 512 || row_words == 256;
}

template <int OP, bool ROW_MAP>
__device__ __forceinline__ uint4 fetch(const uint4* __restrict__ words,
                                       long long n_rows, int vecs,
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
  return words[src * vecs + t];
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

// vecs: uint4 columns a row (row_words / 4); thread t owns column
// t % vecs of the chunk's rows begin + t / vecs, stepping kVecs / vecs rows
template <int OP, bool ROW_MAP>
__global__ void __launch_bounds__(kReduceThreads)
group_reduce_kernel(const uint4* __restrict__ words, long long n_rows, int vecs,
                    const long long* __restrict__ chunks,
                    const long long* __restrict__ row_map,
                    uint32_t* __restrict__ out) {
  const long long* ch = chunks + 3LL * blockIdx.x;
  const long long g = ch[0];
  const long long end = ch[2];
  const int col = threadIdx.x % vecs;
  const int step = kVecs / vecs;  // rows the CTA reads side by side
  long long r = ch[1] + threadIdx.x / vecs;
  const uint32_t id = identity<OP>();
  uint4 acc = make_uint4(id, id, id, id);
  for (; r + (kInFlight - 1) * step < end; r += kInFlight * step) {
    uint4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      v[k] = fetch<OP, ROW_MAP>(words, n_rows, vecs, row_map, r + k * step, col);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) acc = apply4<OP>(acc, v[k]);
  }
  for (; r < end; r += step) {
    acc = apply4<OP>(acc, fetch<OP, ROW_MAP>(words, n_rows, vecs, row_map, r, col));
  }
  uint32_t* o = out + g * (4LL * vecs) + 4 * col;
  combine<OP>(o + 0, acc.x);
  combine<OP>(o + 1, acc.y);
  combine<OP>(o + 2, acc.z);
  combine<OP>(o + 3, acc.w);
}

template <bool MASKED>
__global__ void __launch_bounds__(kPopThreads)
popcount_rows_kernel(const uint4* __restrict__ words, int vecs, const uint4* __restrict__ mask,
                     long long mask_rows, int* __restrict__ out) {
  const long long row = blockIdx.x;
  const uint4* p = words + row * vecs;
  const uint4* m = MASKED ? mask + (row % mask_rows) * vecs : nullptr;
  int c = 0;
  for (int i = threadIdx.x; i < vecs; i += kPopThreads) {
    uint4 v = p[i];
    if (MASKED) {
      const uint4 mv = m[i];
      v = make_uint4(v.x & mv.x, v.y & mv.y, v.z & mv.z, v.w & mv.w);
    }
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
void launch_group_reduce(const void* words, long long n_rows, int vecs, const void* chunks,
                         long long n_chunks, const void* row_map, void* out,
                         cudaStream_t stream) {
  group_reduce_kernel<OP, ROW_MAP><<<static_cast<unsigned>(n_chunks), kReduceThreads, 0, stream>>>(
      static_cast<const uint4*>(words), n_rows, vecs,
      static_cast<const long long*>(chunks),
      static_cast<const long long*>(row_map), static_cast<uint32_t*>(out));
}

}  // namespace

extern "C" {

// words: n_rows x row_words words (row_words 2048, 1024, 512 or 256);
// chunks: n_chunks x 3 int64 (group, begin, end) over logical rows;
// row_map: int64 per logical row, or null; out: G x row_words words already
// holding the op identity. op: 0 or, 1 and, 2 xor.
int rb_group_reduce(int device, int op, const void* words, long long n_rows, int row_words,
                    const void* chunks, long long n_chunks, const void* row_map,
                    void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!row_width_ok(row_words)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks <= 0) return 0;
  if (n_chunks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rm = row_map != nullptr;
  const int v = row_words / 4;
  switch (op) {
    case kOr:
      if (rm) launch_group_reduce<kOr, true>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kOr, false>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      break;
    case kAnd:
      if (rm) launch_group_reduce<kAnd, true>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kAnd, false>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      break;
    case kXor:
      if (rm) launch_group_reduce<kXor, true>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      else launch_group_reduce<kXor, false>(words, n_rows, v, chunks, n_chunks, row_map, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: n_rows x row_words words (row_words 2048, 1024, 512 or 256); mask:
// mask_rows x row_words words or null (row r is counted as words[r] &
// mask[r % mask_rows]); out: n_rows int32 popcounts.
int rb_popcount_rows(int device, const void* words, long long n_rows, int row_words,
                     const void* mask, long long mask_rows, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!row_width_ok(row_words)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  if (n_rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr && mask_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) {
    popcount_rows_kernel<true><<<grid, kPopThreads, 0, s>>>(
        static_cast<const uint4*>(words), row_words / 4, static_cast<const uint4*>(mask), mask_rows,
        static_cast<int*>(out));
  } else {
    popcount_rows_kernel<false><<<grid, kPopThreads, 0, s>>>(
        static_cast<const uint4*>(words), row_words / 4, nullptr, 1, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
