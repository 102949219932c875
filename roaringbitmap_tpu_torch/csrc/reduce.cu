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
// and, with a mask (the rows an [S, K] block, row s*K + k counted as
// words[s*K + k] & mask[k]), the BSI sum's masked popcount
//   roaringbitmap_tpu/models/bsi.py:_slice_masked_popcounts
//     ([S, K, 2048] & [K, 2048] -> [S, K], without the [S, K, 2048]
//     temporary the XLA version builds)
//
// What bounds them: both stream every input row from device memory once and
// do one bitwise op (or one popcount) per 4-byte word, far below the card's
// integer rate, so device-memory bandwidth is the bound: live rows * 8192 B
// over 3.35 TB/s. For the masked popcount that is (S + 1) * K rows: the
// slices once and the mask once.
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
// __popc per word, a warp shuffle reduction, then a reduction over the 8
// warps in shared memory.
//
// The masked popcount is chunk-major. It replaces a kernel that ran one
// block per row and read mask row k once for each of the S slices. That
// held the mask in L2 only while K * 8 KiB stayed well under the card's
// 50 MB: a TPC-H SF-100 column's found set is 9,156 chunks, 75 MB, and
// between two reads of a mask row the grid streamed ~150 MB, so each sum
// read the mask S times from device memory, half of its traffic. Here a
// 256-thread CTA owns one chunk k and a group of G consecutive slices:
// it loads mask row k into registers once (two uint4 a thread at 2048
// words), then streams the slice rows s*K + k of its group, four steps of
// loads in flight a thread, ANDs, popcounts and reduces each over its
// warp. The slice rows are read once, so they are loaded evict-first
// (__ldcs) and leave L2 to the mask rows. The warps' counts go to shared
// memory, one slot a (step, warp), and one __syncthreads later the CTA
// writes out[s*K + k] for its G slices, each word once. Rows narrower
// than the CTA (512 and 256 words) are read 2 or 4 side by side, as the
// reduce does. G comes from the host (ops/kernels.py
// masked_popcount_group, a function of S, K and the row width): G = S
// where K CTAs alone give every SM four, so the launch reads (S + 1) * K
// rows; a smaller K gets S / G slice groups a chunk, which read the mask
// S / G - 1 times more, from L2, since the groups of one chunk are
// neighbouring CTAs that run together. Longer CTAs win wherever the card
// is full: each pays its mask load, reduction and barrier once.
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
constexpr int kPopWarps = kPopThreads / 32;
constexpr int kMaxGroup = 256;         // slices a masked CTA walks (ops/kernels.py MAX_GROUP)
constexpr int kStepsInFlight = 4;      // the masked walk's steps loaded before counting
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

// One CTA a (chunk, slice group): blockIdx.x = k * n_groups + group index,
// so the groups of one chunk run side by side and share its mask row in L2.
// NC: the uint4 columns a thread owns of one row (2 at 2048 words, else 1).
// part: [steps][kPopWarps], a warp's count of one slice row; the warps over
// slice j of the group hold part[j * wps + q], q < wps.
template <int NC>
__global__ void __launch_bounds__(kPopThreads)
masked_popcount_kernel(const uint4* __restrict__ words, int vecs, long long n_chunks, int n_slices,
                       int group, const uint4* __restrict__ mask, int* __restrict__ out) {
  extern __shared__ int part[];
  const int n_groups = (n_slices + group - 1) / group;
  const long long k = blockIdx.x / n_groups;
  const int s0 = static_cast<int>(blockIdx.x % n_groups) * group;
  const int s_end = min(n_slices, s0 + group);
  const int span = min(vecs, kPopThreads);  // threads over one row
  const int side = kPopThreads / span;      // rows read side by side
  const int col = threadIdx.x % span;
  const int sub = threadIdx.x / span;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4 m[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) m[j] = mask[k * vecs + col + j * kPopThreads];
  const int steps = (s_end - s0 + side - 1) / side;
  for (int i0 = 0; i0 < steps; i0 += kStepsInFlight) {
    uint4 v[kStepsInFlight][NC];
#pragma unroll
    for (int u = 0; u < kStepsInFlight; ++u) {
      const int s = s0 + (i0 + u) * side + sub;
      const uint4* p = words + (s * n_chunks + k) * vecs + col;
#pragma unroll
      for (int j = 0; j < NC; ++j) v[u][j] = s < s_end ? __ldcs(p + j * kPopThreads) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kStepsInFlight; ++u) {
      if (i0 + u >= steps) break;  // the same for every thread of the CTA
      int c = 0;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        c += __popc(v[u][j].x & m[j].x) + __popc(v[u][j].y & m[j].y) +
             __popc(v[u][j].z & m[j].z) + __popc(v[u][j].w & m[j].w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
      if (lane == 0) part[(i0 + u) * kPopWarps + warp] = c;
    }
  }
  __syncthreads();
  const int wps = span / 32;  // warps over one row
  for (int j = threadIdx.x; j < s_end - s0; j += kPopThreads) {
    int c = 0;
    for (int q = 0; q < wps; ++q) c += part[j * wps + q];
    out[(s0 + j) * n_chunks + k] = c;
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

// words: n_rows x row_words words (row_words 2048, 1024, 512 or 256); out:
// n_rows int32 popcounts. mask: null, or mask_rows (K) x row_words words
// with K dividing n_rows, the rows then an [S, K] block and row s*K + k
// counted as words[s*K + k] & mask[k]; group: the slices one CTA walks under
// one mask row, 1 to min(S, 256) (ignored without a mask).
int rb_popcount_rows(int device, const void* words, long long n_rows, int row_words,
                     const void* mask, long long mask_rows, int group, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!row_width_ok(row_words)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  if (n_rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vecs = row_words / 4;
  if (mask == nullptr) {
    popcount_rows_kernel<false><<<static_cast<unsigned>(n_rows), kPopThreads, 0, s>>>(
        static_cast<const uint4*>(words), vecs, nullptr, 1, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if (mask_rows <= 0 || n_rows % mask_rows) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slices = n_rows / mask_rows;
  if (group < 1 || group > kMaxGroup || group > n_slices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_groups = (n_slices + group - 1) / group;
  const int side = kPopThreads / (vecs < kPopThreads ? vecs : kPopThreads);
  const size_t smem = static_cast<size_t>((group + side - 1) / side) * kPopWarps * sizeof(int);
  const unsigned grid = static_cast<unsigned>(mask_rows * n_groups);
  if (vecs > kPopThreads) {
    masked_popcount_kernel<2><<<grid, kPopThreads, smem, s>>>(
        static_cast<const uint4*>(words), vecs, mask_rows, static_cast<int>(n_slices), group,
        static_cast<const uint4*>(mask), static_cast<int*>(out));
  } else {
    masked_popcount_kernel<1><<<grid, kPopThreads, smem, s>>>(
        static_cast<const uint4*>(words), vecs, mask_rows, static_cast<int>(n_slices), group,
        static_cast<const uint4*>(mask), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
