// Hand-written Hopper (sm_90a) kernel of the all-pairs overlap matrix.
//
// rb_pairwise_and_card replaces the two XLA functions the JAX package runs
// for pairwise_and_cardinality:
//   roaringbitmap_tpu/parallel/batch.py:_pairwise_step (:184)
//     (broadcast AND of [nb, K, 2048] against [m, K, 2048] word rows and a
//     popcount per (pair, key), summed over the keys on the host)
//   roaringbitmap_tpu/parallel/batch.py:_pairwise_mxu_step (:211)
//     (the same counts as 0/1 bf16 matrix products, one per key, summed in
//     int32)
// and computes that function exactly: out[i][j] = sum over the K * 2048
// words w of popcount(left[i][w] & right[j][w]), as int64 (a pair may pass
// 2^32 when K is large).
//
// What bounds it: the work is n * m * K * 2048 word AND-popcounts, far
// above the bytes (both sides read once and the n x m int64 written once).
// At the census working set (10,000 x 10,000 bitmaps, 31 keys) that is
// 6.35e12 words: on the int8 tensor cores (0/1 bits, 2 * n * m * K * 65536
// operations at 1,979 TOPS) ~0.21 s, which is the function's bound; on the
// CUDA cores this design is held to the popcount rate, 16 a clock per SM
// (132 SMs at 1.98 GHz), ~1.52 s.
//
// The design, simple first: a tiled "GEMM" with AND-popcount in place of
// multiply-add. One CTA of 256 threads computes a 64 x 64 tile of pairs;
// each thread owns a 4 x 4 micro-tile (rows ty + 16 i, columns tx + 16 j,
// so a warp's shared-memory reads are broadcasts on the left and
// conflict-free on the right). The CTA walks the flattened K * 2048 word
// axis in slabs of 32 words: both sides' 64 rows of the slab are staged in
// shared memory (rows padded to 36 words, 16-byte aligned), and the next
// slab is loaded into registers while the current one is counted. Counts
// accumulate in uint32 within a key (at most 65,536 a pair) and fold into
// uint64 at each key boundary. Rows past n or m read as zeros and their
// pairs are not written. Offsets are 64-bit: n * m and n * K * 2048 pass
// 2^31 at the census scale.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;                       // 32-bit words per key and row
constexpr int kTile = 64;                          // pairs a CTA covers on each side
constexpr int kThreads = 256;
constexpr int kSide = 16;                          // threads along each side of the tile
constexpr int kMicro = kTile / kSide;              // 4 rows and 4 columns a thread
constexpr int kSlab = 32;                          // words of each row a slab stages
constexpr int kStride = kSlab + 4;                 // padded row in shared memory (words)
constexpr int kSlabVecs = kSlab / 4;               // 16-byte vectors of a row's slab
constexpr int kLoads = kTile * kSlabVecs / kThreads;  // vectors a thread loads a side
constexpr int kSlabsPerKey = kWords / kSlab;       // 64
constexpr long long kMaxTiles = 65535;             // gridDim.y limit

static_assert(kSide * kSide == kThreads, "one thread per micro-tile");
static_assert(kTile * kSlabVecs % kThreads == 0, "whole vectors per thread");

__global__ void __launch_bounds__(kThreads)
pairwise_and_card_kernel(const uint4* __restrict__ left, long long n,
                         const uint4* __restrict__ right, long long m, long long n_keys,
                         unsigned long long* __restrict__ out) {
  __shared__ __align__(16) uint32_t sa[kTile * kStride];
  __shared__ __align__(16) uint32_t sb[kTile * kStride];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long row_vecs = n_keys * (kWords / 4);  // 16-byte vectors of an input row

  // this thread's share of each slab: vector v of the tile's 64 x 8, i.e.
  // row v / 8, vector v % 8 of that row's slab
  const uint4* pa[kLoads];
  const uint4* pb[kLoads];
  bool va[kLoads], vb[kLoads];
  int soff[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int lr = v / kSlabVecs, lv = v % kSlabVecs;
    va[r] = row0 + lr < n;
    vb[r] = col0 + lr < m;
    pa[r] = left + (va[r] ? row0 + lr : 0) * row_vecs + lv;
    pb[r] = right + (vb[r] ? col0 + lr : 0) * row_vecs + lv;
    soff[r] = lr * kStride + lv * 4;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra[kLoads], rb[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    ra[r] = va[r] ? __ldg(pa[r]) : zero;
    rb[r] = vb[r] ? __ldg(pb[r]) : zero;
  }

  uint32_t acc[kMicro][kMicro];
  unsigned long long total[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      acc[i][j] = 0u;
      total[i][j] = 0ull;
    }

  const long long n_slabs = n_keys * kSlabsPerKey;
  for (long long s = 0; s < n_slabs; ++s) {
    __syncthreads();  // every thread is done reading the previous slab
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      *reinterpret_cast<uint4*>(sa + soff[r]) = ra[r];
      *reinterpret_cast<uint4*>(sb + soff[r]) = rb[r];
    }
    __syncthreads();
    if (s + 1 < n_slabs) {
      const long long next = (s + 1) * kSlabVecs;
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        ra[r] = va[r] ? __ldg(pa[r] + next) : zero;
        rb[r] = vb[r] ? __ldg(pb[r] + next) : zero;
      }
    }
#pragma unroll
    for (int w = 0; w < kSlab; w += 4) {
      uint4 a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        a[i] = *reinterpret_cast<const uint4*>(sa + (ty + kSide * i) * kStride + w);
        b[i] = *reinterpret_cast<const uint4*>(sb + (tx + kSide * i) * kStride + w);
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] += __popc(a[i].x & b[j].x) + __popc(a[i].y & b[j].y) +
                       __popc(a[i].z & b[j].z) + __popc(a[i].w & b[j].w);
    }
    if ((s + 1) % kSlabsPerKey == 0) {  // key boundary: fold before uint32 can wrap
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          total[i][j] += acc[i][j];
          acc[i][j] = 0u;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long r = row0 + ty + kSide * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long c = col0 + tx + kSide * j;
      if (c < m) out[r * m + c] = total[i][j];
    }
  }
}

}  // namespace

extern "C" {

// left: n x n_keys x 2048 words; right: m x n_keys x 2048 words (both
// 16-byte aligned); out: n x m int64, row-major.
int rb_pairwise_and_card(int device, const void* left, long long n, const void* right,
                         long long m, long long n_keys, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || m <= 0) return 0;
  if (n_keys <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_n = (n + kTile - 1) / kTile;
  const long long tiles_m = (m + kTile - 1) / kTile;
  if (tiles_n > kMaxTiles || tiles_m > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles_m), static_cast<unsigned>(tiles_n));
  pairwise_and_card_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(left), n, static_cast<const uint4*>(right), m, n_keys,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
