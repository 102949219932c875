// Hand-written Hopper (sm_90a) kernel of the columnar pairwise engine.
//
// rb_pair_rows replaces the XLA function the JAX package runs for the
// device tier's word-parallel classes:
//   roaringbitmap_tpu/ops/pallas_kernels.py:pair_rows_reduce (:985)
//     (_pair_rows_jit :962: gather rows_a[ia] and rows_b[ib], apply
//     and / or / xor / andnot, popcount every row, one jitted dispatch)
// and computes exactly that function: for pair j, the op of row ia[j] of
// rows_a and row ib[j] of rows_b is written to out[j] and its popcount to
// cards[j]. An index outside its block reads a zero row, as the JAX
// function's take(mode="fill") does (the port's callers check every index
// on the host, so on the main path none is).
//
// What bounds it: every pair reads two 8 KiB rows and writes one, so
// device-memory bandwidth sets the floor, (2 + 1) x 8 KiB a pair over
// 3.35 TB/s; the popcount is one instruction a word, far below the card's
// integer rate.
//
// The design, simple first: one CTA of 128 threads per pair. Each thread
// owns four 16-byte vectors of the row (neighbouring threads on
// neighbouring addresses, so each warp load is 512 contiguous bytes) and
// issues all eight loads of both sides before it uses any, so a resident
// SM keeps 16 CTAs x 128 threads x 128 bytes in flight. The result streams
// out with cache-streaming stores (it is read next by the host copy, not
// by this kernel). The row's popcount is a warp shuffle sum and a sum of
// the four warps' partials in shared memory; one thread writes cards[j].
//
// Counts-only mode (a null out): the same kernel, instantiated with the
// stores compiled out, writes cards alone. It replaces the XLA function
//   roaringbitmap_tpu/parallel/batch.py:_step (:63, cards_only=True)
// (mask a [Q, K, 2048] batch against a [K, 2048] filter with and or andnot
// and popcount each (query, key)): rows_a is the flat batch with ia = q*K
// + k, rows_b the filter with ib = k, and kAndNot is batch & ~filter.
// Bound: the batch read once (the K filter rows stay in L2), Q*K*8 KiB
// over 3.35 TB/s.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;                 // 32-bit words per container row
constexpr int kVecs = kWords / 4;            // 16-byte vectors per row
constexpr int kThreads = 128;
constexpr int kPerThread = kVecs / kThreads; // 4
constexpr int kWarps = kThreads / 32;

enum PairOp { kAnd = 0, kOr = 1, kXor = 2, kAndNot = 3 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == kAnd) return a & b;
  if (OP == kOr) return a | b;
  if (OP == kXor) return a ^ b;
  return a & ~b;
}

template <int OP, bool kRows>
__global__ void __launch_bounds__(kThreads)
pair_rows_kernel(const uint4* __restrict__ rows_a, long long na, const int* __restrict__ ia,
                 const uint4* __restrict__ rows_b, long long nb, const int* __restrict__ ib,
                 uint4* __restrict__ out, int* __restrict__ cards) {
  __shared__ int warp_sums[kWarps];
  const long long j = blockIdx.x;
  const long long ra = ia[j], rb = ib[j];
  const bool va = ra >= 0 && ra < na;
  const bool vb = rb >= 0 && rb < nb;
  const uint4* pa = rows_a + (va ? ra : 0) * kVecs;
  const uint4* pb = rows_b + (vb ? rb : 0) * kVecs;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 a[kPerThread], b[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    a[k] = va ? __ldg(pa + v) : zero;
    b[k] = vb ? __ldg(pb + v) : zero;
  }
  uint4* po = kRows ? out + j * kVecs : nullptr;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    uint4 r;
    r.x = apply<OP>(a[k].x, b[k].x);
    r.y = apply<OP>(a[k].y, b[k].y);
    r.z = apply<OP>(a[k].z, b[k].z);
    r.w = apply<OP>(a[k].w, b[k].w);
    n += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
    if (kRows) __stcs(po + threadIdx.x + k * kThreads, r);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xFFFFFFFFu, n, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    cards[j] = total;
  }
}

template <int OP, bool kRows>
void launch_pair_rows_as(const void* rows_a, long long na, const void* ia, const void* rows_b,
                         long long nb, const void* ib, long long n, void* out, void* cards,
                         cudaStream_t stream) {
  pair_rows_kernel<OP, kRows><<<static_cast<unsigned>(n), kThreads, 0, stream>>>(
      static_cast<const uint4*>(rows_a), na, static_cast<const int*>(ia),
      static_cast<const uint4*>(rows_b), nb, static_cast<const int*>(ib),
      static_cast<uint4*>(out), static_cast<int*>(cards));
}

template <int OP>
void launch_pair_rows(const void* rows_a, long long na, const void* ia, const void* rows_b,
                      long long nb, const void* ib, long long n, void* out, void* cards,
                      cudaStream_t stream) {
  if (out == nullptr)
    launch_pair_rows_as<OP, false>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, stream);
  else
    launch_pair_rows_as<OP, true>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, stream);
}

}  // namespace

extern "C" {

// op: 0 and, 1 or, 2 xor, 3 andnot (a & ~b). rows_a: na x 2048 words;
// rows_b: nb x 2048 words (both 16-byte aligned); ia, ib: n int32 row
// indices; out: n x 2048 words, or null for the counts alone; cards: n int32.
int rb_pair_rows(int device, int op, const void* rows_a, long long na, const void* ia,
                 const void* rows_b, long long nb, const void* ib, long long n, void* out,
                 void* cards, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (n > 0x7FFFFFFFLL || na < 0 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAnd:
      launch_pair_rows<kAnd>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, s);
      break;
    case kOr:
      launch_pair_rows<kOr>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, s);
      break;
    case kXor:
      launch_pair_rows<kXor>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, s);
      break;
    case kAndNot:
      launch_pair_rows<kAndNot>(rows_a, na, ia, rows_b, nb, ib, n, out, cards, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
