// Hand-written Hopper (sm_90a) kernel of the BSI range-query path.
//
// rb_oneil_compare<op> replaces, on this path:
//   roaringbitmap_tpu/ops/pallas_kernels.py:oneil_compare_pallas
//     (the fused O'Neil compare, one query: [S, K, 2048] slices, the
//     predicate bits, [K, 2048] ebm and fixed words -> [K, 2048] result
//     words and [K] popcounts; RANGE as a dual walk)
//   roaringbitmap_tpu/models/bsi.py:_o_neil_counts_batched
//     (the XLA vmap of o_neil_math over a [Q, S] or [Q, 2, S] predicate
//     axis, count-only -> [Q, K] popcounts)
//
// What bounds it: each slice word is read once per query and takes three to
// five bitwise ops, far below the card's integer rate, so device-memory
// bandwidth is the bound. One compare reads S*K*8 KiB of slices plus the ebm
// and fixed words and writes the result words and K cards: 437.5 MB, 0.1306
// ms at 3.35 TB/s for the 100M-row, 32-slice index (K = 1526); count-only,
// or with no found set (fixed is the ebm, read once), 425.0 MB, 0.1269 ms.
// A batch of Q count-only queries needs the same single pass over the slices
// (412.9 MB, 0.1233 ms, with no found set).
//
// What the design does about it. One CTA per (query, key chunk), 512
// threads; thread t owns the 16-byte column t of the chunk's 8 KiB row and
// carries GT, LT and EQ (plus LT2 and EQ2 of the second walk for RANGE) in
// registers over the S slices, from the highest slice down. The slice loads
// do not depend on the walk's state, so kInFlight of them are issued before
// the first is used; a warp's loads are 512 contiguous bytes. The predicate
// bits arrive as a small int32 device array [Q, W, S] (W = 2 for RANGE), not
// as a kernel argument, because an index can hold more than 64 slices; each
// CTA turns its query's bits into all-ones / all-zero masks in shared memory,
// so the walk is branch-free:
//   lt |= m & eq & ~s;   gt |= ~m & eq & s;   eq &= ~(s ^ m).
// Each CTA reduces its own row's popcount (warp shuffles, then the 16 warp
// sums in shared memory) and writes cards[q, k] without atomics.
//
// Batched queries: the block index runs over queries fastest, so the Q CTAs
// of one key chunk are resident together and read the same S * 8 KiB of
// slices; L2 (50 MB) serves all but the first of those reads, which holds the
// device-memory traffic near one pass over the slices. Staging a slice tile
// in shared memory and running all Q walks on it is the later redesign.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;       // 32-bit words per container row
constexpr int kVecs = kWords / 4;  // uint4 columns per row
constexpr int kThreads = kVecs;    // thread t owns column t
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 8;       // slice loads issued before the walk uses them

enum Op { kEq = 0, kNeq = 1, kGt = 2, kLt = 3, kLe = 4, kGe = 5, kRange = 6 };

// O'Neil state of one walk over four words; m is the predicate bit of the
// current slice as an all-ones or all-zero mask.
struct Walk {
  uint32_t gt[4];
  uint32_t lt[4];
  uint32_t eq[4];
};

template <bool WANT_GT, bool WANT_LT>
__device__ __forceinline__ void step(Walk& w, const uint4 s4, uint32_t m) {
  const uint32_t s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (WANT_LT) w.lt[c] |= m & w.eq[c] & ~s[c];
    if (WANT_GT) w.gt[c] |= ~m & w.eq[c] & s[c];
    w.eq[c] &= ~(s[c] ^ m);
  }
}

template <int OP>
__device__ __forceinline__ void step_all(Walk& w1, Walk& w2, const uint4 s,
                                         const uint32_t* masks, int n_slices, int j) {
  if (OP == kRange) {
    step<true, false>(w1, s, masks[j]);             // GE lo: GT and EQ
    step<false, true>(w2, s, masks[n_slices + j]);  // LE hi: LT and EQ
  } else {
    step<OP == kGt || OP == kGe, OP == kLt || OP == kLe>(w1, s, masks[j]);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
oneil_kernel(const uint4* __restrict__ slices, int n_slices, long long n_keys,
             const int* __restrict__ bits, int n_queries,
             const uint4* __restrict__ ebm, const uint4* __restrict__ fixed,
             uint4* __restrict__ out, int* __restrict__ cards) {
  constexpr int W = OP == kRange ? 2 : 1;
  extern __shared__ uint32_t masks[];  // [W * n_slices]
  __shared__ int warp_sums[kWarps];
  const long long b = blockIdx.x;
  const int q = static_cast<int>(b % n_queries);
  const long long k = b / n_queries;
  const int t = threadIdx.x;

  const int* qbits = bits + static_cast<long long>(q) * W * n_slices;
  for (int i = t; i < W * n_slices; i += kThreads) masks[i] = qbits[i] ? 0xFFFFFFFFu : 0u;
  __syncthreads();

  const uint4 e = ebm[k * kVecs + t];
  Walk w1, w2;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w1.gt[c] = w1.lt[c] = w2.gt[c] = w2.lt[c] = 0u;
  }
  w1.eq[0] = w2.eq[0] = e.x;
  w1.eq[1] = w2.eq[1] = e.y;
  w1.eq[2] = w2.eq[2] = e.z;
  w1.eq[3] = w2.eq[3] = e.w;

  // walk position j reads slice n_slices - 1 - j (highest bit first), as
  // the predicate bits are ordered
  const long long stride = n_keys * kVecs;
  const uint4* col = slices + k * kVecs + t + static_cast<long long>(n_slices - 1) * stride;
  int j = 0;
  for (; j + kInFlight <= n_slices; j += kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) v[u] = col[-static_cast<long long>(j + u) * stride];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) step_all<OP>(w1, w2, v[u], masks, n_slices, j + u);
  }
  for (; j < n_slices; ++j) {
    step_all<OP>(w1, w2, col[-static_cast<long long>(j) * stride], masks, n_slices, j);
  }

  const uint4 f4 = fixed[k * kVecs + t];
  const uint32_t f[4] = {f4.x, f4.y, f4.z, f4.w};
  uint32_t o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t eq = w1.eq[c];
    if (OP == kEq) o[c] = eq & f[c];
    else if (OP == kNeq) o[c] = f[c] & ~eq;
    else if (OP == kGt) o[c] = w1.gt[c] & f[c];
    else if (OP == kLt) o[c] = w1.lt[c] & f[c];
    else if (OP == kLe) o[c] = (w1.lt[c] | eq) & f[c];
    else if (OP == kGe) o[c] = (w1.gt[c] | eq) & f[c];
    else o[c] = (w1.gt[c] | eq) & (w2.lt[c] | w2.eq[c]) & f[c];
  }
  if (out != nullptr) out[k * kVecs + t] = make_uint4(o[0], o[1], o[2], o[3]);

  int c = __popc(o[0]) + __popc(o[1]) + __popc(o[2]) + __popc(o[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if (lane == 0) cards[static_cast<long long>(q) * n_keys + k] = c;
  }
}

template <int OP>
void launch(const void* slices, int n_slices, long long n_keys, const void* bits,
            int n_queries, const void* ebm, const void* fixed, void* out, void* cards,
            long long n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (OP == kRange ? 2 : 1) * static_cast<size_t>(n_slices);
  oneil_kernel<OP><<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      static_cast<const uint4*>(slices), n_slices, n_keys, static_cast<const int*>(bits),
      n_queries, static_cast<const uint4*>(ebm), static_cast<const uint4*>(fixed),
      static_cast<uint4*>(out), static_cast<int*>(cards));
}

}  // namespace

extern "C" {

// slices: n_slices x n_keys x 2048 words; bits: int32 n_queries x W x
// n_slices (W = 2 for RANGE, lo walk first; position j is slice
// n_slices - 1 - j); ebm, fixed: n_keys x 2048 words; out: n_keys x 2048
// words, or null for count-only (n_queries must be 1 otherwise); cards:
// int32 n_queries x n_keys. op: 0 EQ, 1 NEQ, 2 GT, 3 LT, 4 LE, 5 GE, 6 RANGE.
int rb_oneil_compare(int device, int op, const void* slices, int n_slices, long long n_keys,
                     const void* bits, int n_queries, const void* ebm, const void* fixed,
                     void* out, void* cards, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_keys <= 0 || n_queries <= 0) return 0;
  if (n_slices < 0 || (out != nullptr && n_queries != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = n_keys * n_queries;
  if (n_blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // the masks live in the default 48 KiB of dynamic shared memory
  if (2LL * n_slices * static_cast<long long>(sizeof(uint32_t)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kEq: launch<kEq>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kNeq: launch<kNeq>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kGt: launch<kGt>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kLt: launch<kLt>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kLe: launch<kLe>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kGe: launch<kGe>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kRange: launch<kRange>(slices, n_slices, n_keys, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
