// Hand-written Hopper (sm_90a) kernel of the query path.
//
// rb_threshold replaces the XLA function the JAX package runs for a device
// Threshold(k):
//   roaringbitmap_tpu/query/kernels.py:_threshold_kernel
//     (a lax.scan of the bit-sliced adder over the rows of the zero-padded
//     [G, M, 2048] group block, the MSB->LSB >= k compare, and the popcount
//     of each group's result, one jitted dispatch)
// and computes exactly that function: per group g and bit position, an
// L-slice counter of the rows whose bit is set (a carry out of the top
// slice drops), compared against the low L bits of k.
//
// What bounds it: the block is read once (G * M * 8 KiB: 2.54 GB at the
// census working set's [31, 10000, 2048]) and the output is G rows, so
// device-memory bandwidth sets the floor. The function needs about 5 logic
// instructions per row word (a carry-save adder); a ripple counter needs up
// to 2L per row word but stops as soon as the carry is zero, and the zero
// words that most sparse rows are made of cost one compare.
//
// The design. One thread owns one word column of one group (a warp reads 128
// contiguous bytes of a row) for a quarter of the group's M rows: a CTA is
// 128 columns x 4 row segments, 512 threads: a [31, M, 2048] block alone
// has too few columns to keep enough loads in flight for the card's
// bandwidth, so the rows are split too, each thread keeping eight loads in
// flight before it adds them. The counter is L bit-slice registers: the kernel is
// templated on LMAX in {8, 16, 32} and every loop over the slices is
// unrolled to LMAX with an "i < L" guard, so the slices index at compile
// time and stay in registers. Adding a row word is a ripple (sum = s ^ c,
// carry = s & c) that breaks when the carry is zero. Segments 1-3 then
// leave their counters in shared memory ([3][LMAX][128] words, 48 KiB at
// LMAX = 32) and segment 0 adds them into its own with a full-adder ripple
// (the sum of four L-bit counters, mod 2^L like the one counter it
// replaces). Then the MSB->LSB compare keeps eq/gt masks, the thread
// stores its word, and the group's popcount is a warp shuffle reduction
// plus one atomicAdd per warp into the zero-filled cards (integer atomics:
// exact, order-free).
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 2048;     // 32-bit words per container row
constexpr int kCols = 128;       // word columns per CTA
constexpr int kSegs = 4;         // row segments per CTA
constexpr int kThreads = kCols * kSegs;
constexpr int kTiles = kWords / kCols;
constexpr int kInFlight = 8;     // row words loaded before they are added

template <int LMAX>
__device__ __forceinline__ void add_word(uint32_t (&s)[LMAX], uint32_t carry, int n_slices) {
#pragma unroll
  for (int i = 0; i < LMAX; ++i) {
    if (i >= n_slices || carry == 0u) break;
    const uint32_t t = s[i] & carry;
    s[i] ^= carry;
    carry = t;
  }
}

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
threshold_kernel(const uint32_t* __restrict__ words, long long m, int n_slices, uint32_t k,
                 uint32_t* __restrict__ out, int* __restrict__ cards) {
  __shared__ uint32_t part[kSegs - 1][LMAX][kCols];
  const long long g = blockIdx.x / kTiles;
  const int c = threadIdx.x % kCols;
  const int seg = threadIdx.x / kCols;
  const int col = (blockIdx.x % kTiles) * kCols + c;
  const uint32_t* p = words + g * m * kWords + col;
  uint32_t s[LMAX];
#pragma unroll
  for (int i = 0; i < LMAX; ++i) s[i] = 0u;
  long long r = m * seg / kSegs;
  const long long end = m * (seg + 1) / kSegs;
  for (; r + kInFlight <= end; r += kInFlight) {
    uint32_t v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) v[j] = __ldg(p + (r + j) * kWords);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) add_word<LMAX>(s, v[j], n_slices);
  }
  for (; r < end; ++r) add_word<LMAX>(s, __ldg(p + r * kWords), n_slices);

  if (seg > 0) {
#pragma unroll
    for (int i = 0; i < LMAX; ++i) {
      if (i < n_slices) part[seg - 1][i][c] = s[i];
    }
  }
  __syncthreads();
  if (seg > 0) return;
#pragma unroll
  for (int q = 0; q < kSegs - 1; ++q) {
    uint32_t carry = 0u;
#pragma unroll
    for (int i = 0; i < LMAX; ++i) {
      if (i < n_slices) {
        const uint32_t a = s[i], b = part[q][i][c];
        s[i] = a ^ b ^ carry;
        carry = (a & b) | (carry & (a ^ b));
      }
    }
  }

  uint32_t eq = 0xFFFFFFFFu, gt = 0u;
#pragma unroll
  for (int b = LMAX - 1; b >= 0; --b) {
    if (b < n_slices) {
      if ((k >> b) & 1u) {
        eq &= s[b];
      } else {
        gt |= eq & s[b];
        eq &= ~s[b];
      }
    }
  }
  const uint32_t res = gt | eq;
  out[g * kWords + col] = res;
  int n = __popc(res);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xFFFFFFFFu, n, off);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(cards + g, n);
}

template <int LMAX>
void launch_threshold(const void* words, long long groups, long long m, int n_slices,
                      unsigned k, void* out, void* cards, cudaStream_t stream) {
  threshold_kernel<LMAX><<<static_cast<unsigned>(groups * kTiles), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), m, n_slices, k, static_cast<uint32_t*>(out),
      static_cast<int*>(cards));
}

}  // namespace

extern "C" {

// words: groups x m x 2048 words (zero-filled pad rows); n_slices: counter
// width L in 1..32; k: the threshold's low 32 bits (only the low L are
// compared); out: groups x 2048 result words; cards: groups int32 already
// zero.
int rb_threshold(int device, const void* words, long long groups, long long m, int n_slices,
                 unsigned k, void* out, void* cards, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups <= 0) return 0;
  if (n_slices < 1 || n_slices > 32 || m < 0 || groups * kTiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slices <= 8) {
    launch_threshold<8>(words, groups, m, n_slices, k, out, cards, s);
  } else if (n_slices <= 16) {
    launch_threshold<16>(words, groups, m, n_slices, k, out, cards, s);
  } else {
    launch_threshold<32>(words, groups, m, n_slices, k, out, cards, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
