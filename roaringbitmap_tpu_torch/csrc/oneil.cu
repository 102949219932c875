// Hand-written Hopper (sm_90a) kernels of the BSI range-query path.
//
// They replace, on this path:
//   roaringbitmap_tpu/ops/pallas_kernels.py:oneil_compare_pallas
//     (the fused O'Neil compare, one query: [S, K, 2048] slices, the
//     predicate bits, [K, 2048] ebm and fixed words -> [K, 2048] result
//     words and [K] popcounts; RANGE as a dual walk)
//   roaringbitmap_tpu/models/bsi.py:_o_neil_counts_batched
//     (the XLA vmap of o_neil_math over a [Q, S] or [Q, 2, S] predicate
//     axis, count-only -> [Q, K] popcounts)
//
// Two kernels, picked by shape in ops/kernels.py:
//
// oneil_kernel (rb_oneil_compare): one query, or a count-only batch whose
// slice tile does not fit in shared memory (S > 396). One CTA per (query,
// key chunk), 512 threads; thread t owns the 16-byte column t of the chunk's
// 8 KiB row and carries GT, LT and EQ (plus LT2 and EQ2 of the second walk
// for RANGE) in registers over the S slices, from the highest slice down,
// with kInFlight slice loads issued before the first is used. The predicate
// bits arrive as an int32 device array [Q, W, S] (W = 2 for RANGE), because
// an index can hold more than 64 slices; each CTA turns its query's bits
// into all-ones / all-zero masks in shared memory, so the walk is
// branch-free: lt |= m & eq & ~s; gt |= ~m & eq & s; eq &= ~(s ^ m). Each
// CTA reduces its row's popcount and writes cards[q, k] without atomics.
// What bounds it: one query reads each slice word once and spends three to
// five bitwise ops on it, so device-memory bandwidth binds: 437.5 MB, 0.1306
// ms at 3.35 TB/s for the 100M-row, 32-slice index with a found set (K =
// 1526); 425.0 MB, 0.1269 ms when fixed is the ebm.
//
// oneil_tiled_kernel (rb_oneil_counts): the count-only walk of Q >= 2
// predicates. What bounds it: the function needs the slices once (412.9
// MB, 0.1233 ms for the index above), and a formulation that rebuilds each
// column's value and ranks it among the thresholds would spend about 20
// logic instructions a column whatever Q is (0.12 ms), so bytes bound the
// function. This design instead walks every query over every word: Q * S *
// K * 2048 word-steps, 6.40 G at Q = 64. The O'Neil step costs one or two
// logic instructions a word-step (1.375-1.5 on average for the thresholds
// it meets), plus a test and a branch on the predicate bit. This kernel
// takes one: v >= t is the carry out of v + ~t + 1, and walking the slices
// from the lowest up, the carry of one slice is maj(s, ~m, c) -- one LOP3
// over the slice word s, the threshold bit m as an all-ones / all-zero mask
// and the carry c, whatever m is, with no branch:
//   GE: carry in 1, answer c      GT: carry in 0, answer c
//   LT: carry in 1, answer ~c     LE: carry in 0, answer ~c
//   RANGE: a GE chain on lo and a GT chain on hi, answer c_lo & ~c_hi
//   EQ / NEQ: eq &= ~(s ^ m) from the ebm, answer eq / ~eq
// each answer masked with the ebm and the found set. The card issues logic
// instructions at 64 lanes per SM per clock, so this design's own floor is
// W * S * Q * K * 2048 / (132 * 64 * 1.98 GHz): 0.383 ms at Q = 64, three
// times the function's byte bound. From Q ~ 21 up the walk's instruction
// count, not the bytes, sets its time; below that the single pass does.
// What the design does about it:
//   1. One pass over the slices. A CTA owns a tile of T words of one key
//      chunk and stages the tile's [S, T] slice words, its ebm and its fixed
//      words in dynamic shared memory with cp.async.bulk (one thread issues
//      the copies) completing on one mbarrier. T (1024 down to 128) and the
//      shared-memory size are the wrapper's (ops/kernels.py:
//      oneil_tile_plan), which keeps the most warps resident; at S = 32
//      three 512-word CTAs share an SM, one staging while the others walk.
//      Device memory and L2 carry the slices once, not Q times.
//   2. Every query on the tile. Thread t owns kVec = 4 words (one LDS.128 a
//      slice). The queries are walked kGroupWalks = 16 walks at a time (16
//      queries, or 8 RANGE queries), whose chains live in registers; slices
//      are the outer loop and the group's walks the inner one, so each
//      shared-memory load of a slice serves 16 walks.
//   3. The masks. The predicate bits are packed into 32-bit words in shared
//      memory (one __ballot_sync per word), and each group's bits expanded
//      into a [16][S] table of masks, read with one broadcast LDS.128 per
//      walk and four slices: the inner loop is one LOP3 per word-step and
//      nothing else (the SASS count is printed by chip_smoke.py).
//   4. Cards. Each query's popcount is summed in the warp with
//      __reduce_add_sync, then across the CTA's warps in shared memory, and
//      added into cards[q, k] with an integer atomicAdd (a chunk spans 2048 /
//      T tiles). Integer addition is exact and order-free, so the result is
//      the same on every run; the wrapper zero-fills cards.
//
// Row width. A key chunk is 2048 words on a single card; a mesh that splits
// the word axis over a "words" dimension hands each rank rows of W = 2048 /
// nw words (1024, 512 or 256), a runtime argument of both entry points. The
// per-query kernel then runs W / 4 threads a CTA (thread t still owns column
// t), and the tiled walk W / T CTAs a key chunk (T <= W, from the wrapper's
// plan). At W = 2048 both launch exactly as before.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry points set the device, launch on the caller's stream
// without synchronising, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kWords = 2048;       // 32-bit words of a full container row
constexpr int kVecs = kWords / 4;  // uint4 columns of a full row
constexpr int kThreads = kVecs;    // thread t owns column t (of a full row)
constexpr int kWarps = kThreads / 32;

// true for the widths a row may have: 2048, 1024, 512 and 256 words
inline bool row_width_ok(int row_words) {
  return row_words == 2048 || row_words == 1024 || row_words == 512 || row_words == 256;
}
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

// blockDim.x = vecs = row_words / 4 uint4 columns a row
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
  const int vecs = blockDim.x;

  const int* qbits = bits + static_cast<long long>(q) * W * n_slices;
  for (int i = t; i < W * n_slices; i += vecs) masks[i] = qbits[i] ? 0xFFFFFFFFu : 0u;
  __syncthreads();

  const uint4 e = ebm[k * vecs + t];
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
  const long long stride = n_keys * vecs;
  const uint4* col = slices + k * vecs + t + static_cast<long long>(n_slices - 1) * stride;
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

  const uint4 f4 = fixed[k * vecs + t];
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
  if (out != nullptr) out[k * vecs + t] = make_uint4(o[0], o[1], o[2], o[3]);

  int c = __popc(o[0]) + __popc(o[1]) + __popc(o[2]) + __popc(o[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < (vecs >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
    if (lane == 0) cards[static_cast<long long>(q) * n_keys + k] = c;
  }
}

template <int OP>
void launch(const void* slices, int n_slices, long long n_keys, int row_words, const void* bits,
            int n_queries, const void* ebm, const void* fixed, void* out, void* cards,
            long long n_blocks, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (OP == kRange ? 2 : 1) * static_cast<size_t>(n_slices);
  oneil_kernel<OP><<<static_cast<unsigned>(n_blocks), row_words / 4, smem, stream>>>(
      static_cast<const uint4*>(slices), n_slices, n_keys, static_cast<const int*>(bits),
      n_queries, static_cast<const uint4*>(ebm), static_cast<const uint4*>(fixed),
      static_cast<uint4*>(out), static_cast<int*>(cards));
}

// ---------------------------------------------------------------------------
// the tiled count-only walk of Q >= 2 predicates
// ---------------------------------------------------------------------------

constexpr int kVec = 4;                          // words a thread owns
constexpr int kMaxTileWords = 1024;
constexpr int kMaxTileThreads = kMaxTileWords / kVec;
constexpr int kMaxTileWarps = kMaxTileThreads / 32;
constexpr int kGroupWalks = 16;                  // walks a group keeps in registers
constexpr int kUnroll = 4;                       // slices a mask load covers
constexpr unsigned kFull = 0xFFFFFFFFu;

// carry step of v + ~t (+ 1), one slice: c' = maj(s, ~m, c), s the slice
// word, m the threshold bit as an all-ones / all-zero mask
constexpr int kCarry = 0xB2;  // lop3 LUT over a = s, b = m, c = c
// EQ step: eq' = eq & ~(s ^ m)
constexpr int kEqual = 0x90;  // lop3 LUT over a = eq, b = s, c = m

template <int LUT>  // LUT over a = 0xF0, b = 0xCC, c = 0xAA
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// thread t's kVec = 4 words of a shared-memory row: one LDS.128, a warp's
// loads contiguous
__device__ __forceinline__ void load_words(uint32_t (&w)[kVec], const uint32_t* row, int t) {
  const uint4 x = reinterpret_cast<const uint4*>(row)[t];
  w[0] = x.x;
  w[1] = x.y;
  w[2] = x.z;
  w[3] = x.w;
}

// Dynamic shared memory: [S][T] slice words (row i is slice i), [T] ebm,
// [T] fixed, the packed predicate bits [Q][W][NW] (NW = ceil(S / 32); bit
// p % 32 of word p / 32 is walk position p, i.e. slice S-1-p), then the
// current group's masks [kGroupWalks][S4] (S4 = S rounded up to 4; entry i
// of row g * W + w is all ones where bit w of query g at slice i is set).
// blockIdx.x = k * (row_words / T) + tile. bits, cards: this launch's
// queries.
template <int OP>
__global__ void __launch_bounds__(kMaxTileThreads, 2)
oneil_tiled_kernel(const uint32_t* __restrict__ slices, int n_slices, long long n_keys,
                   int row_words, const int* __restrict__ bits, int n_queries,
                   const uint32_t* __restrict__ ebm, const uint32_t* __restrict__ fixed,
                   int* __restrict__ cards, int tile_words) {
  constexpr int W = OP == kRange ? 2 : 1;
  constexpr int QG = kGroupWalks / W;
  // the chains each walk starts from: all ones for v >= t (the + 1 of
  // v + ~t + 1), zero for v > t; EQ starts from the ebm
  constexpr bool kCarryIn = OP == kGe || OP == kLt || OP == kRange;
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ uint64_t bar_word;
  __shared__ int red[kGroupWalks][kMaxTileWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int tiles = row_words / tile_words;
  const long long k = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * tile_words;
  const int nw = (n_slices + 31) >> 5;
  const int s4 = (n_slices + 3) & ~3;
  uint32_t* s_ebm = smem + static_cast<size_t>(n_slices) * tile_words;
  uint32_t* s_fixed = s_ebm + tile_words;
  uint32_t* s_bits = s_fixed + tile_words;
  uint32_t* s_mask = s_bits + ((n_queries * W * nw + 3) & ~3);  // 16-byte aligned

  // 1. stage the tile: S + 2 rows of T words, one bulk copy each
  const uint32_t bar = smem_addr(&bar_word);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    const uint32_t row = static_cast<uint32_t>(tile_words) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(row * static_cast<uint32_t>(n_slices + 2)) : "memory");
    const long long col = k * row_words + t0;
    const long long stride = n_keys * row_words;
    for (int i = 0; i < n_slices; ++i) {
      bulk_load(smem + static_cast<size_t>(i) * tile_words, slices + i * stride + col, row, bar);
    }
    bulk_load(s_ebm, ebm + col, row, bar);
    bulk_load(s_fixed, fixed + col, row, bar);
  }
  // meanwhile pack the predicate bits: one ballot per 32 walk positions
  for (int i = warp; i < n_queries * W * nw; i += n_warps) {
    const int r = i / nw;  // query * W + walk
    const int pos = (i - r * nw) * 32 + lane;
    const int v = pos < n_slices ? bits[static_cast<long long>(r) * n_slices + pos] : 0;
    const uint32_t word = __ballot_sync(kFull, v != 0);
    if (lane == 0) s_bits[i] = word;
  }
  wait_phase(bar, 0);

  uint32_t ew[kVec], fw[kVec], fe[kVec];
  load_words(ew, s_ebm, t);
  load_words(fw, s_fixed, t);
#pragma unroll
  for (int c = 0; c < kVec; ++c) fe[c] = fw[c] & ew[c];  // every walk's answer lies in the ebm

  // 2. every query on the tile, QG at a time
  for (int g = 0; g < n_queries; g += QG) {
    __syncthreads();  // the bits are packed; the last group's masks are read
    // this group's masks; a query past the end repeats query g and is
    // never counted
    for (int i = t; i < kGroupWalks * s4; i += blockDim.x) {
      const int r = i / s4;  // qi * W + walk
      const int slice = i - r * s4;
      const int q = g + r / W < n_queries ? g + r / W : g;
      const int pos = n_slices - 1 - slice;
      const uint32_t word = slice < n_slices ? s_bits[(q * W + r % W) * nw + (pos >> 5)] : 0u;
      s_mask[i] = ((word >> (pos & 31)) & 1u) ? kFull : 0u;
    }
    __syncthreads();

    uint32_t ch[kGroupWalks][kVec];  // walk r = qi * W + w
#pragma unroll
    for (int r = 0; r < kGroupWalks; ++r) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        ch[r][c] = (OP == kEq || OP == kNeq) ? ew[c]
                   : ((OP == kRange ? r % 2 == 0 : kCarryIn) ? kFull : 0u);
      }
    }
    for (int i0 = 0; i0 < n_slices; i0 += kUnroll) {
      uint32_t sv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u < n_slices) load_words(sv[u], smem + static_cast<size_t>(i0 + u) * tile_words, t);
      }
#pragma unroll
      for (int r = 0; r < kGroupWalks; ++r) {
        // the walk's masks of these kUnroll slices: one broadcast LDS.128
        const uint4 m4 = *reinterpret_cast<const uint4*>(s_mask + r * s4 + i0);
        const uint32_t m[kUnroll] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u < n_slices) {
#pragma unroll
            for (int c = 0; c < kVec; ++c) {
              ch[r][c] = (OP == kEq || OP == kNeq) ? lop3<kEqual>(ch[r][c], sv[u][c], m[u])
                                                   : lop3<kCarry>(sv[u][c], m[u], ch[r][c]);
            }
          }
        }
      }
    }

    // 3. per-query popcount: warp, then CTA, then one atomic per (q, tile)
#pragma unroll
    for (int qi = 0; qi < QG; ++qi) {
      unsigned cnt = 0;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const uint32_t a = ch[qi * W][c];
        uint32_t o;
        if (OP == kEq) o = a & fw[c];                    // a lies in the ebm
        else if (OP == kNeq) o = ~a & fw[c];             // fixed outside the ebm counts too
        else if (OP == kGt || OP == kGe) o = a & fe[c];  // v > t, v >= t
        else if (OP == kLt || OP == kLe) o = ~a & fe[c];  // not v >= t, not v > t
        else o = a & ~ch[qi * W + W - 1][c] & fe[c];     // v >= lo and not v > hi
        cnt += __popc(o);
      }
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) red[qi][warp] = static_cast<int>(cnt);
    }
    __syncthreads();
    if (t < QG && g + t < n_queries) {
      int sum = 0;
      for (int w = 0; w < n_warps; ++w) sum += red[t][w];
      atomicAdd(cards + static_cast<long long>(g + t) * n_keys + k, sum);
    }
  }
}

template <int OP>
cudaError_t launch_tiled(const void* slices, int n_slices, long long n_keys, int row_words,
                         const void* bits, int n_queries, const void* ebm, const void* fixed,
                         void* cards, int tile_words, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      oneil_tiled_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_blocks = n_keys * (row_words / tile_words);
  oneil_tiled_kernel<OP><<<static_cast<unsigned>(n_blocks), tile_words / kVec, smem, stream>>>(
      static_cast<const uint32_t*>(slices), n_slices, n_keys, row_words, static_cast<const int*>(bits),
      n_queries, static_cast<const uint32_t*>(ebm), static_cast<const uint32_t*>(fixed),
      static_cast<int*>(cards), tile_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// slices: n_slices x n_keys x row_words words (row_words 2048, 1024, 512
// or 256); bits: int32 n_queries x W x n_slices (W = 2 for RANGE, lo walk
// first; position j is slice n_slices - 1 - j); ebm, fixed: n_keys x
// row_words words; out: n_keys x row_words words, or null for count-only
// (n_queries must be 1 otherwise); cards: int32 n_queries x n_keys. op: 0
// EQ, 1 NEQ, 2 GT, 3 LT, 4 LE, 5 GE, 6 RANGE.
int rb_oneil_compare(int device, int op, const void* slices, int n_slices, long long n_keys,
                     int row_words, const void* bits, int n_queries, const void* ebm,
                     const void* fixed, void* out, void* cards, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!row_width_ok(row_words)) return static_cast<int>(cudaErrorInvalidValue);
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
    case kEq: launch<kEq>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kNeq: launch<kNeq>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kGt: launch<kGt>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kLt: launch<kLt>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kLe: launch<kLe>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kGe: launch<kGe>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    case kRange: launch<kRange>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, out, cards, n_blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tiled count-only walk: slices, row_words, bits, ebm and fixed as for
// rb_oneil_compare (bits and cards holding this launch's n_queries);
// cards: int32 n_queries x n_keys, zero-filled by the caller, to which the
// per-tile counts are added. tile_words: 128, 256, 512 or 1024, at most
// row_words; smem: the
// dynamic shared memory of a CTA, at least 4 * ((S + 2) * T + the packed
// bits [n_queries][W][ceil(S / 32)] rounded up to 4 words + kGroupWalks *
// S rounded up to 4). Both come from the wrapper's plan
// (ops/kernels.py:oneil_tile_plan), the one place the tile is sized; the
// launch fails when smem exceeds what a block may use.
int rb_oneil_counts(int device, int op, const void* slices, int n_slices, long long n_keys,
                    int row_words, const void* bits, int n_queries, const void* ebm,
                    const void* fixed, void* cards, int tile_words, long long smem, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_keys <= 0 || n_queries <= 0) return 0;
  if (n_slices < 1 || smem <= 0 || smem > 0x7FFFFFFFLL || !row_width_ok(row_words) ||
      (tile_words != 128 && tile_words != 256 && tile_words != 512 && tile_words != kMaxTileWords) ||
      tile_words > row_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_keys * (row_words / tile_words) > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // the bulk copies need 16-byte aligned rows
  for (const void* p : {slices, ebm, fixed}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (op) {
    case kEq: err = launch_tiled<kEq>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kNeq: err = launch_tiled<kNeq>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kGt: err = launch_tiled<kGt>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kLt: err = launch_tiled<kLt>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kLe: err = launch_tiled<kLe>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kGe: err = launch_tiled<kGe>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    case kRange: err = launch_tiled<kRange>(slices, n_slices, n_keys, row_words, bits, n_queries, ebm, fixed, cards, tile_words, sm, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
