// Hand-written Hopper (sm_90a) kernel of the all-pairs overlap matrix, on
// the tensor cores.
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
// What bounds it: the work is n * m * K * 65536 bit pairs, far above the
// bytes (both sides read once, the n x m int64 written once; 1.755 ms at
// the census working set of 10,000 x 10,000 bitmaps over 31 keys). Its
// bound is those bit pairs at the tensor cores' single-bit rate, which no
// data sheet gives: mma_probe.cu measured ~7.8e15 bit pairs a second
// (~26 ms at the census shape), where int8 0/1 products at the data
// sheet's 1,979 TOPS would take ~0.21 s. Each tile also reads its 384
// rows' whole depth through L2 (48 KB a stage; ~308 GB over the 3,160
// census tiles, ~11 TB/s at the single-bit rate), and that traffic, not
// the tensor cores, sets the kernel's time (see the tile order below).
//
// The design: out = A . B^T over bits, both operands K-major (a row's
// words already run along the depth), on Hopper's warpgroup products.
// * Tile and warpgroups. A CTA computes a 128 x 256 tile of pairs with
//   three warpgroups: one producer fills a ring of kStages shared-memory
//   stages; two consumers each issue wgmma m64n256 products of their 64
//   left rows against the tile's 256 right rows into s32 accumulators
//   (128 registers a thread). Full and empty mbarriers hand each stage
//   over; the consumers keep one product group in flight and release a
//   stage when the group reading it is done. setmaxnreg moves registers
//   from the producer to the consumers.
// * Layout. A stage holds 128-byte rows (16 KB of A, 32 KB of B), written
//   in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8))
//   that the wgmma descriptors name; a k-step is 32 bytes of each row.
// * Operand form: single bits. csrc/mma_probe.cu measured the card's
//   rates (chip_smoke.py phase 3): wgmma b1 m64n256k256 AND-popcount runs
//   at ~8x the int8 m64n256k32 rate in bit pairs, so the packed words are
//   the operand as they are, and the product is wgmma .b1 .and.popc: a
//   stage row is 1024 bits (32 words) of depth, a k-step 256 bits.
// * Filling a stage. One producer thread issues two TMA tile loads a stage
//   (128 x 128 bytes of the left rows, 256 x 128 of the right), which write
//   the 128-byte swizzle themselves, zero-fill rows past n or m, and
//   complete on the stage's full barrier; every stage of the ring can be
//   in flight. The tensor maps are encoded on the host at each launch
//   (cuTensorMapEncodeTiled, reached through the runtime's driver entry
//   point, since the library does not link libcuda).
// * Exactness. One key adds at most 65,536 to a pair, so s32 holds 32,767
//   keys exactly. The key axis is walked in chunks of at most kChunkKeys;
//   after each chunk the consumers store their tile into the int64 output
//   (first chunk) or add it there (later chunks). The CTA owns its tile, so
//   no atomics. At the census K = 31 that is one chunk and one store.
// * Ragged edges. Rows past n or m are filled with zeros and their pairs
//   are not stored.
// * Tile order. The grid is one CTA a tile, in grouped order: kGroupRows
//   row tiles walk the column tiles together, so the ~132 tiles in flight
//   read ~24 x 128 left and ~6 x 256 right rows, which L2 shares, instead
//   of ~132 distinct row pairs. The kernel is bound by those reads, not by
//   the tensor cores: at the census shape, groups of 4 and 1 row tiles ran
//   markedly slower than 12, and 24 faster.
// Offsets are 64-bit; the tile count must fit the grid's x dimension.
//
// The interface is plain C for ctypes: pointers and the stream arrive as
// void*, the entry point sets the device, launches on the caller's stream
// without synchronising, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kWords = 2048;                  // 32-bit words per key and row
constexpr int kTileM = 128;                   // left rows of a tile: two consumers of 64
constexpr int kTileN = 256;                   // right rows of a tile: the wgmma's n
constexpr int kStages = 4;                    // the shared-memory ring
constexpr int kRow = 128;                     // bytes of one swizzled stage row
constexpr int kABytes = kTileM * kRow;
constexpr int kBBytes = kTileN * kRow;
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kThreads = 384;                 // producer + two consumer warpgroups
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // + alignment, barriers
constexpr long long kChunkKeys = 32767;       // keys an s32 accumulator holds exactly
constexpr long long kGroupRows = 24;          // row tiles of a rasterization group
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;            // 128 x 40 + 256 x 232 <= 65,536

constexpr long long kStagesPerKey = kWords * 4 / kRow;  // 64 stages of 1024 bits a key
constexpr int kKStep = 32;                               // bytes (256 bits) a wgmma reads of a row

static_assert(kSmem <= 232448, "the ring fits an SM's shared memory");

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box of tmap at (c0 bytes along the depth, c1 rows) into dst,
// completing on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tmap, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
pairwise_and_card_kernel(const __grid_constant__ CUtensorMap tm_left, long long n,
                         const __grid_constant__ CUtensorMap tm_right, long long m,
                         long long n_keys, long long tiles_m, long long tiles_n,
                         unsigned long long* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = rbw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte alignment
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  // grouped tile order
  const long long tile = blockIdx.x;
  const long long per_group = kGroupRows * tiles_n;
  const long long first = tile / per_group * kGroupRows;
  const long long rows_in_group = tiles_m - first < kGroupRows ? tiles_m - first : kGroupRows;
  const long long within = tile % per_group;
  const long long row0 = (first + within % rows_in_group) * kTileM;
  const long long col0 = within / rows_in_group * kTileN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rbw::mbar_init(full(s), 1);    // the producer's expect_tx; the loads complete it
      rbw::mbar_init(empty(s), 8);   // one lane of each consumer warp
    }
    rbw::mbar_init_fence();
  }
  __syncthreads();

  const long long total = n_keys * kStagesPerKey;  // stages over the whole depth
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long s = 0; s < total; ++s) {
        rbw::mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), kStageBytes);
        const uint32_t st = base + stage * kStageBytes;
        const int depth = static_cast<int>(s * kRow);  // < 2^31: K * 8192 bytes a row
        tma_load(st, &tm_left, depth, static_cast<int>(row0), full(stage));
        tma_load(st + kABytes, &tm_right, depth, static_cast<int>(col0), full(stage));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // left rows cw * 64 .. cw * 64 + 63 of the tile
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    uint32_t acc[128];
    int stage = 0;
    uint32_t phase = 0;
    long long s = 0;
    for (long long k0 = 0; k0 < n_keys; k0 += kChunkKeys) {
      const long long k1 = n_keys - k0 < kChunkKeys ? n_keys : k0 + kChunkKeys;
      const long long s_end = k1 * kStagesPerKey;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0u;
      int held = -1;  // the stage the product group in flight reads
      for (; s < s_end; ++s) {
        rbw::mbar_wait(full(stage), phase);
        const uint32_t sa = base + stage * kStageBytes + cw * 64 * kRow;
        const uint32_t sb = base + stage * kStageBytes + kABytes;
        rbw::fence_acc(acc);
        rbw::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kRow / kKStep; ++k)
          rbw::wgmma_b1(acc, rbw::sw128_desc(sa + kKStep * k), rbw::sw128_desc(sb + kKStep * k));
        rbw::wgmma_commit();
        rbw::fence_acc(acc);
        rbw::wgmma_wait<1>();
        if (held >= 0 && lane == 0) rbw::mbar_arrive(empty(held));
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      rbw::wgmma_wait<0>();
      rbw::fence_acc(acc);
      if (lane == 0) rbw::mbar_arrive(empty(held));
      // accumulator i of this thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
      // column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 256
      const long long r_base = row0 + cw * 64 + warp * 16 + (lane >> 2);
      const long long c_base = col0 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const long long r = r_base + 8 * ((i >> 1) & 1);
        const long long c = c_base + 8 * (i >> 2) + (i & 1);
        if (r < n && c < m) {
          unsigned long long* p = out + r * m + c;
          *p = k0 == 0 ? acc[i] : *p + acc[i];
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows x (n_keys * 8192) bytes, boxes of box_rows x 128 bytes, 128-byte swizzled
bool row_map(CUtensorMap* map, const void* rows, long long n_rows, long long n_keys, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_keys) * kWords * 4,
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {dims[0]};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRow), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(rows), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(int device, const void* left, long long n, const void* right, long long m,
           long long n_keys, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || m <= 0) return 0;
  if (n_keys <= 0 || n_keys * kWords * 4 >= (1LL << 31) || n >= (1LL << 31) || m >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // TMA coordinates are int32
  const long long tiles_m = (n + kTileM - 1) / kTileM;
  const long long tiles_n = (m + kTileN - 1) / kTileN;
  if (tiles_m * tiles_n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_left, tm_right;
  if (!row_map(&tm_left, left, n, n_keys, kTileM) || !row_map(&tm_right, right, m, n_keys, kTileN))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(pairwise_and_card_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairwise_and_card_kernel<<<static_cast<unsigned>(tiles_m * tiles_n), kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      tm_left, n, tm_right, m, n_keys, tiles_m, tiles_n, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// left: n x n_keys x 2048 words; right: m x n_keys x 2048 words (both
// 16-byte aligned); out: n x m int64, row-major.
int rb_pairwise_and_card(int device, const void* left, long long n, const void* right,
                         long long m, long long n_keys, void* out, void* stream) {
  return launch(device, left, n, right, m, n_keys, out, stream);
}

// the kernel's registers a thread (as built) and its dynamic shared memory
int rb_pairwise_and_card_attrs(int device, int* regs, int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, pairwise_and_card_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attrs.numRegs;
  *smem_bytes = kSmem;
  return 0;
}

}  // extern "C"
