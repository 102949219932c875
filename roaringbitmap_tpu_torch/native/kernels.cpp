// The port's copy of roaringbitmap_tpu/native/kernels.cpp: the same
// extern "C" L0 and OpenMP batch kernels, computing the same bits, built
// with g++ into roaringbitmap_tpu_torch/_build/ by native/__init__.py.
//
// Native host-side L0 kernels for roaringbitmap_tpu.
//
// C++ re-expression of the reference's JIT-intrinsic word/array kernels
// (reference: RoaringBitmap/src/main/java/org/roaringbitmap/Util.java —
// unsignedIntersect2by2 :890 with the galloping variant :934,
// unsignedUnion2by2 :1116, unsignedDifference, unsignedExclusiveUnion2by2,
// advanceUntil :64-analogue, select(long,int) :564 — and
// BitmapContainer.java's Long.bitCount loops). The TPU device path lives in
// ops/device.py + ops/pallas_kernels.py; this library is the CPU fast path
// for small/irregular containers, where Python/numpy call overhead dominates.
//
// Exposed via ctypes (native/__init__.py); every function has a numpy
// fallback in utils/bits.py with identical semantics, used as the
// differential-test oracle (tests/test_native.py).

#include <cstdint>
#include <cstring>

// Every input payload is read through these one-byte-aligned types. An
// input may be a view into a serialized buffer (a mapped
// ImmutableRoaringBitmap's containers): an array container's payload is
// 2 * card bytes and the run marker any number of bytes, so the next
// container's words or values may start at any byte offset. A plain
// uint64_t* or uint16_t* to such memory is undefined behaviour, which -O3
// may compile into aligned vector loads. Outputs are buffers the bindings
// allocate (or check) aligned, and keep the natural types.
typedef uint16_t in_u16 __attribute__((aligned(1)));
typedef uint64_t in_u64 __attribute__((aligned(1)));

extern "C" {

// ---------------------------------------------------------------------------
// sorted uint16 set algebra
// ---------------------------------------------------------------------------

// Exponential (galloping) search: smallest index i in [pos, n) with
// a[i] >= min, else n. Mirrors Util.advanceUntil's exponential+binary probe.
static int32_t gallop(const in_u16* a, int32_t pos, int32_t n, uint16_t min) {
  int32_t lo = pos;
  if (lo >= n || a[lo] >= min) return lo;
  int32_t span = 1;
  while (lo + span < n && a[lo + span] < min) span <<= 1;
  int32_t hi = (lo + span < n) ? lo + span : n - 1;
  lo = lo + (span >> 1);
  if (a[hi] < min) return n;
  // binary search in (lo, hi]
  while (lo + 1 < hi) {
    int32_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] < min) lo = mid; else hi = mid;
  }
  return hi;
}

int32_t rb_advance_until(const in_u16* a, int32_t n, int32_t pos, uint16_t min) {
  return gallop(a, pos + 1, n, min);
}

// One-sided galloping intersection: |small| * 64 < |large|
// (Util.java:890-932's THRESHOLD=64 dispatch to the galloping variant :934).
static int32_t intersect_gallop(const in_u16* s, int32_t ns, const in_u16* l,
                                int32_t nl, uint16_t* out) {
  int32_t k = 0, j = 0;
  for (int32_t i = 0; i < ns; ++i) {
    j = gallop(l, j, nl, s[i]);
    if (j == nl) break;
    if (l[j] == s[i]) {
      if (out) out[k] = s[i];
      ++k;
    }
  }
  return k;
}

int32_t rb_intersect_u16(const in_u16* a, int32_t na, const in_u16* b,
                         int32_t nb, uint16_t* out) {
  if (na == 0 || nb == 0) return 0;
  if ((int64_t)na * 64 < nb) return intersect_gallop(a, na, b, nb, out);
  if ((int64_t)nb * 64 < na) return intersect_gallop(b, nb, a, na, out);
  int32_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    uint16_t x = a[i], y = b[j];
    if (x < y) ++i;
    else if (y < x) ++j;
    else { if (out) out[k] = x; ++k; ++i; ++j; }
  }
  return k;
}

int32_t rb_intersect_card_u16(const in_u16* a, int32_t na, const in_u16* b,
                              int32_t nb) {
  return rb_intersect_u16(a, na, b, nb, nullptr);
}

int32_t rb_union_u16(const in_u16* a, int32_t na, const in_u16* b,
                     int32_t nb, uint16_t* out) {
  int32_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    uint16_t x = a[i], y = b[j];
    if (x < y) { out[k++] = x; ++i; }
    else if (y < x) { out[k++] = y; ++j; }
    else { out[k++] = x; ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  while (j < nb) out[k++] = b[j++];
  return k;
}

int32_t rb_difference_u16(const in_u16* a, int32_t na, const in_u16* b,
                          int32_t nb, uint16_t* out) {
  int32_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    uint16_t x = a[i], y = b[j];
    if (x < y) { out[k++] = x; ++i; }
    else if (y < x) ++j;
    else { ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  return k;
}

int32_t rb_xor_u16(const in_u16* a, int32_t na, const in_u16* b, int32_t nb,
                   uint16_t* out) {
  int32_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    uint16_t x = a[i], y = b[j];
    if (x < y) { out[k++] = x; ++i; }
    else if (y < x) { out[k++] = y; ++j; }
    else { ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  while (j < nb) out[k++] = b[j++];
  return k;
}

// membership of each query value in a sorted array -> byte mask
void rb_contains_many_u16(const in_u16* sorted, int32_t n, const in_u16* q,
                          int32_t nq, uint8_t* out) {
  for (int32_t i = 0; i < nq; ++i) {
    int32_t j = gallop(sorted, 0, n, q[i]);
    out[i] = (j < n && sorted[j] == q[i]) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// uint64 word-bitset kernels (1024 words per container, but n is generic)
// ---------------------------------------------------------------------------

int64_t rb_popcount_words(const in_u64* w, int64_t n) {
  int64_t c = 0;
  for (int64_t i = 0; i < n; ++i) c += __builtin_popcountll(w[i]);
  return c;
}

void rb_words_from_values(const in_u16* v, int32_t n, uint64_t* words) {
  for (int32_t i = 0; i < n; ++i) words[v[i] >> 6] |= 1ULL << (v[i] & 63);
}

int32_t rb_values_from_words(const in_u64* words, int32_t n_words,
                             uint16_t* out) {
  int32_t k = 0;
  for (int32_t w = 0; w < n_words; ++w) {
    uint64_t x = words[w];
    int32_t base = w << 6;
    while (x) {
      out[k++] = (uint16_t)(base + __builtin_ctzll(x));
      x &= x - 1;
    }
  }
  return k;
}

// number of runs: popcount(x & ~(x<<1 | carry)) with cross-word carry
// (BitmapContainer.numberOfRuns' branchless per-word form).
int32_t rb_num_runs_words(const in_u64* words, int32_t n_words) {
  int32_t runs = 0;
  uint64_t carry = 0;
  for (int32_t w = 0; w < n_words; ++w) {
    uint64_t x = words[w];
    runs += __builtin_popcountll(x & ~((x << 1) | carry));
    carry = x >> 63;
  }
  return runs;
}

// position of the j-th (0-based) set bit, or -1
int32_t rb_select_words(const in_u64* words, int32_t n_words, int32_t j) {
  for (int32_t w = 0; w < n_words; ++w) {
    int32_t c = __builtin_popcountll(words[w]);
    if (j < c) {
      uint64_t x = words[w];
      for (; j > 0; --j) x &= x - 1;  // peel j set bits (Util.select :564)
      return (w << 6) + __builtin_ctzll(x);
    }
    j -= c;
  }
  return -1;
}

// popcount of bits [start, end) over the word array
int64_t rb_cardinality_in_range(const in_u64* words, int32_t start,
                                int32_t end) {
  if (start >= end) return 0;
  int32_t first = start >> 6, last = (end - 1) >> 6;
  uint64_t lo = ~0ULL << (start & 63);
  uint64_t hi = ~0ULL >> (63 - ((end - 1) & 63));
  if (first == last) return __builtin_popcountll(words[first] & lo & hi);
  int64_t c = __builtin_popcountll(words[first] & lo) +
              __builtin_popcountll(words[last] & hi);
  for (int32_t w = first + 1; w < last; ++w)
    c += __builtin_popcountll(words[w]);
  return c;
}

// fold rows of an [n_rows, n_words] matrix: op 0=OR 1=AND 2=XOR; also returns
// the popcount of the result (the lazy-cardinality "repair" fused in, cf.
// Container.lazyIOR/repairAfterLazy Container.java:717/873).
int64_t rb_wide_op_words(const in_u64* rows, int64_t n_rows, int64_t n_words,
                         int32_t op, uint64_t* out) {
  if (n_rows == 0) {
    memset(out, 0, (size_t)n_words * 8);
    return 0;
  }
  memcpy(out, rows, (size_t)n_words * 8);
  for (int64_t r = 1; r < n_rows; ++r) {
    const in_u64* row = rows + r * n_words;
    switch (op) {
      case 0: for (int64_t i = 0; i < n_words; ++i) out[i] |= row[i]; break;
      case 1: for (int64_t i = 0; i < n_words; ++i) out[i] &= row[i]; break;
      default: for (int64_t i = 0; i < n_words; ++i) out[i] ^= row[i]; break;
    }
  }
  return rb_popcount_words(out, n_words);
}

// ---------------------------------------------------------------------------
// runs
// ---------------------------------------------------------------------------

// (starts, lengths) from sorted unique values; returns run count.
// lengths follow the spec convention: run covers [start, start+length].
int32_t rb_runs_from_values(const in_u16* v, int32_t n, uint16_t* starts,
                            uint16_t* lengths) {
  if (n == 0) return 0;
  int32_t r = 0;
  uint16_t start = v[0], prev = v[0];
  for (int32_t i = 1; i < n; ++i) {
    if (v[i] != (uint16_t)(prev + 1)) {
      starts[r] = start;
      lengths[r] = (uint16_t)(prev - start);
      ++r;
      start = v[i];
    }
    prev = v[i];
  }
  starts[r] = start;
  lengths[r] = (uint16_t)(prev - start);
  return r + 1;
}

int32_t rb_num_runs_values(const in_u16* v, int32_t n) {
  if (n == 0) return 0;
  int32_t r = 1;
  for (int32_t i = 1; i < n; ++i) r += (v[i] != (uint16_t)(v[i - 1] + 1));
  return r;
}

// Fill a 1024-word bitset from disjoint half-open [start, end) intervals —
// the RunContainer -> words expansion (RunContainer.toBitmapContainer
// analogue). The numpy boundary-cumsum fallback pays ~200us in the int8 ->
// int32 cumsum; this is a direct masked-word fill.
void rb_words_from_intervals(const int64_t* starts, const int64_t* ends,
                             int32_t n, uint64_t* words) {
  for (int32_t i = 0; i < n; ++i) {
    int64_t s = starts[i], e = ends[i];
    // clamp to the 2^16 sub-universe: a hostile mapped run payload
    // (e.g. start=0xFFFF, length=0xFFFF) must not write past words[1023]
    if (s < 0) s = 0;
    if (e > 65536) e = 65536;
    if (e <= s) continue;
    int64_t sw = s >> 6, ew = (e - 1) >> 6;
    uint64_t first = ~0ULL << (s & 63);
    uint64_t last = ~0ULL >> (63 - ((e - 1) & 63));
    if (sw == ew) {
      words[sw] |= first & last;
    } else {
      words[sw] |= first;
      for (int64_t w = sw + 1; w < ew; ++w) words[w] = ~0ULL;
      words[ew] |= last;
    }
  }
}

// ---------------------------------------------------------------------------
// columnar batched pairwise algebra
//
// One call executes a whole batch of sorted-u16 container ops: pair j reads
// avals[aoffs[j]:aoffs[j+1]] x bvals[boffs[j]:boffs[j+1]] and writes its
// result at out + out_offs[j] (caller-computed worst-case bounds, so pairs
// are independent and the loop parallelizes). This is the per-type-pair
// kernel loop of the reference (Util.java unsigned*2by2 driven by
// RoaringBitmap's key merge) with the Python dispatch hoisted out of the
// per-container path entirely.
// ---------------------------------------------------------------------------

// op codes shared with columnar/kernels.py: 0=and 1=or 2=xor 3=andnot
void rb_batch_pairwise_u16(const in_u16* avals, const int64_t* aoffs,
                           const in_u16* bvals, const int64_t* boffs,
                           int64_t n_pairs, int32_t op,
                           const int64_t* out_offs, uint16_t* out,
                           int64_t* counts) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t j = 0; j < n_pairs; ++j) {
    const in_u16* a = avals + aoffs[j];
    const in_u16* b = bvals + boffs[j];
    int32_t na = (int32_t)(aoffs[j + 1] - aoffs[j]);
    int32_t nb = (int32_t)(boffs[j + 1] - boffs[j]);
    uint16_t* o = out + out_offs[j];
    switch (op) {
      case 0: counts[j] = rb_intersect_u16(a, na, b, nb, o); break;
      case 1: counts[j] = rb_union_u16(a, na, b, nb, o); break;
      case 2: counts[j] = rb_xor_u16(a, na, b, nb, o); break;
      default: counts[j] = rb_difference_u16(a, na, b, nb, o); break;
    }
  }
}

// ---- run-unified batch (arrays enter as length-0 runs) --------------------
//
// A container side is a sorted disjoint run list (start, length), run =
// [start, start+length]; an array container is its values with length 0.
// This single representation lets ONE kernel serve the aa/ar/ra/rr classes
// of AND/ANDNOT — the 4 of the reference's 9 type-pair kernels that matter
// for intersection-shaped ops — emitting result VALUES (intersections are
// small by construction; the or/xor classes go through the word path).

// intervals of (A AND B) as (start, length) pairs; returns interval count,
// accumulates result cardinality into *card. os==nullptr: card only.
static int64_t run_and_intervals(const in_u16* as, const in_u16* al,
                                 int32_t na, const in_u16* bs,
                                 const in_u16* bl, int32_t nb, uint16_t* os,
                                 uint16_t* ol, int64_t* card) {
  int32_t i = 0, j = 0;
  int64_t k = 0, c = 0;
  while (i < na && j < nb) {
    int32_t a0 = as[i], a1 = a0 + al[i];
    int32_t b0 = bs[j], b1 = b0 + bl[j];
    int32_t lo = a0 > b0 ? a0 : b0;
    int32_t hi = a1 < b1 ? a1 : b1;
    if (hi >= lo) {
      c += hi - lo + 1;
      if (os) {
        os[k] = (uint16_t)lo;
        ol[k] = (uint16_t)(hi - lo);
      }
      ++k;
    }
    if (a1 < b1) ++i; else ++j;
  }
  *card = c;
  return k;
}

// intervals of (A ANDNOT B)
static int64_t run_andnot_intervals(const in_u16* as, const in_u16* al,
                                    int32_t na, const in_u16* bs,
                                    const in_u16* bl, int32_t nb,
                                    uint16_t* os, uint16_t* ol, int64_t* card) {
  int32_t j = 0;
  int64_t k = 0, c = 0;
  for (int32_t i = 0; i < na; ++i) {
    int32_t a0 = as[i], a1 = a0 + al[i];
    while (j < nb && (int32_t)(bs[j] + bl[j]) < a0) ++j;
    int32_t jj = j, cur = a0;
    while (cur <= a1) {
      if (jj < nb && (int32_t)bs[jj] <= cur) {
        int32_t be = bs[jj] + bl[jj];
        ++jj;
        if (be >= cur) cur = be + 1;
        continue;
      }
      int32_t stop = a1;
      if (jj < nb && (int32_t)bs[jj] <= a1) stop = bs[jj] - 1;
      c += stop - cur + 1;
      if (os) {
        os[k] = (uint16_t)cur;
        ol[k] = (uint16_t)(stop - cur);
      }
      ++k;
      cur = stop + 1;
    }
  }
  *card = c;
  return k;
}

// Whole-batch run-unified pairwise: pair j reads run lists
// (as, al)[aoffs[j]:aoffs[j+1]] x (bs, bl)[boffs[j]:boffs[j+1]] and writes
// result INTERVALS at out_s/out_l + out_offs[j] (bounds: na+nb intervals —
// payload-sized, never cardinality-sized, so run-shaped results stay
// compressed end to end). op: 0=and 3=andnot. out_s==nullptr -> cards only.
void rb_batch_run_pairwise(const in_u16* as, const in_u16* al,
                           const int64_t* aoffs, const in_u16* bs,
                           const in_u16* bl, const int64_t* boffs,
                           int64_t n_pairs, int32_t op, const int64_t* out_offs,
                           uint16_t* out_s, uint16_t* out_l, int64_t* counts,
                           int64_t* cards) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t j = 0; j < n_pairs; ++j) {
    const in_u16* a_s = as + aoffs[j];
    const in_u16* a_l = al + aoffs[j];
    int32_t na = (int32_t)(aoffs[j + 1] - aoffs[j]);
    const in_u16* b_s = bs + boffs[j];
    const in_u16* b_l = bl + boffs[j];
    int32_t nb = (int32_t)(boffs[j + 1] - boffs[j]);
    uint16_t* os = out_s ? out_s + out_offs[j] : nullptr;
    uint16_t* ol = out_l ? out_l + out_offs[j] : nullptr;
    counts[j] = (op == 0)
                    ? run_and_intervals(a_s, a_l, na, b_s, b_l, nb, os, ol,
                                        cards + j)
                    : run_andnot_intervals(a_s, a_l, na, b_s, b_l, nb, os, ol,
                                           cards + j);
  }
}

// cardinality-only AND batch: no output buffer, no materialization
void rb_batch_intersect_card_u16(const in_u16* avals, const int64_t* aoffs,
                                 const in_u16* bvals, const int64_t* boffs,
                                 int64_t n_pairs, int64_t* counts) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t j = 0; j < n_pairs; ++j) {
    counts[j] = rb_intersect_u16(
        avals + aoffs[j], (int32_t)(aoffs[j + 1] - aoffs[j]),
        bvals + boffs[j], (int32_t)(boffs[j + 1] - boffs[j]), nullptr);
  }
}

// per-row popcount of an [n_rows, n_words] matrix (batched result
// cardinalities; rows are independent)
void rb_popcount_rows(const in_u64* words, int64_t n_rows, int64_t n_words,
                      int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rows; ++r)
    out[r] = rb_popcount_words(words + r * n_words, n_words);
}

// Scatter sorted-u16 container values into [*, 1024]-word rows, container j
// targeting row row_ids[j] with combine op 0=or 1=xor 2=clear (andnot).
// SERIAL over containers: unlike rb_pack_array_rows, row_ids may repeat
// (fold accumulators), so the parallel-for would race.
void rb_scatter_values_rows(const int64_t* row_ids, const int64_t* offsets,
                            int64_t n_containers, const in_u16* vals,
                            uint64_t* out, int32_t op) {
  for (int64_t j = 0; j < n_containers; ++j) {
    uint64_t* row = out + row_ids[j] * 1024;
    for (int64_t i = offsets[j]; i < offsets[j + 1]; ++i) {
      uint16_t v = vals[i];
      uint64_t bit = 1ULL << (v & 63);
      switch (op) {
        case 0: row[v >> 6] |= bit; break;
        case 1: row[v >> 6] ^= bit; break;
        default: row[v >> 6] &= ~bit; break;
      }
    }
  }
}

// Fill disjoint half-open [start, end) intervals into word rows: container
// j's runs (starts/ends[run_offs[j]:run_offs[j+1]]) land in row row_ids[j]
// with op 0=or 1=xor. The batched twin of rb_words_from_intervals — one
// call expands every run container of a working set. Serial: rows repeat.
void rb_fill_intervals_rows(const int64_t* row_ids, const int64_t* run_offs,
                            int64_t n_containers, const int64_t* starts,
                            const int64_t* ends, uint64_t* out, int32_t op) {
  for (int64_t j = 0; j < n_containers; ++j) {
    uint64_t* words = out + row_ids[j] * 1024;
    for (int64_t i = run_offs[j]; i < run_offs[j + 1]; ++i) {
      int64_t s = starts[i], e = ends[i];
      if (s < 0) s = 0;
      if (e > 65536) e = 65536;
      if (e <= s) continue;
      int64_t sw = s >> 6, ew = (e - 1) >> 6;
      uint64_t first = ~0ULL << (s & 63);
      uint64_t last = ~0ULL >> (63 - ((e - 1) & 63));
      if (op == 0) {
        if (sw == ew) {
          words[sw] |= first & last;
        } else {
          words[sw] |= first;
          for (int64_t w = sw + 1; w < ew; ++w) words[w] = ~0ULL;
          words[ew] |= last;
        }
      } else {  // xor: runs within a container are disjoint, so ^= is exact
        if (sw == ew) {
          words[sw] ^= first & last;
        } else {
          words[sw] ^= first;
          for (int64_t w = sw + 1; w < ew; ++w) words[w] ^= ~0ULL;
          words[ew] ^= last;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// batch packing (device-store marshal)
// ---------------------------------------------------------------------------

// Scatter many array containers' values into an [n_rows, 1024]-word matrix
// in one pass: container j (values vals[offsets[j]:offsets[j+1]]) lands in
// row row_ids[j]. The SoA packing hot loop of parallel/store.pack_rows_host.
void rb_pack_array_rows(const int64_t* row_ids, const int64_t* offsets,
                        int64_t n_containers, const in_u16* vals,
                        uint64_t* out) {
  // each container owns its output row exclusively, so the container loop
  // parallelizes race-free (the pack of a 10k-bitmap working set scatters
  // into ~600 MB and was the dominant one-time setup cost)
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t j = 0; j < n_containers; ++j) {
    uint64_t* row = out + row_ids[j] * 1024;
    for (int64_t i = offsets[j]; i < offsets[j + 1]; ++i) {
      uint16_t v = vals[i];
      row[v >> 6] |= 1ull << (v & 63);
    }
  }
}

}  // extern "C"
