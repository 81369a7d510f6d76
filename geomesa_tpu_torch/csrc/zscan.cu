// Interleaved masked-compare key scan: count and mask over the Morton key
// planes (z_hi, z_lo: the two uint32 words of the key) and, for time-binned
// Z3 keys, the int32 period-bin plane, with runtime query bounds.
//
// Replaces: geomesa_tpu/ops/zscan.py::build_z3_pallas_scan (count
// pallas_call at zscan.py:942, mask at :960). The same kernel, without the
// bin plane and with 2 dimensions, computes z2_zscan_mask (zscan.py:97), so
// interleaved Z2 indexes are served by it too.
//
// The table holds, per entry b, NDIMS x (mask_hi, mask_lo, lo_hi, lo_lo,
// hi_hi, hi_lo), then, for time-binned Z3 keys, a dense int32 table
// entry_of[bin - first] of `span` words: the entry of each bin from the
// least to the greatest entry id, -1 for a bin no entry has (the wrapper
// builds it: ops/zscan.py::entry_table). With z = hi:lo as a 64-bit word,
// dimension d of entry b matches when lo_d <= (z & mask_d) <= hi_d,
// unsigned. A binned row matches when its bin has an entry and that entry
// matches in every dimension; padding entries (ids < 0) have no place in
// the table and never match; an unbinned row matches the single entry.
//
// Bound on this card: bytes. A row reads 12 B (8 B unbinned) and writes
// 1 B for the mask. Per row the work is one bin lookup (a 64-bit subtract,
// an unsigned range check and a shared-memory load) and one entry's masked
// compares (about 8 integer operations per dimension), whatever the number
// of bins: the TPU kernel evaluates every entry for every row (about 25 *
// B operations), and this kernel's first version walked every entry per
// row (an id load, compares and a branch each). Rows are read 4 at a time
// with 16-byte loads, the planes in place, the ragged tail by scalar loads.
// The bounds (at most 512 entries, 36 KB) and the bin table (at most 2,048
// bins, 8 KB) are runtime data staged once per block in shared memory, so
// one build serves every window. The count reduces per warp and per block,
// then adds with one integer atomic per block: exact and order-independent.
//
// Validity (a streaming index's live rows, valid.cuh): with a plane, a row
// counts, and its mask byte is set, only where its verdict and its validity
// byte are both set; 1 B/row more, one 32-bit load a quad. The read is a
// template parameter chosen by the pointer on the host, so a launch without
// a plane runs the code it ran before.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

#include "quad.cuh"
#include "valid.cuh"

constexpr int kMaxEntries = 512;
constexpr int kMaxSpan = 2048;

template <int NDIMS>
__device__ __forceinline__ uint32_t entry_hit(unsigned long long z,
                                              const uint32_t* e) {
  uint32_t ok = 1;
#pragma unroll
  for (int d = 0; d < NDIMS; ++d) {
    const uint32_t* w = e + 6 * d;
    const unsigned long long zm =
        z & (((unsigned long long)w[0] << 32) | w[1]);
    const unsigned long long lo = ((unsigned long long)w[2] << 32) | w[3];
    const unsigned long long hi = ((unsigned long long)w[4] << 32) | w[5];
    ok &= (uint32_t)(zm >= lo) & (uint32_t)(zm <= hi);
  }
  return ok;
}

// NDIMS == 3: binned (bins != nullptr); NDIMS == 2: unbinned, one entry.
template <int NDIMS>
__device__ __forceinline__ uint32_t row_hit(int bin, uint32_t zh, uint32_t zl,
                                            const uint32_t* tab,
                                            const int* entry_of, int first,
                                            int span) {
  const unsigned long long z = ((unsigned long long)zh << 32) | zl;
  if (NDIMS == 2) return entry_hit<2>(z, tab);
  // in 64 bits, so that no bin wraps into the table; no branch, so that
  // the 4 rows of a quad issue their table loads together (a row without
  // an entry compares against entry 0 and drops the answer)
  const unsigned long long off =
      (unsigned long long)((long long)bin - (long long)first);
  const int e = off < (unsigned long long)span ? entry_of[off] : -1;
  return entry_hit<NDIMS>(z, tab + (e < 0 ? 0 : e) * NDIMS * 6) & (uint32_t)(e >= 0);
}

// Hits of the 4 rows starting at `row` (a multiple of 4), as bits 0..3;
// rows at or past n read nothing and are 0.
template <int NDIMS>
__device__ __forceinline__ uint32_t quad_hits(const int* bins,
                                              const uint32_t* zh,
                                              const uint32_t* zl, long long row,
                                              long long n, const uint32_t* tab,
                                              const int* entry_of, int first,
                                              int span) {
  if (row + 4 <= n) {
    const uint4 h = load4(zh, row);
    const uint4 l = load4(zl, row);
    int4 b = make_int4(0, 0, 0, 0);
    if (NDIMS == 3) b = __ldg(reinterpret_cast<const int4*>(bins + row));
    return row_hit<NDIMS>(b.x, h.x, l.x, tab, entry_of, first, span) |
           (row_hit<NDIMS>(b.y, h.y, l.y, tab, entry_of, first, span) << 1) |
           (row_hit<NDIMS>(b.z, h.z, l.z, tab, entry_of, first, span) << 2) |
           (row_hit<NDIMS>(b.w, h.w, l.w, tab, entry_of, first, span) << 3);
  }
  uint32_t bits = 0;
  for (int r = 0; r < 4 && row + r < n; ++r) {
    const long long i = row + r;
    const int b = NDIMS == 3 ? bins[i] : 0;
    bits |= row_hit<NDIMS>(b, zh[i], zl[i], tab, entry_of, first, span) << r;
  }
  return bits;
}

// The block's copy of the table: nb * NDIMS * 6 bound words, then the
// span words of the bin table.
template <int NDIMS>
__device__ __forceinline__ void stage_table(const uint32_t* table, int nb,
                                            int span, uint32_t* s) {
  const int words = nb * NDIMS * 6 + span;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = table[i];
  __syncthreads();
}

template <int NDIMS, bool VALID>
__global__ void __launch_bounds__(kThreads)
zscan_count_kernel(const int* __restrict__ bins,
                   const uint32_t* __restrict__ zh,
                   const uint32_t* __restrict__ zl,
                   const uint8_t* __restrict__ valid, long long n,
                   const uint32_t* __restrict__ table, int nb, int first,
                   int span, int* __restrict__ out) {
  extern __shared__ uint32_t s[];
  stage_table<NDIMS>(table, nb, span, s);
  const uint32_t* tab = s;
  const int* entry_of = reinterpret_cast<const int*>(s + nb * NDIMS * 6);
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    uint32_t bits = quad_hits<NDIMS>(bins, zh, zl, 4 * i, n, tab, entry_of, first, span);
    if (VALID) bits &= valid_bits(valid, 4 * i, n);
    c += __popc(bits);
  }
  c = __reduce_add_sync(0xffffffffu, c);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kThreads / 32 ? warp_sums[lane] : 0;
    t = __reduce_add_sync(0xffffffffu, t);
    if (lane == 0 && t) atomicAdd(out, t);
  }
}

template <int NDIMS, bool VALID>
__global__ void __launch_bounds__(kThreads)
zscan_mask_kernel(const int* __restrict__ bins,
                  const uint32_t* __restrict__ zh,
                  const uint32_t* __restrict__ zl,
                  const uint8_t* __restrict__ valid, long long n,
                  const uint32_t* __restrict__ table, int nb, int first,
                  int span, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s[];
  stage_table<NDIMS>(table, nb, span, s);
  const uint32_t* tab = s;
  const int* entry_of = reinterpret_cast<const int*>(s + nb * NDIMS * 6);
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const long long row = 4 * i;
    uint32_t bits = quad_hits<NDIMS>(bins, zh, zl, row, n, tab, entry_of, first, span);
    if (VALID) bits &= valid_bits(valid, row, n);
    if (row + 4 <= n) {
      // one byte (0 or 1) per row, 4 rows per 32-bit store
      const uint32_t w = (bits & 1u) | ((bits >> 1 & 1u) << 8) |
                         ((bits >> 2 & 1u) << 16) | ((bits >> 3 & 1u) << 24);
      *reinterpret_cast<uint32_t*>(out + row) = w;
    } else {
      for (int r = 0; row + r < n; ++r) out[row + r] = (bits >> r) & 1u;
    }
  }
}

template <int NDIMS, bool VALID>
void launch_v(const int* bins, const uint32_t* zh, const uint32_t* zl, const uint8_t* valid,
              long long n, const uint32_t* table, int nb, int first, int span,
              int want_mask, void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  // room for one entry at least: a row without an entry reads entry 0
  const size_t smem = ((size_t)(nb > 0 ? nb : 1) * NDIMS * 6 + span) * sizeof(uint32_t);
  if (want_mask) {
    zscan_mask_kernel<NDIMS, VALID><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, valid, n, table, nb, first, span, static_cast<uint8_t*>(out));
  } else {
    zscan_count_kernel<NDIMS, VALID><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, valid, n, table, nb, first, span, static_cast<int*>(out));
  }
}

template <int NDIMS>
void launch(const int* bins, const uint32_t* zh, const uint32_t* zl, const uint8_t* valid,
            long long n, const uint32_t* table, int nb, int first, int span,
            int want_mask, void* out, cudaStream_t stream) {
  if (valid) {
    launch_v<NDIMS, true>(bins, zh, zl, valid, n, table, nb, first, span, want_mask, out, stream);
  } else {
    launch_v<NDIMS, false>(bins, zh, zl, valid, n, table, nb, first, span, want_mask, out,
                           stream);
  }
}

// -- the Q-batched interleaved scan -------------------------------------------
//
// Q queries over the same key planes in one pass: the fused loose count and
// mask of the device query scheduler. Replaces the XLA vmap of
// z3_zscan_mask / z2_zscan_mask that the reference runs for them
// (geomesa_tpu/ops/zscan.py:816, batched_kind_mask); it has no Pallas
// kernel.
//
// The host packs a group once (ops/zscan.py _BatchedZScan): only the real
// queries and their real entries (ids < 0 and entries with lo > hi in a
// dimension are dropped), as flat lists of records that carry their bin
// (0 for z2) and query. An entry whose masks are the dimension masks and
// whose bounds lie inside them (every cell box) is a compact record of 8
// words: per dimension the de-interleaved lo and hi (21 bits z3, 31 bits
// z2, whose third pair is 0), then bin and query. It matches exactly when
// the row's de-interleaved coordinates lie between them, as compaction is
// an order-preserving bijection on the values inside a mask. Any other
// entry, and a cell box where no row can meet more than one record (the
// de-interleave costs more than one masked compare: MASKED_MAX_MEET), is a
// masked record of 24 words: bin, query, 2 unused, then per dimension the
// 6 masked-compare words of entry_hit. A z3 launch of more
// than a few records (FLAT_MAX_RECORDS) sorts them by bin and ends its
// table with a bin index: per bin of its span, where its compact and its
// masked records start (int2).
//
// Bound on this card: the larger of the bytes (the planes once, 12 B a row
// z3, 8 B z2, and 1 B a row and query for the mask) and the compares' ALU
// operations, which grow with the records a row meets (z2: all of them;
// z3: its bin's).
// The first design read, per row and query, the query's bin table and its
// entry's 18 bound words from device memory through the read-only cache:
// about 44 instructions a row and query, 13% of the bound at Q = 64. Here:
// - each block copies its launch's table (at most 96 KB, so that two
//   blocks fit an SM) into shared memory once; a group past that is cut by
//   queries into several launches;
// - a thread loads a quad of rows and, when the group has compact records,
//   de-interleaves each key's first dimension (12 integer operations and 8
//   multiplies z3, the multiplies on their own pipe: gather), and its other
//   dimensions once, only when a record's first dimension holds the row;
// - with a bin index, each row reads only its own bin's records, a
//   dimension (8 bytes) at a time while it passes. Those shared-memory
//   reads bound this path when a warp's rows lie in many bins, as rows
//   staged in arrival order do; most rows leave a record after its first
//   dimension. Rows of one bin read the same words, a broadcast;
// - without one (z2, or a few records) every row tests every record, with
//   its bin, all lanes reading the same word at once;
// - hits gather in a 64-bit word per row, bit q for query q. The count
//   adds those words into vertical counters (bit planes; a carry ripples
//   only for a row with a hit), reduces them across the warp at most every
//   255 quads and adds one integer atomic per block and query: exact and
//   order-independent. The mask transposes a quad's 4 words by byte
//   permutes and writes each query's 4 bytes with one store into the
//   (Q, n) byte matrix. Both helpers live in quad.cuh, shared with the
//   batched dim scan.
// - with a validity plane, a dead row is not live: it meets no record, so
//   its hit word is 0 for the counters and the mask.

constexpr int kCompactWords = 8;
constexpr int kMaskedWords = 24;
constexpr long long kMaxTableBytes = 96 * 1024;

// A thread's 4 rows: bins (-1 past n: no record has a bin below 0), key
// words and de-interleaved coordinates.
struct Rows {
  int b[4];
  uint32_t h[4], l[4];
  uint32_t c[3][4];
  uint32_t rest;  // rows whose coordinates past the first are set
};

template <int NDIMS>
__device__ __forceinline__ void load_rows(Rows& d, const int* bins, const uint32_t* zh,
                                          const uint32_t* zl, long long row, long long n) {
  if (row + 4 <= n) {
    const uint4 h = load4(zh, row), l = load4(zl, row);
    int4 b = make_int4(0, 0, 0, 0);
    if (NDIMS == 3) b = __ldg(reinterpret_cast<const int4*>(bins + row));
    d.h[0] = h.x; d.h[1] = h.y; d.h[2] = h.z; d.h[3] = h.w;
    d.l[0] = l.x; d.l[1] = l.y; d.l[2] = l.z; d.l[3] = l.w;
    d.b[0] = b.x; d.b[1] = b.y; d.b[2] = b.z; d.b[3] = b.w;
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = row + r < n;
    d.h[r] = in ? zh[row + r] : 0u;
    d.l[r] = in ? zl[row + r] : 0u;
    d.b[r] = in ? (NDIMS == 3 ? bins[row + r] : 0) : -1;
  }
}

// The K bits of v & M at positions S k + o (S = 3 or 2), moved up to
// [T, T + K): each of the 4 steps copies the word with a multiply by
// (1 + 2^s), which carries nothing (no bit lands on another), and keeps the
// wanted copies, so half the work runs on the multiplier's pipe. The masks
// are worked out and checked against curves/zorder.py's combine for every
// key word.
template <uint32_t M, uint32_t A, uint32_t MA, uint32_t B, uint32_t MB, uint32_t C,
          uint32_t MC, uint32_t D, uint32_t MD>
__device__ __forceinline__ uint32_t gather(uint32_t v) {
  v &= M;
  v = (v * A) & MA;
  v = (v * B) & MB;
  v = (v * C) & MC;
  return (v * D) & MD;
}

// Row r's coordinates from its key z = h:l, as curves/zorder.py's combine
// of (z >> d): z3 dimension d takes bits 3k + d (11 or 10 of them in l, the
// rest in h), z2 dimension d bits 2k + d. The first dimension comes for
// every live row (coord_x); the others only for a row that passes some
// record's first dimension (coord_rest, once; `rest` marks such rows).
template <int NDIMS>
__device__ __forceinline__ void coord_x(Rows& d, int r) {
  const uint32_t h = d.h[r], l = d.l[r];
  if (NDIMS == 3) {  // l field [20, 31), h field [19, 29)
    const uint32_t xl = gather<0x49249249u, 5, 0x61861861u, 17, 0x78078070u, 257, 0x7f800070u,
                               65537, 0x7ff00000u>(l);
    const uint32_t xh = gather<0x12492492u, 5, 0x18618618u, 17, 0x1e01e018u, 257, 0x1fe00018u,
                               65537, 0x1ff80000u>(h);
    d.c[0][r] = (xl >> 20) | (xh >> 8);
  } else {  // l field [15, 31), h field [15, 30)
    const uint32_t xl = gather<0x55555555u, 3, 0x66666666u, 5, 0x78787878u, 17, 0x7f807f80u,
                               257, 0x7fff8000u>(l);
    const uint32_t xh = gather<0x15555555u, 3, 0x26666666u, 5, 0x38787878u, 17, 0x3f807f80u,
                               257, 0x3fff8000u>(h);
    d.c[0][r] = (xl >> 15) | (xh << 1);
  }
}

template <int NDIMS>
__device__ __forceinline__ void coord_rest(Rows& d, int r) {
  if ((d.rest >> r) & 1u) return;
  d.rest |= 1u << r;
  const uint32_t h = d.h[r], l = d.l[r];
  if (NDIMS == 3) {  // l y [21, 32) t [20, 30); h y [20, 30) t [20, 31)
    const uint32_t yl = gather<0x92492492u, 5, 0xc30c30c2u, 17, 0xf00f00e0u, 257, 0xff0000e0u,
                               65537, 0xffe00000u>(l);
    const uint32_t yh = gather<0x24924924u, 5, 0x30c30c30u, 17, 0x3c03c030u, 257, 0x3fc00030u,
                               65537, 0x3ff00000u>(h);
    const uint32_t tl = gather<0x24924924u, 5, 0x30c30c30u, 17, 0x3c03c030u, 257, 0x3fc00030u,
                               65537, 0x3ff00000u>(l);
    const uint32_t th = gather<0x49249249u, 5, 0x61861861u, 17, 0x78078070u, 257, 0x7f800070u,
                               65537, 0x7ff00000u>(h);
    d.c[1][r] = (yl >> 21) | (yh >> 9);
    d.c[2][r] = (tl >> 20) | (th >> 10);
  } else {  // l y [16, 32), h y [16, 31)
    const uint32_t yl = gather<0xaaaaaaaau, 3, 0xccccccccu, 5, 0xf0f0f0f0u, 17, 0xff00ff00u,
                               257, 0xffff0000u>(l);
    const uint32_t yh = gather<0x2aaaaaaau, 3, 0x4cccccccu, 5, 0x70f0f0f0u, 17, 0x7f00ff00u,
                               257, 0x7fff0000u>(h);
    d.c[1][r] = (yl >> 16) | yh;
  }
}

// Whether row r, inside compact record (a, b) = (lo0, hi0, lo1, hi1),
// (lo2, hi2, bin, query) in its first dimension, lies in the others.
template <int NDIMS>
__device__ __forceinline__ bool compact_rest(const uint4& a, const uint4& b, Rows& d, int r) {
  coord_rest<NDIMS>(d, r);
  bool ok = d.c[1][r] >= a.z && d.c[1][r] <= a.w;
  if (NDIMS == 3) ok = ok && d.c[2][r] >= b.x && d.c[2][r] <= b.y;
  return ok;
}

template <int NDIMS>
__device__ __forceinline__ uint32_t masked_hit(const uint32_t* e, const Rows& d, int r) {
  return entry_hit<NDIMS>(((unsigned long long)d.h[r] << 32) | d.l[r], e + 4);
}

// Row r's records [c0, c1) and [m0, m1): bit q of hits[r] for each one it
// lies in (the caller gives the records of row r's bin). A compact record
// is read a dimension at a time (8 bytes) and only while the row passes:
// most rows leave after the first, which halves the shared-memory reads
// that bound this path (lanes of rows in other bins read other records).
template <int NDIMS>
__device__ __forceinline__ void row_records(const uint32_t* comp, int c0, int c1,
                                            const uint32_t* mskd, int m0, int m1,
                                            Rows& d, int r, unsigned long long& hits) {
  for (int i = c0; i < c1; ++i) {
    const uint2* e = reinterpret_cast<const uint2*>(comp + (long long)i * kCompactWords);
    const uint2 x = e[0];
    if (d.c[0][r] < x.x || d.c[0][r] > x.y) continue;
    coord_rest<NDIMS>(d, r);
    const uint2 y = e[1];
    if (d.c[1][r] < y.x || d.c[1][r] > y.y) continue;
    if (NDIMS == 3) {
      const uint2 t = e[2];
      if (d.c[2][r] < t.x || d.c[2][r] > t.y) continue;
    }
    hits |= 1ull << e[3].y;
  }
  for (int i = m0; i < m1; ++i) {
    const uint32_t* e = mskd + (long long)i * kMaskedWords;
    if (masked_hit<NDIMS>(e, d, r)) hits |= 1ull << e[1];
  }
}

// Every record against the rows of its bin (z2: every live row), each
// record's words read by all lanes at once.
template <int NDIMS>
__device__ __forceinline__ void flat_records(const uint32_t* comp, int nc, const uint32_t* mskd,
                                             int nm, Rows& d, uint32_t live,
                                             unsigned long long (&hits)[4]) {
  for (int i = 0; i < nc; ++i) {
    const uint4 a = *reinterpret_cast<const uint4*>(comp + (long long)i * kCompactWords);
    const uint4 b = *reinterpret_cast<const uint4*>(comp + (long long)i * kCompactWords + 4);
    const unsigned long long bit = 1ull << b.w;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t in = (live >> r) & 1u;
      if (NDIMS == 3) in &= (uint32_t)(d.b[r] == (int)b.z);
      in &= (uint32_t)(d.c[0][r] >= a.x) & (uint32_t)(d.c[0][r] <= a.y);
      if (in && compact_rest<NDIMS>(a, b, d, r)) hits[r] |= bit;
    }
  }
  for (int i = 0; i < nm; ++i) {
    const uint32_t* e = mskd + (long long)i * kMaskedWords;
    const unsigned long long bit = 1ull << e[1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t in = (live >> r) & 1u;
      if (NDIMS == 3) in &= (uint32_t)(d.b[r] == (int)e[0]);
      if (in & masked_hit<NDIMS>(e, d, r)) hits[r] |= bit;
    }
  }
}

// BINNED: the table ends with the bin index (span + 1 int2: where bin
// first + i's compact and masked records start) and each row reads the
// records of its own bin; else every row tests every record (with its bin,
// z3). [first, first + span) holds every record's bin.
template <int NDIMS, bool MASK, bool BINNED, bool VALID>
__global__ void __launch_bounds__(kThreads)
zscan_group_kernel(const int* __restrict__ bins, const uint32_t* __restrict__ zh,
                   const uint32_t* __restrict__ zl, const uint8_t* __restrict__ valid,
                   long long n,
                   const uint32_t* __restrict__ table, int words, int nq, int nc, int nm,
                   int first, int span, void* __restrict__ out) {
  extern __shared__ uint4 stab[];
  __shared__ int counts[MASK ? 1 : kWarps][kMaxBatch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4* t4 = reinterpret_cast<const uint4*>(table);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) stab[i] = t4[i];
  if (!MASK)
    for (int q = lane; q < kMaxBatch; q += 32) counts[warp][q] = 0;
  __syncthreads();
  const uint32_t* comp = reinterpret_cast<const uint32_t*>(stab);
  const uint32_t* mskd = comp + (long long)nc * kCompactWords;
  const int2* index = reinterpret_cast<const int2*>(mskd + (long long)nm * kMaskedWords);
  int* wcount = counts[MASK ? 0 : warp];
  unsigned long long planes[kPlanes];
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) planes[i] = 0;
  int since = 0;
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the warp's first quad: every lane of a warp runs the same iterations,
  // as the count's warp reductions need; lanes past the end have no live row
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < quads; base += stride) {
    const long long row = 4 * (base + lane);
    Rows d;
    load_rows<NDIMS>(d, bins, zh, zl, row, n);
    unsigned long long hits[4] = {0ull, 0ull, 0ull, 0ull};
    int2 from[4], to[4];
    uint32_t live = 0;
    const uint32_t vb = VALID ? valid_bits(valid, row, n) : 0xfu;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // live: a valid row whose bin lies inside the span (in 64 bits, so
      // that no bin wraps into it) and, with the index, has records
      const unsigned long long off =
          (unsigned long long)((long long)d.b[r] - (long long)first);
      bool ok = off < (unsigned long long)span && ((vb >> r) & 1u);
      from[r] = to[r] = make_int2(0, 0);
      if (BINNED && ok) {
        from[r] = index[off];
        to[r] = index[off + 1];
        ok = from[r].x != to[r].x || from[r].y != to[r].y;
      }
      live |= (uint32_t)ok << r;
#pragma unroll
      for (int k = 0; k < 3; ++k) d.c[k][r] = 0u;
      if (BINNED && ok && nc > 0) coord_x<NDIMS>(d, r);
    }
    d.rest = 0;
    if (!BINNED && nc > 0 && live) {
#pragma unroll
      for (int r = 0; r < 4; ++r) coord_x<NDIMS>(d, r);
    }
    if (BINNED) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if ((live >> r) & 1u)
          row_records<NDIMS>(comp, from[r].x, to[r].x, mskd, from[r].y, to[r].y, d, r, hits[r]);
      }
    } else if (live) {
      flat_records<NDIMS>(comp, nc, mskd, nm, d, live, hits);
    }
    if (MASK) {
      if (row < n) store_quad(static_cast<uint8_t*>(out), n, nq, row, hits);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) count_hits(planes, hits[r]);
      if (++since == kFlushQuads) {
        flush_counts(planes, nq, wcount, lane);
        since = 0;
      }
    }
  }
  if (!MASK) {
    flush_counts(planes, nq, wcount, lane);
    __syncthreads();
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      int t = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += counts[w][q];
      if (t) atomicAdd(static_cast<int*>(out) + q, t);
    }
  }
}

template <int NDIMS, bool MASK, bool BINNED, bool VALID>
cudaError_t launch_group(const int* bins, const uint32_t* zh, const uint32_t* zl,
                         const uint8_t* valid, long long n, const uint32_t* table, int words,
                         int nq, int nc, int nm, int first, int span, void* out,
                         cudaStream_t stream) {
  auto kern = zscan_group_kernel<NDIMS, MASK, BINNED, VALID>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxTableBytes);
  if (attr != cudaSuccess) return attr;
  kern<<<grid_for(n), kThreads, (size_t)words * sizeof(uint32_t), stream>>>(
      bins, zh, zl, valid, n, table, words, nq, nc, nm, first, span, out);
  return cudaGetLastError();
}

template <int NDIMS, bool VALID>
cudaError_t launch_batched_v(const int* bins, const uint32_t* zh, const uint32_t* zl,
                             const uint8_t* valid, long long n, const uint32_t* table, int words,
                             int nq, int nc, int nm, int first, int span, bool binned, bool mask,
                             void* out, cudaStream_t stream) {
  if (mask) {
    return binned ? launch_group<NDIMS, true, true, VALID>(bins, zh, zl, valid, n, table, words,
                                                           nq, nc, nm, first, span, out, stream)
                  : launch_group<NDIMS, true, false, VALID>(bins, zh, zl, valid, n, table, words,
                                                            nq, nc, nm, first, span, out, stream);
  }
  return binned ? launch_group<NDIMS, false, true, VALID>(bins, zh, zl, valid, n, table, words,
                                                          nq, nc, nm, first, span, out, stream)
                : launch_group<NDIMS, false, false, VALID>(bins, zh, zl, valid, n, table, words,
                                                           nq, nc, nm, first, span, out, stream);
}

template <int NDIMS>
cudaError_t launch_batched(const int* bins, const uint32_t* zh, const uint32_t* zl,
                           const uint8_t* valid, long long n, const uint32_t* table, int words,
                           int nq, int nc, int nm, int first, int span, bool binned, bool mask,
                           void* out, cudaStream_t stream) {
  return valid ? launch_batched_v<NDIMS, true>(bins, zh, zl, valid, n, table, words, nq, nc, nm,
                                               first, span, binned, mask, out, stream)
               : launch_batched_v<NDIMS, false>(bins, zh, zl, valid, n, table, words, nq, nc, nm,
                                                first, span, binned, mask, out, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). `table` is DEVICE memory laid
// out as above (n_entries entries of n_dims * 6 words, then, binned, the
// span int32 words of the bin table from bin `first`); `bins` is null for
// n_dims == 2, which takes one entry and no bin table; `valid` is null
// (every row live) or n bytes, 4-byte aligned, 0 for a dead row. For the
// count, `out` is one int32 that this call zeroes on `stream` first. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gm_zscan(const int* bins, const uint32_t* zh, const uint32_t* zl,
                        const uint8_t* valid, long long n, const uint32_t* table, int n_entries,
                        int first, int span, int n_dims, int want_mask,
                        void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_entries < 0 || n_entries > kMaxEntries || span < 0 || span > kMaxSpan)
    return (int)cudaErrorInvalidValue;
  // an empty plane may have a null pointer
  if (n_dims == 3 ? (bins == nullptr && n > 0)
                  : (n_dims != 2 || n_entries != 1 || span != 0))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    if (n_dims == 3) {
      launch<3>(bins, zh, zl, valid, n, table, n_entries, first, span, want_mask,
                out, stream);
    } else {
      launch<2>(nullptr, zh, zl, valid, n, table, n_entries, 0, 0, want_mask, out,
                stream);
    }
  }
  return (int)cudaGetLastError();
}


// Plain C entry point of the batched scan (bound with ctypes). `table` is
// DEVICE memory of `words` uint32, 16-byte aligned, laid out as above for
// nq queries (1 <= nq <= 64, record queries < nq): n_compact compact
// records, n_masked masked records, then, binned, the bin index of span + 1
// int2 padded to a multiple of 4 words. Every record's bin lies in [first,
// first + span); z2 (n_dims 2, `bins` null) takes first 0, span 1 and no
// index; `valid` as for gm_zscan. For the count, `out` is nq int32 that
// this call zeroes on `stream` first; for the mask, nq * n bytes, row q holding query q's
// hits. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int gm_zscan_batched(const int* bins, const uint32_t* zh,
                                const uint32_t* zl, const uint8_t* valid, long long n,
                                const uint32_t* table, int words, int nq,
                                int n_compact, int n_masked, int first, int span,
                                int binned, int n_dims, int want_mask, void* out,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long index_words = binned ? (2LL * (span + 1LL) + 3) / 4 * 4 : 0;
  const long long need = (long long)n_compact * kCompactWords +
                         (long long)n_masked * kMaskedWords + index_words;
  if (nq < 1 || nq > kMaxBatch || (n_dims != 2 && n_dims != 3) || n_compact < 0 ||
      n_masked < 0 || n_compact + n_masked < 1 || span < 1 || words != need ||
      need * (long long)sizeof(uint32_t) > kMaxTableBytes ||
      (n_dims == 2 && (binned || first != 0 || span != 1)) ||
      (n_dims == 3 && bins == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * nq, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const cudaError_t e =
        n_dims == 3
            ? launch_batched<3>(bins, zh, zl, valid, n, table, words, nq, n_compact, n_masked,
                                first, span, binned != 0, want_mask != 0, out, stream)
            : launch_batched<2>(nullptr, zh, zl, valid, n, table, words, nq, n_compact,
                                n_masked, 0, 1, false, want_mask != 0, out, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
