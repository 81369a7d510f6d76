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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#include "quad.cuh"

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

template <int NDIMS>
__global__ void __launch_bounds__(kThreads)
zscan_count_kernel(const int* __restrict__ bins,
                   const uint32_t* __restrict__ zh,
                   const uint32_t* __restrict__ zl, long long n,
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
    c += __popc(quad_hits<NDIMS>(bins, zh, zl, 4 * i, n, tab, entry_of, first, span));
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

template <int NDIMS>
__global__ void __launch_bounds__(kThreads)
zscan_mask_kernel(const int* __restrict__ bins,
                  const uint32_t* __restrict__ zh,
                  const uint32_t* __restrict__ zl, long long n,
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
    const uint32_t bits = quad_hits<NDIMS>(bins, zh, zl, row, n, tab, entry_of, first, span);
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

template <int NDIMS>
void launch(const int* bins, const uint32_t* zh, const uint32_t* zl,
            long long n, const uint32_t* table, int nb, int first, int span,
            int want_mask, void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  // room for one entry at least: a row without an entry reads entry 0
  const size_t smem = ((size_t)(nb > 0 ? nb : 1) * NDIMS * 6 + span) * sizeof(uint32_t);
  if (want_mask) {
    zscan_mask_kernel<NDIMS><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, n, table, nb, first, span, static_cast<uint8_t*>(out));
  } else {
    zscan_count_kernel<NDIMS><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, n, table, nb, first, span, static_cast<int*>(out));
  }
}

// -- the Q-batched interleaved scan -------------------------------------------
//
// Q queries over the same key planes in one pass: the fused loose count and
// mask of the device query scheduler. The reference computes them with an
// XLA vmap of z3_zscan_mask / z2_zscan_mask (geomesa_tpu/ops/zscan.py:816,
// batched_kind_mask), not with a Pallas kernel. Each thread loads its quad
// of rows (bin, hi and lo words) once and looks each query's entry up in
// that query's bin table, as the single-query kernel does. The packed
// table holds per query a header {bounds offset, bin-table offset, first
// bin, span} (4 words each, nq of them first), then each query's bound
// entries and bin table (ops/zscan.py _BatchedZScan builds it); z2 queries
// have one entry and no bin table. Blocks read the table in place through
// the read-only cache (64 queries of 2 week bins take 11 KB, 64 of many
// bins and long spans more than shared memory holds); only the headers are
// copied to shared memory. Padding never matches: a
// query's ids < 0 have no place in its bin table, and a padded query has
// an empty table. The count reduces each query per warp into per-warp
// counters in shared memory, then one atomic per block and query; the mask
// writes a (Q, n) byte matrix, one contiguous row per query.

constexpr int kMaxBatch = 64;
constexpr int kWarps = kThreads / 32;

struct BQuad {
  int4 b;
  uint4 h, l;
  long long rows;
};

template <int NDIMS>
__device__ __forceinline__ BQuad load_bquad(const int* bins, const uint32_t* zh,
                                            const uint32_t* zl, long long row,
                                            long long n) {
  BQuad d;
  d.rows = n - row;
  d.b = make_int4(0, 0, 0, 0);
  if (d.rows >= 4) {
    d.h = load4(zh, row);
    d.l = load4(zl, row);
    if (NDIMS == 3) d.b = __ldg(reinterpret_cast<const int4*>(bins + row));
    return d;
  }
  int b[4] = {0, 0, 0, 0};
  uint32_t h[4] = {0, 0, 0, 0}, l[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r < d.rows) {
      h[r] = zh[row + r];
      l[r] = zl[row + r];
      if (NDIMS == 3) b[r] = bins[row + r];
    }
  }
  d.b = make_int4(b[0], b[1], b[2], b[3]);
  d.h = make_uint4(h[0], h[1], h[2], h[3]);
  d.l = make_uint4(l[0], l[1], l[2], l[3]);
  return d;
}

// Hits of a quad's rows for the query with header `hd` over `tab`, as bits
// 0..3; rows at or past n are 0.
template <int NDIMS>
__device__ __forceinline__ uint32_t bquad_bits(const BQuad& d, const int4& hd,
                                               const uint32_t* tab) {
  const uint32_t* bounds = tab + hd.x;
  const int* entry_of = reinterpret_cast<const int*>(tab + hd.y);
  const uint32_t bits =
      row_hit<NDIMS>(d.b.x, d.h.x, d.l.x, bounds, entry_of, hd.z, hd.w) |
      (row_hit<NDIMS>(d.b.y, d.h.y, d.l.y, bounds, entry_of, hd.z, hd.w) << 1) |
      (row_hit<NDIMS>(d.b.z, d.h.z, d.l.z, bounds, entry_of, hd.z, hd.w) << 2) |
      (row_hit<NDIMS>(d.b.w, d.h.w, d.l.w, bounds, entry_of, hd.z, hd.w) << 3);
  return d.rows >= 4 ? bits : (d.rows <= 0 ? 0u : bits & ((1u << d.rows) - 1u));
}

// The block's copy of the query headers (shared memory).
__device__ __forceinline__ void stage_headers(const uint32_t* table, int nq, int4* hdr) {
  const int4* h = reinterpret_cast<const int4*>(table);
  for (int q = threadIdx.x; q < nq; q += blockDim.x) hdr[q] = h[q];
}

template <int NDIMS>
__global__ void __launch_bounds__(kThreads)
zscan_batched_count_kernel(const int* __restrict__ bins,
                           const uint32_t* __restrict__ zh,
                           const uint32_t* __restrict__ zl, long long n,
                           const uint32_t* __restrict__ tab, int nq,
                           int* __restrict__ out) {
  __shared__ int4 hdr[kMaxBatch];
  __shared__ int counts[kWarps][kMaxBatch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_headers(tab, nq, hdr);
  for (int q = lane; q < kMaxBatch; q += 32) counts[warp][q] = 0;
  __syncthreads();
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the warp's first quad: every lane of a warp runs the same iterations,
  // as __reduce_add_sync needs; lanes past the end count nothing
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < quads; base += stride) {
    const BQuad d = load_bquad<NDIMS>(bins, zh, zl, 4 * (base + lane), n);
    for (int q = 0; q < nq; ++q) {
      const int c = __reduce_add_sync(0xffffffffu, __popc(bquad_bits<NDIMS>(d, hdr[q], tab)));
      if (lane == 0) counts[warp][q] += c;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += counts[w][q];
    if (t) atomicAdd(out + q, t);
  }
}

template <int NDIMS>
__global__ void __launch_bounds__(kThreads)
zscan_batched_mask_kernel(const int* __restrict__ bins,
                          const uint32_t* __restrict__ zh,
                          const uint32_t* __restrict__ zl, long long n,
                          const uint32_t* __restrict__ tab, int nq,
                          uint8_t* __restrict__ out) {
  __shared__ int4 hdr[kMaxBatch];
  stage_headers(tab, nq, hdr);
  __syncthreads();
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const BQuad d = load_bquad<NDIMS>(bins, zh, zl, 4 * i, n);
    for (int q = 0; q < nq; ++q) store_bits(out, n, q, 4 * i, bquad_bits<NDIMS>(d, hdr[q], tab));
  }
}

template <int NDIMS>
void launch_batched(const int* bins, const uint32_t* zh, const uint32_t* zl,
                    long long n, const uint32_t* table, int nq, int want_mask,
                    void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  if (want_mask) {
    zscan_batched_mask_kernel<NDIMS><<<grid, kThreads, 0, stream>>>(
        bins, zh, zl, n, table, nq, static_cast<uint8_t*>(out));
  } else {
    zscan_batched_count_kernel<NDIMS><<<grid, kThreads, 0, stream>>>(
        bins, zh, zl, n, table, nq, static_cast<int*>(out));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `table` is DEVICE memory laid
// out as above (n_entries entries of n_dims * 6 words, then, binned, the
// span int32 words of the bin table from bin `first`); `bins` is null for
// n_dims == 2, which takes one entry and no bin table. For the count,
// `out` is one int32 that this call zeroes on `stream` first. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gm_zscan(const int* bins, const uint32_t* zh, const uint32_t* zl,
                        long long n, const uint32_t* table, int n_entries,
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
      launch<3>(bins, zh, zl, n, table, n_entries, first, span, want_mask,
                out, stream);
    } else {
      launch<2>(nullptr, zh, zl, n, table, n_entries, 0, 0, want_mask, out,
                stream);
    }
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the batched scan (bound with ctypes). `table` is
// DEVICE memory of `words` uint32 laid out as above for nq queries,
// 1 <= nq <= 64; `bins` is null for n_dims == 2. For the count, `out` is
// nq int32 that this call zeroes on `stream` first; for the mask, nq * n
// bytes, row q holding query q's hits. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int gm_zscan_batched(const int* bins, const uint32_t* zh,
                                const uint32_t* zl, long long n,
                                const uint32_t* table, int words, int nq,
                                int n_dims, int want_mask, void* out,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nq < 1 || nq > kMaxBatch || words < 4 * nq || (n_dims != 2 && n_dims != 3) ||
      (n_dims == 3 && bins == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * nq, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    if (n_dims == 3) {
      launch_batched<3>(bins, zh, zl, n, table, nq, want_mask, out, stream);
    } else {
      launch_batched<2>(nullptr, zh, zl, n, table, nq, want_mask, out, stream);
    }
  }
  return (int)cudaGetLastError();
}
