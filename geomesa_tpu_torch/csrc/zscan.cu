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
// hi_hi, hi_lo), then one int32 id per entry. With z = hi:lo as a 64-bit
// word, dimension d of entry b matches when lo_d <= (z & mask_d) <= hi_d,
// unsigned. A binned row matches when some entry with id == its bin (and
// id >= 0: negative ids are padding and never match) matches in every
// dimension; an unbinned row when the single entry matches.
//
// Bound on this card: bytes at a bin or two, operations beyond. A row reads
// 12 B (8 B unbinned) and writes 1 B for the mask. Per entry the row pays
// an id compare; only an entry whose id equals the row's bin pays the
// masked compares (about 8 integer operations per dimension), and a warp
// skips an entry none of its rows' bins match. So a window of B bins costs
// about 2 * B + 25 operations per matching row. The TPU kernel evaluates
// every entry for every row (about 25 * B); a lookup from bin to entry
// would remove the per-entry loop and is left for a later change. Rows are
// read 4 at a time with 16-byte loads, the planes in place, the ragged
// tail by scalar loads. The table (at most 512 entries, 38 KB) is runtime
// data staged once per block in shared memory, so one build serves every
// window. The count reduces per warp and per block, then adds with one
// integer atomic per block: exact and order-independent.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 512;

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
                                            const int* ids, int nb) {
  const unsigned long long z = ((unsigned long long)zh << 32) | zl;
  if (NDIMS == 2) return entry_hit<2>(z, tab);
  uint32_t hit = 0;
  for (int b = 0; b < nb; ++b) {
    const int id = ids[b];
    if (id < 0 || id != bin) continue;
    hit |= entry_hit<NDIMS>(z, tab + b * NDIMS * 6);
  }
  return hit;
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, long long row) {
  return __ldg(reinterpret_cast<const uint4*>(p + row));
}

// Hits of the 4 rows starting at `row` (a multiple of 4), as bits 0..3;
// rows at or past n read nothing and are 0.
template <int NDIMS>
__device__ __forceinline__ uint32_t quad_hits(const int* bins,
                                              const uint32_t* zh,
                                              const uint32_t* zl, long long row,
                                              long long n, const uint32_t* tab,
                                              const int* ids, int nb) {
  if (row + 4 <= n) {
    const uint4 h = load4(zh, row);
    const uint4 l = load4(zl, row);
    int4 b = make_int4(0, 0, 0, 0);
    if (NDIMS == 3) b = __ldg(reinterpret_cast<const int4*>(bins + row));
    return row_hit<NDIMS>(b.x, h.x, l.x, tab, ids, nb) |
           (row_hit<NDIMS>(b.y, h.y, l.y, tab, ids, nb) << 1) |
           (row_hit<NDIMS>(b.z, h.z, l.z, tab, ids, nb) << 2) |
           (row_hit<NDIMS>(b.w, h.w, l.w, tab, ids, nb) << 3);
  }
  uint32_t bits = 0;
  for (int r = 0; r < 4 && row + r < n; ++r) {
    const long long i = row + r;
    const int b = NDIMS == 3 ? bins[i] : 0;
    bits |= row_hit<NDIMS>(b, zh[i], zl[i], tab, ids, nb) << r;
  }
  return bits;
}

// The block's copy of the table: nb * NDIMS * 6 bound words, then nb ids.
template <int NDIMS>
__device__ __forceinline__ void stage_table(const uint32_t* table, int nb,
                                            uint32_t* s) {
  const int words = nb * (NDIMS * 6 + 1);
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = table[i];
  __syncthreads();
}

template <int NDIMS>
__global__ void __launch_bounds__(kThreads)
zscan_count_kernel(const int* __restrict__ bins,
                   const uint32_t* __restrict__ zh,
                   const uint32_t* __restrict__ zl, long long n,
                   const uint32_t* __restrict__ table, int nb,
                   int* __restrict__ out) {
  extern __shared__ uint32_t s[];
  stage_table<NDIMS>(table, nb, s);
  const uint32_t* tab = s;
  const int* ids = reinterpret_cast<const int*>(s + nb * NDIMS * 6);
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    c += __popc(quad_hits<NDIMS>(bins, zh, zl, 4 * i, n, tab, ids, nb));
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
                  const uint32_t* __restrict__ table, int nb,
                  uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s[];
  stage_table<NDIMS>(table, nb, s);
  const uint32_t* tab = s;
  const int* ids = reinterpret_cast<const int*>(s + nb * NDIMS * 6);
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const long long row = 4 * i;
    const uint32_t bits = quad_hits<NDIMS>(bins, zh, zl, row, n, tab, ids, nb);
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

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // grid-stride beyond 8 per SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int NDIMS>
void launch(const int* bins, const uint32_t* zh, const uint32_t* zl,
            long long n, const uint32_t* table, int nb, int want_mask,
            void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  const size_t smem = (size_t)nb * (NDIMS * 6 + 1) * sizeof(uint32_t);
  if (want_mask) {
    zscan_mask_kernel<NDIMS><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, n, table, nb, static_cast<uint8_t*>(out));
  } else {
    zscan_count_kernel<NDIMS><<<grid, kThreads, smem, stream>>>(
        bins, zh, zl, n, table, nb, static_cast<int*>(out));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `table` is DEVICE memory laid
// out as above (n_entries entries of n_dims * 6 words, then n_entries
// int32 ids); `bins` is null for n_dims == 2. For the count, `out` is one
// int32 that this call zeroes on `stream` first. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gm_zscan(const int* bins, const uint32_t* zh, const uint32_t* zl,
                        long long n, const uint32_t* table, int n_entries,
                        int n_dims, int want_mask, void* out,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_entries < 0 || n_entries > kMaxEntries) return (int)cudaErrorInvalidValue;
  // an empty plane may have a null pointer
  if (n_dims == 3 ? (bins == nullptr && n > 0) : (n_dims != 2 || n_entries != 1))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    if (n_dims == 3) {
      launch<3>(bins, zh, zl, n, table, n_entries, want_mask, out, stream);
    } else {
      launch<2>(nullptr, zh, zl, n, table, n_entries, want_mask, out, stream);
    }
  }
  return (int)cudaGetLastError();
}
