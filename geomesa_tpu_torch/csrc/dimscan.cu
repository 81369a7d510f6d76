// Dim-plane key scan: count and mask over the de-interleaved Z3/Z2 key
// planes with runtime query bounds.
//
// Replaces: geomesa_tpu/ops/zscan.py::build_z3_dimscan_rt (count
// pallas_call at zscan.py:643, mask at :669) and
// geomesa_tpu/ops/zscan.py::build_z2_dimscan_rt (count :498, mask :521).
// One template serves both: NR = 0 is the 2-plane z2 scan, NR in
// {1, 2, 4, 8} the 3-plane z3 scan with NR inclusive bt ranges.
//
// A row matches when nx in [q0, q1], ny in [q2, q3] and (z3 only) bt lies
// in at least one of the ranges [q4 + 2k, q5 + 2k], all compared as
// uint32. Pad ranges are inverted (lo > hi) and never match.
//
// Bound on this card: memory. Each row is read once (12 B for z3, 8 B for
// z2) plus 1 B written for the mask; the compares are a handful of integer
// ops per row, far below the card's integer rate. So the design is about
// bytes: every thread reads 4 consecutive rows of each plane with one
// 16-byte load (neighbouring threads on neighbouring addresses), the
// planes are read in place (no padded copy, unlike the TPU kernel's
// _prep), and the ragged tail (n % 4 rows) is handled by scalar loads in
// the same pass. The query vector (at most 20 words) rides in the
// kernel's parameters, so one build serves every window. The count
// reduces per warp (__reduce_add_sync) and per block, then does one
// integer atomicAdd per block: integer addition is order-independent, so
// the count is exact and deterministic although blocks run in no order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 20;  // 4 + 2 * 8 ranges

struct DimQuery {
  uint32_t q[kMaxQ];
};

template <int NR>
__device__ __forceinline__ uint32_t hit(uint32_t nx, uint32_t ny, uint32_t bt,
                                        const DimQuery& q) {
  uint32_t m = (nx >= q.q[0]) & (nx <= q.q[1]) & (ny >= q.q[2]) & (ny <= q.q[3]);
  if (NR > 0) {
    uint32_t t = 0;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      t |= (bt >= q.q[4 + 2 * k]) & (bt <= q.q[5 + 2 * k]);
    }
    m &= t;
  }
  return m;
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, long long row) {
  return __ldg(reinterpret_cast<const uint4*>(p + row));
}

// Hits of the 4 rows starting at `row` (row is a multiple of 4), as bits
// 0..3; rows at or past n read nothing and are 0.
template <int NR>
__device__ __forceinline__ uint32_t quad_hits(const uint32_t* nx,
                                              const uint32_t* ny,
                                              const uint32_t* bt,
                                              long long row, long long n,
                                              const DimQuery& q) {
  if (row + 4 <= n) {
    uint4 a = load4(nx, row);
    uint4 b = load4(ny, row);
    uint4 c = make_uint4(0, 0, 0, 0);
    if (NR > 0) c = load4(bt, row);
    return hit<NR>(a.x, b.x, c.x, q) | (hit<NR>(a.y, b.y, c.y, q) << 1) |
           (hit<NR>(a.z, b.z, c.z, q) << 2) | (hit<NR>(a.w, b.w, c.w, q) << 3);
  }
  uint32_t bits = 0;
  for (int r = 0; r < 4 && row + r < n; ++r) {
    long long i = row + r;
    uint32_t t = NR > 0 ? bt[i] : 0u;
    bits |= hit<NR>(nx[i], ny[i], t, q) << r;
  }
  return bits;
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
dimscan_count_kernel(const uint32_t* __restrict__ nx,
                     const uint32_t* __restrict__ ny,
                     const uint32_t* __restrict__ bt, long long n,
                     DimQuery q, int* __restrict__ out) {
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    c += __popc(quad_hits<NR>(nx, ny, bt, 4 * i, n, q));
  }
  c = __reduce_add_sync(0xffffffffu, c);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0 && s) atomicAdd(out, s);
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
dimscan_mask_kernel(const uint32_t* __restrict__ nx,
                    const uint32_t* __restrict__ ny,
                    const uint32_t* __restrict__ bt, long long n,
                    DimQuery q, uint8_t* __restrict__ out) {
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const long long row = 4 * i;
    uint32_t bits = quad_hits<NR>(nx, ny, bt, row, n, q);
    if (row + 4 <= n) {
      // one byte (0 or 1) per row, 4 rows per 32-bit store
      uint32_t w = (bits & 1u) | ((bits >> 1 & 1u) << 8) |
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
  long long quads = (n + 3) / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 8;  // grid-stride beyond 8 blocks per SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int NR>
void launch(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
            long long n, const DimQuery& q, int want_mask, void* out,
            cudaStream_t stream) {
  const int grid = grid_for(n);
  if (want_mask) {
    dimscan_mask_kernel<NR><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, n, q, static_cast<uint8_t*>(out));
  } else {
    dimscan_count_kernel<NR><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, n, q, static_cast<int*>(out));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `qarr` is HOST memory holding
// 4 + 2 * n_ranges uint32 words; it is copied into the kernel parameters.
// For the count, `out` is one int32 that this call zeroes on `stream`
// first. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an n_ranges the template does not cover.
extern "C" int gm_dimscan(const uint32_t* nx, const uint32_t* ny,
                          const uint32_t* bt, long long n,
                          const uint32_t* qarr, int n_ranges, int want_mask,
                          void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  DimQuery q = {};
  const int nq = 4 + 2 * n_ranges;
  if (n_ranges < 0 || nq > kMaxQ) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nq; ++i) q.q[i] = qarr[i];
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    switch (n_ranges) {
      case 0: launch<0>(nx, ny, bt, n, q, want_mask, out, stream); break;
      case 1: launch<1>(nx, ny, bt, n, q, want_mask, out, stream); break;
      case 2: launch<2>(nx, ny, bt, n, q, want_mask, out, stream); break;
      case 4: launch<4>(nx, ny, bt, n, q, want_mask, out, stream); break;
      case 8: launch<8>(nx, ny, bt, n, q, want_mask, out, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
