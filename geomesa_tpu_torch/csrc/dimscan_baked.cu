// Dim-plane key scan with the query held as kernel constants: count and
// mask over the de-interleaved Z3 key planes (nx, ny, packed bt).
//
// Replaces: geomesa_tpu/ops/zscan.py::build_z3_dimscan_pallas (count
// pallas_call at zscan.py:772, mask at :790). There, as here, it is the
// cross-check engine: serving uses the runtime-bounds scan of dimscan.cu,
// and this kernel is a separate, plain design to hold that one against.
//
// A row matches when nx in [qnx0, qnx1], ny in [qny0, qny1] and bt lies in
// at least one of the n_ranges inclusive ranges, all compared as uint32;
// no range matches nothing.
//
// Bound on this card: memory at the usual single range (12 B read per row,
// 1 B written for the mask, 6 compares). The design is the plainest one
// that is right: one row per thread with scalar loads, no grid-stride loop.
// The query -- (qnx, qny) and any number of bt ranges up to 2047, every
// window a packed bt plane can address -- travels in one by-value
// parameter struct marked __grid_constant__, so it sits in the card's
// constant bank and the kernel loops over the ranges at run time with no
// local copy. The count reduces per warp and per block, then adds with one
// integer atomic per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanges = 2047;

struct BakedQuery {
  uint32_t qnx0, qnx1, qny0, qny1;
  int n_ranges;
  uint32_t r[2 * kMaxRanges];  // (lo, hi) per range
};

__device__ __forceinline__ uint32_t hit(uint32_t nx, uint32_t ny, uint32_t bt,
                                        const BakedQuery& q) {
  if (!(nx >= q.qnx0 && nx <= q.qnx1 && ny >= q.qny0 && ny <= q.qny1)) return 0;
  for (int k = 0; k < q.n_ranges; ++k) {
    if (bt >= q.r[2 * k] && bt <= q.r[2 * k + 1]) return 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
baked_count_kernel(const uint32_t* __restrict__ nx,
                   const uint32_t* __restrict__ ny,
                   const uint32_t* __restrict__ bt, long long n,
                   const __grid_constant__ BakedQuery q, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int c = i < n ? (int)hit(nx[i], ny[i], bt[i], q) : 0;
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

__global__ void __launch_bounds__(kThreads)
baked_mask_kernel(const uint32_t* __restrict__ nx,
                  const uint32_t* __restrict__ ny,
                  const uint32_t* __restrict__ bt, long long n,
                  const __grid_constant__ BakedQuery q,
                  uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (uint8_t)hit(nx[i], ny[i], bt[i], q);
}

}  // namespace

// Plain C entry point (bound with ctypes). `qxy` (4 words: qnx0, qnx1,
// qny0, qny1) and `ranges` (2 * n_ranges words) are HOST memory, copied
// into the kernel's parameters. For the count, `out` is one int32 that this
// call zeroes on `stream` first. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue past kMaxRanges.
extern "C" int gm_dimscan_baked(const uint32_t* nx, const uint32_t* ny,
                                const uint32_t* bt, long long n,
                                const uint32_t* qxy, const uint32_t* ranges,
                                int n_ranges, int want_mask, void* out,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_ranges < 0 || n_ranges > kMaxRanges) return (int)cudaErrorInvalidValue;
  BakedQuery q;
  q.qnx0 = qxy[0];
  q.qnx1 = qxy[1];
  q.qny0 = qxy[2];
  q.qny1 = qxy[3];
  q.n_ranges = n_ranges;
  for (int i = 0; i < 2 * n_ranges; ++i) q.r[i] = ranges[i];
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (want_mask) {
      baked_mask_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
          nx, ny, bt, n, q, static_cast<uint8_t*>(out));
    } else {
      baked_count_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
          nx, ny, bt, n, q, static_cast<int*>(out));
    }
  }
  return (int)cudaGetLastError();
}
