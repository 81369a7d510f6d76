// Density rasterization: a (height, width) grid of the rows that are masked
// in and inside the viewport, as a count or as a sum of float32 weights.
//
// Replaces: geomesa_tpu/ops/density_pallas.py::build_density_pallas (its
// pallas_call at density_pallas.py:124, the one-hot MXU contraction, plus
// the XLA pre-pass at :105-119 that computes pixel ids and folds the mask),
// and the XLA scatter engine the counterpart keeps for grids past 512x512
// (geomesa_tpu/device_cache.py:2376-2418). The 512-pixel split is a TPU
// limit (VMEM holds the accumulator and the one-hot width); here one kernel
// serves every grid of up to 2^31 - 1 cells.
//
// Per row: read x and y (float32), widen to float64 and compute the pixel
// as process/density.py::_pixel_ids does under x64 --
//   px = clip(floor((x - xmin) * sx), 0, width - 1)
//   inside = xmin <= x <= xmax && ymin <= y <= ymax
// with sx = width / (xmax - xmin) computed by the caller in float64 -- so
// that f32-exact data lands in the reference's pixels bit for bit, border
// pixels included. __dsub_rn/__dmul_rn and -fmad=false keep every product
// and difference rounded on its own. Rows with a zero mask byte, or outside
// the viewport, add nothing; the rest add 1 (int32 accumulator, exact) or
// their weight (float64 accumulator, native atomicAdd(double*)). The
// wrapper zeroes the accumulator and casts it to the float32 grid.
//
// Bound on this card: memory, 8 B/row of coordinates plus 1 B of mask and
// 4 B of weight; a row costs a dozen float64 operations. The real risk is
// contention: clustered data sends most adds to a few cells. Two engines,
// chosen by grid size and kind alone (a static choice, not a fallback):
//  - counted grids of at most 16,384 cells (64 KB of int32, three blocks
//    per SM) privatise one sub-grid per block in shared memory, then merge
//    it with one global atomic per non-zero cell;
//  - every other grid aggregates per warp: __match_any_sync groups the
//    lanes that hit the same cell, and one leader adds the group's count
//    (or its float64 weight sum, gathered by shuffles) with one global
//    atomic.
// The split is measured (chip_smoke.py times both engines at 128x128): at
// 2^26 rows the shared-memory engine counted 128x128 in a quarter
// (clustered points) to a half (uniform) of the global engine's time, but
// lost on float64 weights (shared float64 atomics, likely compare-and-swap
// loops) and, on uniform points, on a 160 KB 200x200 grid (likely: one
// block per SM hides too little latency).
// Integer sums are order-independent, so counts are exact and
// deterministic; float64 weight sums depend on the order blocks run in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemCells = 16384;  // 64 KB of int32

struct View {
  double xmin, ymin, xmax, ymax, sx, sy;
  int width, height;
};

// Flat cell id of row i, or -1 when the row contributes nothing.
__device__ __forceinline__ int cell_of(const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       const uint8_t* __restrict__ m,
                                       long long i, const View& v) {
  if (m != nullptr && __ldg(m + i) == 0) return -1;
  const double xd = (double)__ldg(x + i);
  const double yd = (double)__ldg(y + i);
  if (!(xd >= v.xmin && xd <= v.xmax && yd >= v.ymin && yd <= v.ymax)) {
    return -1;
  }
  double fx = floor(__dmul_rn(__dsub_rn(xd, v.xmin), v.sx));
  double fy = floor(__dmul_rn(__dsub_rn(yd, v.ymin), v.sy));
  fx = fmin(fmax(fx, 0.0), (double)(v.width - 1));
  fy = fmin(fmax(fy, 0.0), (double)(v.height - 1));
  return (int)fy * v.width + (int)fx;
}

template <bool kWeighted>
struct Acc;
template <>
struct Acc<false> {
  using T = int;
};
template <>
struct Acc<true> {
  using T = double;
};

// Shared-memory engine (counts): one private sub-grid per block.
__global__ void __launch_bounds__(kThreads)
density_smem_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const uint8_t* __restrict__ m, long long n, View v,
                    int* __restrict__ out) {
  extern __shared__ int h[];
  const int cells = v.width * v.height;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) h[c] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = cell_of(x, y, m, i, v);
    if (c >= 0) atomicAdd(&h[c], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    if (h[c] != 0) atomicAdd(&out[c], h[c]);
  }
}

// Global engine: warp-aggregated atomics into the device-memory grid.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
density_global_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const uint8_t* __restrict__ m,
                      const float* __restrict__ w, long long n, View v,
                      typename Acc<kWeighted>::T* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // base is the same for every lane of a warp, so all 32 lanes run each
  // iteration together (the *_sync intrinsics need the full warp)
  for (long long base = warp * 32; base < n; base += warps * 32) {
    const long long i = base + lane;
    const int c = i < n ? cell_of(x, y, m, i, v) : -1;
    const unsigned peers = __match_any_sync(full, c);
    const bool leader = lane == __ffs(peers) - 1;
    if (!kWeighted) {
      if (c >= 0 && leader) atomicAdd(&out[c], (typename Acc<kWeighted>::T)__popc(peers));
    } else {
      const double wv = c >= 0 ? (double)__ldg(w + i) : 0.0;
      double s = wv;
      if (__any_sync(full, c >= 0 && __popc(peers) > 1)) {
        s = 0.0;
        for (int j = 0; j < 32; ++j) {
          const double wj = __shfl_sync(full, wv, j);
          if ((peers >> j) & 1u) s += wj;
        }
      }
      if (c >= 0 && leader) atomicAdd(&out[c], (typename Acc<kWeighted>::T)s);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <bool kWeighted>
int launch(const float* x, const float* y, const uint8_t* m, const float* w,
           long long n, const View& v, bool shared, void* out,
           cudaStream_t stream) {
  using T = typename Acc<kWeighted>::T;
  const long long cells = (long long)v.width * v.height;
  const long long need = (n + kThreads - 1) / kThreads;
  if (!kWeighted && shared && cells <= kSmemCells) {
    const size_t smem = (size_t)cells * sizeof(int);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          density_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // as many blocks per SM as their sub-grids fit (up to 8)
    long long per_sm = (228 * 1024) / ((long long)smem + 1024);
    if (per_sm > 8) per_sm = 8;
    long long blocks = need < sm_count() * per_sm ? need : sm_count() * per_sm;
    density_smem_kernel<<<(int)blocks, kThreads, smem, stream>>>(
        x, y, m, n, v, static_cast<int*>(out));
  } else {
    long long cap = (long long)sm_count() * 8;  // grid-stride beyond that
    long long blocks = need < cap ? need : cap;
    density_global_kernel<kWeighted><<<(int)blocks, kThreads, 0, stream>>>(
        x, y, m, w, n, v, static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). `x`, `y` (and `w` when
// weighted) are float32 device arrays of n rows, `mask` one byte per row
// (0 = skip) or null for every row. `out` is the ZEROED accumulator of
// width * height cells: int32 when `w` is null, float64 otherwise.
// `shared` 0 sends every grid to the global engine (to time the two
// engines on one grid); 1 chooses by grid size and kind. Returns
// cudaGetLastError() after the launch (0 = launched); n == 0 launches
// nothing and leaves `out` as it is.
extern "C" int gm_density(const float* x, const float* y, const uint8_t* mask,
                          const float* w, long long n, double xmin,
                          double ymin, double xmax, double ymax, double sx,
                          double sy, int width, int height, int shared,
                          void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (width <= 0 || height <= 0 ||
      (long long)width * height > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  const View v = {xmin, ymin, xmax, ymax, sx, sy, width, height};
  if (w != nullptr) {
    return launch<true>(x, y, mask, w, n, v, shared != 0, out, stream);
  }
  return launch<false>(x, y, mask, w, n, v, shared != 0, out, stream);
}
