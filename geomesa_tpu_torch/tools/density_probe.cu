// Stage-by-stage probe of csrc/density.cu's row loop: which part of a
// counted density pass costs the time. Each stage is the loop of the
// density kernel cut after one more step, on one CTA of 1024 threads per SM
// with a 128x128 int32 grid (64 KB) in shared memory:
//   0 loads only (x, y and the mask byte of every row)
//   1 + the float64 pixel math (load_rows: cell ids, no adds)
//   2 + __match_any_sync per row slot (no adds)
//   3 + one shared-memory atomic per match group (match_any merge)
//   4 + one shared-memory atomic per row (no merge)
//   5 + one shared-memory atomic per run of equal cells (run_head merge,
//       the kernel's own)
// Built with the kernel's own flags; it includes the kernel's source, so
// its helpers are the ones measured.

#include "../csrc/density.cu"

namespace {

constexpr int kProbeCells = 16384;  // a 128x128 grid

template <int P>
__global__ void __launch_bounds__(1024, 1)
probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const uint8_t* __restrict__ m, long long n, View v,
             int* __restrict__ out) {
  extern __shared__ int g[];
  for (int c = threadIdx.x; c < kProbeCells; c += blockDim.x) g[c] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  int acc = 0;
  for (long long base = warp * kWarpRows; base < n; base += warps * kWarpRows) {
    if (P == 0) {
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k) {
        const long long i = base + 32 * k + lane;
        const long long j = i < n ? i : n - 1;
        acc += __float_as_int(__ldg(x + j)) ^ __float_as_int(__ldg(y + j)) ^ __ldg(m + j);
      }
      continue;
    }
    int c[kRowsPerLane];
    double unused[kRowsPerLane];
    load_rows<false>(x, y, m, nullptr, n, base, lane, v, c, unused);
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      if (P == 1) {
        acc += c[k];
      } else if (P == 2 || P == 3) {
        const unsigned peers = __match_any_sync(kFull, c[k]);
        if (P == 2) {
          acc += __popc(peers);
        } else if (c[k] >= 0 && lane == __ffs(peers) - 1) {
          atomicAdd(g + c[k], __popc(peers));
        }
      } else if (P == 4) {
        if (c[k] >= 0) atomicAdd(g + c[k], 1);
      } else {
        int end;
        if (run_head(c[k], lane, end) && c[k] >= 0) atomicAdd(g + c[k], end - lane);
      }
    }
  }
  // keep every stage's work live without writing it
  if (acc == 0x7fffffff) out[0] = acc;
  __syncthreads();
  for (int c = threadIdx.x; c < kProbeCells; c += blockDim.x) {
    if (g[c] != 0) atomicAdd(out + 1 + c, g[c]);
  }
}

}  // namespace

// Run stage `stage` (0..5) over n rows on `blocks` CTAs; `out` holds
// 1 + 16384 zeroed int32 (stages 3-5 leave the 128x128 grid in out + 1).
extern "C" int gm_density_probe(int stage, const float* x, const float* y,
                                const uint8_t* m, long long n, double xmin,
                                double ymin, double xmax, double ymax,
                                double sx, double sy, int blocks, int* out,
                                void* stream) {
  void (*ks[6])(const float*, const float*, const uint8_t*, long long, View, int*) = {
      probe_kernel<0>, probe_kernel<1>, probe_kernel<2>,
      probe_kernel<3>, probe_kernel<4>, probe_kernel<5>};
  if (stage < 0 || stage > 5) return (int)cudaErrorInvalidValue;
  const int smem = kProbeCells * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ks[stage], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const View v = {xmin, ymin, xmax, ymax, sx, sy, 128, 128};
  ks[stage]<<<blocks, 1024, smem, (cudaStream_t)stream>>>(x, y, m, n, v, out);
  return (int)cudaGetLastError();
}
