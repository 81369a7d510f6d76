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
//
// Validity (a streaming index's live rows, valid.cuh): with a plane, a row
// counts, and its mask byte is set, only where its verdict and its validity
// byte are both set; 1 B/row more to read, one 32-bit load a quad. The read
// is a template parameter chosen by the pointer on the host, so a launch
// without a plane runs the code it ran before.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#include "quad.cuh"
#include "valid.cuh"

constexpr int kMaxQ = 20;  // 4 + 2 * 8 ranges

struct DimQuery {
  uint32_t q[kMaxQ];
};

// One query's words: the kernel parameters (DimQuery) or a row of the
// batched kernels' query matrix in shared memory (a pointer).
__device__ __forceinline__ uint32_t word(const DimQuery& q, int i) { return q.q[i]; }
__device__ __forceinline__ uint32_t word(const uint32_t* q, int i) { return q[i]; }

template <int NR, class Q>
__device__ __forceinline__ uint32_t hit(uint32_t nx, uint32_t ny, uint32_t bt,
                                        const Q& q) {
  uint32_t m = (nx >= word(q, 0)) & (nx <= word(q, 1)) & (ny >= word(q, 2)) &
               (ny <= word(q, 3));
  if (NR > 0) {
    uint32_t t = 0;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      t |= (bt >= word(q, 4 + 2 * k)) & (bt <= word(q, 5 + 2 * k));
    }
    m &= t;
  }
  return m;
}

// The planes' words of the 4 rows starting at `row` (a multiple of 4) and
// how many of them lie before n (at most 4; 0 or less reads nothing).
struct Quad {
  uint4 a, b, c;
  long long rows;
};

template <int NR>
__device__ __forceinline__ Quad load_quad(const uint32_t* nx, const uint32_t* ny,
                                          const uint32_t* bt, long long row,
                                          long long n) {
  Quad d;
  d.rows = n - row;
  d.c = make_uint4(0, 0, 0, 0);
  if (d.rows >= 4) {
    d.a = load4(nx, row);
    d.b = load4(ny, row);
    if (NR > 0) d.c = load4(bt, row);
    return d;
  }
  uint32_t a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0}, c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r < d.rows) {
      a[r] = nx[row + r];
      b[r] = ny[row + r];
      if (NR > 0) c[r] = bt[row + r];
    }
  }
  d.a = make_uint4(a[0], a[1], a[2], a[3]);
  d.b = make_uint4(b[0], b[1], b[2], b[3]);
  d.c = make_uint4(c[0], c[1], c[2], c[3]);
  return d;
}

// Hits of a quad's rows for one query, as bits 0..3; rows at or past n are 0.
template <int NR, class Q>
__device__ __forceinline__ uint32_t quad_bits(const Quad& d, const Q& q) {
  const uint32_t bits =
      hit<NR>(d.a.x, d.b.x, d.c.x, q) | (hit<NR>(d.a.y, d.b.y, d.c.y, q) << 1) |
      (hit<NR>(d.a.z, d.b.z, d.c.z, q) << 2) | (hit<NR>(d.a.w, d.b.w, d.c.w, q) << 3);
  return d.rows >= 4 ? bits : (d.rows <= 0 ? 0u : bits & ((1u << d.rows) - 1u));
}

template <int NR>
__device__ __forceinline__ uint32_t quad_hits(const uint32_t* nx,
                                              const uint32_t* ny,
                                              const uint32_t* bt,
                                              long long row, long long n,
                                              const DimQuery& q) {
  return quad_bits<NR>(load_quad<NR>(nx, ny, bt, row, n), q);
}

template <int NR, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_count_kernel(const uint32_t* __restrict__ nx,
                     const uint32_t* __restrict__ ny,
                     const uint32_t* __restrict__ bt,
                     const uint8_t* __restrict__ valid, long long n,
                     DimQuery q, int* __restrict__ out) {
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    uint32_t bits = quad_hits<NR>(nx, ny, bt, 4 * i, n, q);
    if (VALID) bits &= valid_bits(valid, 4 * i, n);
    c += __popc(bits);
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

template <int NR, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_mask_kernel(const uint32_t* __restrict__ nx,
                    const uint32_t* __restrict__ ny,
                    const uint32_t* __restrict__ bt,
                    const uint8_t* __restrict__ valid, long long n,
                    DimQuery q, uint8_t* __restrict__ out) {
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const long long row = 4 * i;
    uint32_t bits = quad_hits<NR>(nx, ny, bt, row, n, q);
    if (VALID) bits &= valid_bits(valid, row, n);
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

template <int NR, bool VALID>
void launch_v(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
              const uint8_t* valid, long long n, const DimQuery& q, int want_mask,
              void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  if (want_mask) {
    dimscan_mask_kernel<NR, VALID><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, valid, n, q, static_cast<uint8_t*>(out));
  } else {
    dimscan_count_kernel<NR, VALID><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, valid, n, q, static_cast<int*>(out));
  }
}

template <int NR>
void launch(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
            const uint8_t* valid, long long n, const DimQuery& q, int want_mask,
            void* out, cudaStream_t stream) {
  if (valid) {
    launch_v<NR, true>(nx, ny, bt, valid, n, q, want_mask, out, stream);
  } else {
    launch_v<NR, false>(nx, ny, bt, valid, n, q, want_mask, out, stream);
  }
}

// -- the Q-batched dim scan ----------------------------------------------------
//
// Q queries over the same planes in one pass: the fused loose count and
// mask of the device query scheduler. The reference computes them with an
// XLA vmap of the single-query mask (geomesa_tpu/ops/zscan.py:831,
// batched_dim_mask_rt), not with a Pallas kernel; a torch broadcast of the
// plain version would hold (Q, n) int64 intermediates (32 GiB at Q = 64 and
// 2^26 rows). Each thread loads its quad of rows once and tests every
// query of the group against it, the query matrix (at most 64 x 20 words)
// staged once per block in shared memory. The count reads 12 B/row (8 B for
// z2) and does Q x (4 + 2R) compares a row (each also ANDs or ORs into a
// predicate), so wide groups are bound by operations; it reduces each
// query per warp
// (__reduce_add_sync, the warp's lanes stepping through the rows together)
// into per-warp counters in shared memory, then one atomic per block and
// query. The mask writes Q bytes a row: a (Q, n) matrix, one contiguous row
// of n bytes per query, so that a query's host take reads one row. With a
// validity plane, each quad's hit bits of every query are ANDed with its
// rows' validity bits before the counts and the mask.

constexpr int kMaxBatch = 64;
constexpr int kWarps = kThreads / 32;

template <int NR>
__device__ __forceinline__ void stage_queries(const uint32_t* qmat, int nq,
                                              uint32_t* s) {
  for (int i = threadIdx.x; i < nq * (4 + 2 * NR); i += blockDim.x) s[i] = qmat[i];
}

template <int NR, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_batched_count_kernel(const uint32_t* __restrict__ nx,
                             const uint32_t* __restrict__ ny,
                             const uint32_t* __restrict__ bt,
                             const uint8_t* __restrict__ valid, long long n,
                             const uint32_t* __restrict__ qmat, int nq,
                             int* __restrict__ out) {
  constexpr int W = 4 + 2 * NR;
  __shared__ uint32_t sq[kMaxBatch * W];
  __shared__ int counts[kWarps][kMaxBatch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_queries<NR>(qmat, nq, sq);
  for (int q = lane; q < kMaxBatch; q += 32) counts[warp][q] = 0;
  __syncthreads();
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the warp's first quad: every lane of a warp runs the same iterations,
  // as __reduce_add_sync needs; lanes past the end count nothing
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < quads; base += stride) {
    const Quad d = load_quad<NR>(nx, ny, bt, 4 * (base + lane), n);
    // without a plane the AND is not compiled: it cost an operation a
    // query and quad, and wide groups are bound by operations
    const uint32_t vb = VALID ? valid_bits(valid, 4 * (base + lane), n) : 0u;
    for (int q = 0; q < nq; ++q) {
      uint32_t bits = quad_bits<NR>(d, sq + q * W);
      if (VALID) bits &= vb;
      const int c = __reduce_add_sync(0xffffffffu, __popc(bits));
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

template <int NR, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_batched_mask_kernel(const uint32_t* __restrict__ nx,
                            const uint32_t* __restrict__ ny,
                            const uint32_t* __restrict__ bt,
                            const uint8_t* __restrict__ valid, long long n,
                            const uint32_t* __restrict__ qmat, int nq,
                            uint8_t* __restrict__ out) {
  constexpr int W = 4 + 2 * NR;
  __shared__ uint32_t sq[kMaxBatch * W];
  stage_queries<NR>(qmat, nq, sq);
  __syncthreads();
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const Quad d = load_quad<NR>(nx, ny, bt, 4 * i, n);
    const uint32_t vb = VALID ? valid_bits(valid, 4 * i, n) : 0u;
    for (int q = 0; q < nq; ++q) {
      uint32_t bits = quad_bits<NR>(d, sq + q * W);
      if (VALID) bits &= vb;
      store_bits(out, n, q, 4 * i, bits);
    }
  }
}

template <int NR, bool VALID>
void launch_batched_v(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
                      const uint8_t* valid, long long n, const uint32_t* qmat, int nq,
                      int want_mask, void* out, cudaStream_t stream) {
  const int grid = grid_for(n);
  if (want_mask) {
    dimscan_batched_mask_kernel<NR, VALID><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, valid, n, qmat, nq, static_cast<uint8_t*>(out));
  } else {
    dimscan_batched_count_kernel<NR, VALID><<<grid, kThreads, 0, stream>>>(
        nx, ny, bt, valid, n, qmat, nq, static_cast<int*>(out));
  }
}

template <int NR>
void launch_batched(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
                    const uint8_t* valid, long long n, const uint32_t* qmat, int nq,
                    int want_mask, void* out, cudaStream_t stream) {
  if (valid) {
    launch_batched_v<NR, true>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream);
  } else {
    launch_batched_v<NR, false>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `qarr` is HOST memory holding
// 4 + 2 * n_ranges uint32 words; it is copied into the kernel parameters.
// `valid` is null (every row live) or n bytes, 4-byte aligned, 0 for a dead
// row. For the count, `out` is one int32 that this call zeroes on `stream`
// first. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an n_ranges the template does not cover.
extern "C" int gm_dimscan(const uint32_t* nx, const uint32_t* ny,
                          const uint32_t* bt, const uint8_t* valid, long long n,
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
      case 0: launch<0>(nx, ny, bt, valid, n, q, want_mask, out, stream); break;
      case 1: launch<1>(nx, ny, bt, valid, n, q, want_mask, out, stream); break;
      case 2: launch<2>(nx, ny, bt, valid, n, q, want_mask, out, stream); break;
      case 4: launch<4>(nx, ny, bt, valid, n, q, want_mask, out, stream); break;
      case 8: launch<8>(nx, ny, bt, valid, n, q, want_mask, out, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the batched scan (bound with ctypes). `qmat` is
// DEVICE memory: nq rows of 4 + 2 * n_ranges uint32 words, 1 <= nq <= 64;
// `valid` as for gm_dimscan. For the count, `out` is nq int32 that this
// call zeroes on `stream` first; for the mask, nq * n bytes, row q holding query q's hits. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int gm_dimscan_batched(const uint32_t* nx, const uint32_t* ny,
                                  const uint32_t* bt, const uint8_t* valid, long long n,
                                  const uint32_t* qmat, int nq, int n_ranges,
                                  int want_mask, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nq < 1 || nq > kMaxBatch || (n_ranges > 0 && bt == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * nq, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    switch (n_ranges) {
      case 0: launch_batched<0>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 1: launch_batched<1>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 2: launch_batched<2>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 4: launch_batched<4>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 8: launch_batched<8>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (n_ranges != 0 && n_ranges != 1 && n_ranges != 2 && n_ranges != 4 &&
             n_ranges != 8) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
