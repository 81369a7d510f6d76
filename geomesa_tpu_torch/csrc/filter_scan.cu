// Exact filter scan: the device part of an ECQL filter, evaluated per row
// over the resident 32-bit column planes, as a count or a mask.
//
// Replaces: geomesa_tpu/ops/pallas_scan.py::build_pallas_scan (count
// pallas_call at pallas_scan.py:284, mask at :304). The Pallas kernel is
// traced anew for every filter AST with its constants baked in; compiling
// CUDA per query would put nvcc on the serving path. Instead the port's
// encoder (ops/filter_scan.py) turns the AST into a short PROGRAM of
// fixed-width instructions plus a table of 32-bit constants (float32,
// int32 or uint32 bits, and point-in-polygon edges), and this one
// prebuilt kernel interprets it. Every thread of a block runs the same
// instruction at the same time, so the interpreter's switch never
// diverges; the program is copied into shared memory once per block and
// read by all threads at one address (a broadcast, no bank conflicts).
//
// Per row the program keeps a stack of booleans as bits of a 64-bit word:
// leaf instructions push, AND/OR pop two and push one, NOT flips the top.
// Arithmetic is float32 with explicit round-to-nearest intrinsics and the
// file is built with -fmad=false: the distance and crossing tests must not
// contract into FMAs, or their bits would differ from the reference.
//
// Bound on this card: memory for the common filters (bbox + during reads
// 4 B per referenced column per row, 16 B/row, and writes 1 B/row for the
// mask); a polygon with E edges costs ~5E float ops per row and turns
// compute-bound above a few dozen edges. The design reads each referenced
// column with one 16-byte load per thread for 4 consecutive rows (a second
// instruction on the same column hits L1), reads the planes in place, and
// masks the ragged tail itself. The count reduces per warp and per block
// and adds once per block with an integer atomic (exact, deterministic).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;
constexpr int kInstrWords = 8;
constexpr int kMaxProgramWords = 12288;  // 48 KB of shared memory

enum Op {
  OP_TRUE = 0,
  OP_FALSE = 1,
  OP_BBOX = 2,      // c0=x c1=y; K: xmin ymin xmax ymax
  OP_BBOX_ENV = 3,  // c0=x0 c1=y0 c2=x1 c3=y1; K: xmin ymin xmax ymax
  OP_DWITHIN = 4,   // c0=x c1=y; K: px py d2
  OP_PIP = 5,       // c0=x c1=y; n edges at K: ey1 ey2 ex1 dx denom; flag=negate
  OP_CMP_F32 = 6,   // c0; K: value; flag=cmp
  OP_CMP_I32 = 7,   // c0; K: value; flag=cmp
  OP_CMP_I64 = 8,   // c0=hi c1=lo; K: vhi vlo; flag=cmp
  OP_AND = 9,
  OP_OR = 10,
  OP_NOT = 11,
};

enum Cmp { CMP_EQ = 0, CMP_NE = 1, CMP_LT = 2, CMP_LE = 3, CMP_GT = 4, CMP_GE = 5 };

struct Cols {
  const uint32_t* p[kMaxCols];
};

__device__ __forceinline__ uint32_t cmp_from(int op, bool lt, bool eq) {
  switch (op) {
    case CMP_EQ: return eq;
    case CMP_NE: return !eq;
    case CMP_LT: return lt;
    case CMP_LE: return lt || eq;
    case CMP_GT: return !(lt || eq);
    default: return !lt;  // CMP_GE
  }
}

__device__ __forceinline__ uint32_t cmp_f32(int op, float a, float b) {
  // NaN: every ordered compare is false and <> is true, as in IEEE
  switch (op) {
    case CMP_EQ: return a == b;
    case CMP_NE: return a != b;
    case CMP_LT: return a < b;
    case CMP_LE: return a <= b;
    case CMP_GT: return a > b;
    default: return a >= b;
  }
}

// 4 consecutive rows of one 32-bit plane; rows at or past n read as 0
// (their results are masked off by the caller).
__device__ __forceinline__ uint4 load4(const uint32_t* p, long long row,
                                       long long n) {
  if (row + 4 <= n) return __ldg(reinterpret_cast<const uint4*>(p + row));
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row < n) v.x = p[row];
  if (row + 1 < n) v.y = p[row + 1];
  if (row + 2 < n) v.z = p[row + 2];
  return v;
}

__device__ __forceinline__ void unpack(uint4 v, uint32_t out[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ float kf(const uint32_t* K, int i) {
  return __uint_as_float(K[i]);
}

// Run the program for the 4 rows starting at `row`; returns their results
// as bits 0..3 (rows past n are 0).
__device__ __forceinline__ uint32_t eval_quad(const Cols& cols,
                                              const int* ins, int n_instr,
                                              const uint32_t* K,
                                              long long row, long long n) {
  uint64_t st[4] = {0, 0, 0, 0};
  for (int pc = 0; pc < n_instr; ++pc) {
    const int* I = ins + pc * kInstrWords;
    const int op = I[0];
    switch (op) {
      case OP_TRUE:
      case OP_FALSE: {
        const uint64_t b = op == OP_TRUE;
#pragma unroll
        for (int r = 0; r < 4; ++r) st[r] = (st[r] << 1) | b;
        break;
      }
      case OP_BBOX: {
        uint32_t x[4], y[4];
        unpack(load4(cols.p[I[1]], row, n), x);
        unpack(load4(cols.p[I[2]], row, n), y);
        const float xmin = kf(K, I[5]), ymin = kf(K, I[5] + 1);
        const float xmax = kf(K, I[5] + 2), ymax = kf(K, I[5] + 3);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float px = __uint_as_float(x[r]), py = __uint_as_float(y[r]);
          const uint64_t b = (px >= xmin) & (px <= xmax) & (py >= ymin) & (py <= ymax);
          st[r] = (st[r] << 1) | b;
        }
        break;
      }
      case OP_BBOX_ENV: {
        uint32_t x0[4], y0[4], x1[4], y1[4];
        unpack(load4(cols.p[I[1]], row, n), x0);
        unpack(load4(cols.p[I[2]], row, n), y0);
        unpack(load4(cols.p[I[3]], row, n), x1);
        unpack(load4(cols.p[I[4]], row, n), y1);
        const float xmin = kf(K, I[5]), ymin = kf(K, I[5] + 1);
        const float xmax = kf(K, I[5] + 2), ymax = kf(K, I[5] + 3);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = (__uint_as_float(x1[r]) >= xmin) &
                             (__uint_as_float(x0[r]) <= xmax) &
                             (__uint_as_float(y1[r]) >= ymin) &
                             (__uint_as_float(y0[r]) <= ymax);
          st[r] = (st[r] << 1) | b;
        }
        break;
      }
      case OP_DWITHIN: {
        uint32_t x[4], y[4];
        unpack(load4(cols.p[I[1]], row, n), x);
        unpack(load4(cols.p[I[2]], row, n), y);
        const float gx = kf(K, I[5]), gy = kf(K, I[5] + 1), d2 = kf(K, I[5] + 2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dx = __fsub_rn(__uint_as_float(x[r]), gx);
          const float dy = __fsub_rn(__uint_as_float(y[r]), gy);
          const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          st[r] = (st[r] << 1) | (uint64_t)(d <= d2);
        }
        break;
      }
      case OP_PIP: {
        uint32_t x[4], y[4];
        unpack(load4(cols.p[I[1]], row, n), x);
        unpack(load4(cols.p[I[2]], row, n), y);
        float px[4], py[4];
        uint32_t cr[4] = {0, 0, 0, 0};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          px[r] = __uint_as_float(x[r]);
          py[r] = __uint_as_float(y[r]);
        }
        const int n_edges = I[6];
        for (int e = 0; e < n_edges; ++e) {
          const int k = I[5] + 5 * e;
          const float ey1 = kf(K, k), ey2 = kf(K, k + 1), ex1 = kf(K, k + 2);
          const float dxe = kf(K, k + 3), den = kf(K, k + 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const bool straddle = (ey1 > py[r]) != (ey2 > py[r]);
            const float xint = __fadd_rn(
                ex1, __fdiv_rn(__fmul_rn(__fsub_rn(py[r], ey1), dxe), den));
            cr[r] += (uint32_t)(straddle & (px[r] < xint));
          }
        }
        const uint32_t neg = I[7] != 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) st[r] = (st[r] << 1) | (uint64_t)((cr[r] & 1u) ^ neg);
        break;
      }
      case OP_CMP_F32: {
        uint32_t c[4];
        unpack(load4(cols.p[I[1]], row, n), c);
        const float v = kf(K, I[5]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st[r] = (st[r] << 1) | (uint64_t)cmp_f32(I[7], __uint_as_float(c[r]), v);
        break;
      }
      case OP_CMP_I32: {
        uint32_t c[4];
        unpack(load4(cols.p[I[1]], row, n), c);
        const int v = (int)K[I[5]];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int a = (int)c[r];
          st[r] = (st[r] << 1) | (uint64_t)cmp_from(I[7], a < v, a == v);
        }
        break;
      }
      case OP_CMP_I64: {
        uint32_t hi[4], lo[4];
        unpack(load4(cols.p[I[1]], row, n), hi);
        unpack(load4(cols.p[I[2]], row, n), lo);
        const int vh = (int)K[I[5]];
        const uint32_t vl = K[I[5] + 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = (int)hi[r];
          const bool lt = (h < vh) || (h == vh && lo[r] < vl);
          const bool eq = (h == vh) && (lo[r] == vl);
          st[r] = (st[r] << 1) | (uint64_t)cmp_from(I[7], lt, eq);
        }
        break;
      }
      case OP_AND:
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = st[r] & 1u;
          st[r] >>= 1;
          st[r] &= ~(uint64_t)1 | b;
        }
        break;
      case OP_OR:
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = st[r] & 1u;
          st[r] = (st[r] >> 1) | b;
        }
        break;
      default:  // OP_NOT
#pragma unroll
        for (int r = 0; r < 4; ++r) st[r] ^= 1u;
        break;
    }
  }
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row + r < n) bits |= (uint32_t)(st[r] & 1u) << r;
  }
  return bits;
}

__device__ __forceinline__ void load_program(const uint32_t* __restrict__ prog,
                                             int words, uint32_t* sm) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) sm[i] = prog[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
filter_scan_count_kernel(Cols cols, const uint32_t* __restrict__ prog,
                         int n_instr, int n_const, long long n,
                         int* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  load_program(prog, n_instr * kInstrWords + n_const, sm);
  const int* ins = reinterpret_cast<const int*>(sm);
  const uint32_t* K = sm + n_instr * kInstrWords;
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    c += __popc(eval_quad(cols, ins, n_instr, K, 4 * i, n));
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

__global__ void __launch_bounds__(kThreads)
filter_scan_mask_kernel(Cols cols, const uint32_t* __restrict__ prog,
                        int n_instr, int n_const, long long n,
                        uint8_t* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  load_program(prog, n_instr * kInstrWords + n_const, sm);
  const int* ins = reinterpret_cast<const int*>(sm);
  const uint32_t* K = sm + n_instr * kInstrWords;
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < quads; i += stride) {
    const long long row = 4 * i;
    const uint32_t bits = eval_quad(cols, ins, n_instr, K, row, n);
    if (row + 4 <= n) {
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
  long long quads = (n + 3) / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 8;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// Plain C entry point (bound with ctypes). `col_ptrs` is HOST memory with
// n_cols device pointers (copied into the kernel parameters); `prog` is a
// DEVICE buffer of n_instr * 8 instruction words followed by n_const
// constant words. For the count, `out` is one int32 that this call zeroes
// on `stream` first. Returns cudaGetLastError() after the launch.
extern "C" int gm_filter_scan(const unsigned long long* col_ptrs, int n_cols,
                              const uint32_t* prog, int n_instr, int n_const,
                              long long n, int want_mask, void* out,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int words = n_instr * kInstrWords + n_const;
  if (n_cols < 0 || n_cols > kMaxCols || n_instr < 1 || n_const < 0 ||
      words > kMaxProgramWords)
    return (int)cudaErrorInvalidValue;
  Cols cols = {};
  for (int i = 0; i < n_cols; ++i)
    cols.p[i] = reinterpret_cast<const uint32_t*>(col_ptrs[i]);
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const int grid = grid_for(n);
    const size_t smem = (size_t)words * sizeof(uint32_t);
    if (want_mask) {
      filter_scan_mask_kernel<<<grid, kThreads, smem, stream>>>(
          cols, prog, n_instr, n_const, n, static_cast<uint8_t*>(out));
    } else {
      filter_scan_count_kernel<<<grid, kThreads, smem, stream>>>(
          cols, prog, n_instr, n_const, n, static_cast<int*>(out));
    }
  }
  return (int)cudaGetLastError();
}
