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
// diverges; the program sits in shared memory and is read by all threads
// at one address (a broadcast, no bank conflicts).
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
// compute-bound above a few dozen edges. An interpreter that issues its
// own loads keeps at most two 16-byte loads of a thread in flight (the
// loads of one instruction wait for the compute of the one before), and
// reads a column twice when two instructions name it; that held the first
// version of this kernel at ~78% of the bytes bound. This design takes the
// loads out of the interpreter, as the reference's BlockSpec pipeline
// copies each column's tile into VMEM before the filter runs over it:
//
// - Persistent blocks (the host sizes the grid to the blocks the SMs hold)
//   walk tiles of R rows. One producer warp per block copies each tile's
//   columns, every column the program names once however many
//   instructions read it, and the tile's validity bytes into one of S >= 2
//   shared-memory stages with 1-D bulk copies (TMA, cp.async.bulk) that
//   complete on the stage's `full` mbarrier. Eight consumer warps
//   interpret the staged tile out of shared memory (lane i reads 16 bytes
//   of row quad i: a warp reads 512 contiguous bytes of a column, no bank
//   conflict) and arrive on the stage's `empty` mbarrier; the producer
//   then refills it. No block-wide barrier stands between two tiles, and
//   the copies of the next tiles are in flight while a tile is read.
// - The mask of a tile goes to its stage's mask buffer (one 32-bit word
//   for 4 rows) and leaves by one bulk store, which the producer issues
//   once the consumers are done and waits to have read before it refills
//   the stage.
// - The host chooses R and S (ops/filter_scan.py stage_plan) from the
//   number of columns and the program's words so that program and stages
//   fit in 227 KB: 2 stages of 2048 rows (1024 from 3 columns on) on 3
//   blocks an SM where they fit (a sweep of R, S and blocks on the H100
//   put these first), fewer blocks, more stages and at last fewer rows for
//   wider programs. Bulk copies beat cp.async 16-byte copies by every
//   thread at every shape tried, and every part of the layout starts on
//   128 bytes.
// - Ragged edges: bulk copies move 16-byte multiples; the last 1-3 rows of
//   a plane and the validity bytes around 16-byte boundaries are copied by
//   plain loads before the stage's barrier arrives, so nothing past a
//   plane's end is read. Rows past n are masked off.
// - The count reduces per warp and per block into one partial per block;
//   a second one-block kernel adds them: exact and deterministic, and no
//   memset of the output comes first.
//
// Validity (a streaming index's live rows): with a plane, a row counts, and
// its mask byte is set, only where the program's verdict and its validity
// byte are both set; 1 B/row more, staged with the tile. The plane needs
// only 4-byte alignment. The read is a template parameter chosen by the
// pointer on the host, so a launch without a plane stages nothing for it.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // the consumers
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = kThreads + 32;   // and the producer warp
constexpr int kMaxCols = 64;
constexpr int kInstrWords = 8;
constexpr int kMaxProgramWords = 12288;
constexpr int kMaxStages = 8;
constexpr int kHeader = 256;  // 2 x kMaxStages mbarriers, then the warp sums
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may take
constexpr int kMaxDevices = 64;

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

// One launch's operands, passed by value: C column pointers, 8 for the
// programs of up to 8 columns (a smaller parameter block launches faster
// from the host), else all 64.
template <int C>
struct Params {
  const uint8_t* col[C];  // the planes, 16-byte aligned
  const uint8_t* valid;   // null, or n bytes, 4-byte aligned
  const uint32_t* prog;   // n_instr * 8 instruction words, then n_const
  long long n;
  void* out;  // the mask's n bytes, or one int32 partial per block
  int n_cols, n_instr, n_const, rows, stages;
  int prog_bytes;   // the program's shared-memory bytes (a 128-byte multiple)
  int stage_bytes;  // R rows of each column, the validity bytes, the mask bytes
  int mask_at;      // the mask buffer's offset in a stage
};

// -- shared memory, barriers and bulk copies (PTX) ----------------------------

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sptr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sptr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(sptr(bar)) : "memory");
}

// Wait until the barrier completes the phase of the given parity. A wait
// of more than ~2^34 cycles (seconds; a stage's copies take microseconds)
// can only be a fault: it traps, and the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = sptr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

// Global -> shared, `bytes` a multiple of 16, both ends 16-byte aligned;
// completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          sptr(dst)),
      "l"(src), "r"(bytes), "r"(sptr(bar))
      : "memory");
}

// -- the interpreter ------------------------------------------------------------

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

// 4 consecutive rows of column slot `c` of a stage (R rows a column).
__device__ __forceinline__ void quad(const uint32_t* st, int R, int c, int row,
                                     uint32_t out[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(st + c * R + row);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ float kf(const uint32_t* K, int i) {
  return __uint_as_float(K[i]);
}

// Run the program for the 4 stage rows starting at `row`; returns their
// results as bits 0..3 (the caller masks rows past n).
__device__ __forceinline__ uint32_t eval_quad(const uint32_t* st, int R, const int* ins,
                                              int n_instr, const uint32_t* K, int row) {
  uint64_t s[4] = {0, 0, 0, 0};
  for (int pc = 0; pc < n_instr; ++pc) {
    const int* I = ins + pc * kInstrWords;
    const int op = I[0];
    switch (op) {
      case OP_TRUE:
      case OP_FALSE: {
        const uint64_t b = op == OP_TRUE;
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r] = (s[r] << 1) | b;
        break;
      }
      case OP_BBOX: {
        uint32_t x[4], y[4];
        quad(st, R, I[1], row, x);
        quad(st, R, I[2], row, y);
        const float xmin = kf(K, I[5]), ymin = kf(K, I[5] + 1);
        const float xmax = kf(K, I[5] + 2), ymax = kf(K, I[5] + 3);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float px = __uint_as_float(x[r]), py = __uint_as_float(y[r]);
          const uint64_t b = (px >= xmin) & (px <= xmax) & (py >= ymin) & (py <= ymax);
          s[r] = (s[r] << 1) | b;
        }
        break;
      }
      case OP_BBOX_ENV: {
        uint32_t x0[4], y0[4], x1[4], y1[4];
        quad(st, R, I[1], row, x0);
        quad(st, R, I[2], row, y0);
        quad(st, R, I[3], row, x1);
        quad(st, R, I[4], row, y1);
        const float xmin = kf(K, I[5]), ymin = kf(K, I[5] + 1);
        const float xmax = kf(K, I[5] + 2), ymax = kf(K, I[5] + 3);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = (__uint_as_float(x1[r]) >= xmin) &
                             (__uint_as_float(x0[r]) <= xmax) &
                             (__uint_as_float(y1[r]) >= ymin) &
                             (__uint_as_float(y0[r]) <= ymax);
          s[r] = (s[r] << 1) | b;
        }
        break;
      }
      case OP_DWITHIN: {
        uint32_t x[4], y[4];
        quad(st, R, I[1], row, x);
        quad(st, R, I[2], row, y);
        const float gx = kf(K, I[5]), gy = kf(K, I[5] + 1), d2 = kf(K, I[5] + 2);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dx = __fsub_rn(__uint_as_float(x[r]), gx);
          const float dy = __fsub_rn(__uint_as_float(y[r]), gy);
          const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          s[r] = (s[r] << 1) | (uint64_t)(d <= d2);
        }
        break;
      }
      case OP_PIP: {
        uint32_t x[4], y[4];
        quad(st, R, I[1], row, x);
        quad(st, R, I[2], row, y);
        float px[4], py[4];
        uint32_t cr[4] = {0, 0, 0, 0};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          px[r] = __uint_as_float(x[r]);
          py[r] = __uint_as_float(y[r]);
        }
        // one pointer walks the edges (an index from K made the compiler
        // rebuild the address from the parameters on every edge)
        const uint32_t* E = K + I[5];
        const uint32_t* const end = E + 5 * I[6];
        for (; E != end; E += 5) {
          const float ey1 = kf(E, 0), ey2 = kf(E, 1), ex1 = kf(E, 2);
          const float dxe = kf(E, 3), den = kf(E, 4);
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
        for (int r = 0; r < 4; ++r) s[r] = (s[r] << 1) | (uint64_t)((cr[r] & 1u) ^ neg);
        break;
      }
      case OP_CMP_F32: {
        uint32_t c[4];
        quad(st, R, I[1], row, c);
        const float v = kf(K, I[5]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[r] = (s[r] << 1) | (uint64_t)cmp_f32(I[7], __uint_as_float(c[r]), v);
        break;
      }
      case OP_CMP_I32: {
        uint32_t c[4];
        quad(st, R, I[1], row, c);
        const int v = (int)K[I[5]];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int a = (int)c[r];
          s[r] = (s[r] << 1) | (uint64_t)cmp_from(I[7], a < v, a == v);
        }
        break;
      }
      case OP_CMP_I64: {
        uint32_t hi[4], lo[4];
        quad(st, R, I[1], row, hi);
        quad(st, R, I[2], row, lo);
        const int vh = (int)K[I[5]];
        const uint32_t vl = K[I[5] + 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = (int)hi[r];
          const bool lt = (h < vh) || (h == vh && lo[r] < vl);
          const bool eq = (h == vh) && (lo[r] == vl);
          s[r] = (s[r] << 1) | (uint64_t)cmp_from(I[7], lt, eq);
        }
        break;
      }
      case OP_AND:
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = s[r] & 1u;
          s[r] >>= 1;
          s[r] &= ~(uint64_t)1 | b;
        }
        break;
      case OP_OR:
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint64_t b = s[r] & 1u;
          s[r] = (s[r] >> 1) | b;
        }
        break;
      default:  // OP_NOT
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r] ^= 1u;
        break;
    }
  }
  return (uint32_t)(s[0] & 1u) | (uint32_t)(s[1] & 1u) << 1 | (uint32_t)(s[2] & 1u) << 2 |
         (uint32_t)(s[3] & 1u) << 3;
}

// -- the pipeline -------------------------------------------------------------

// Rows of tile t (at most R; fewer in the last tile).
template <typename P>
__device__ __forceinline__ int tile_rows(const P& p, long long t) {
  const long long left = p.n - t * p.rows;
  return left < p.rows ? (int)left : p.rows;
}

// The producer: copy tile t's columns (and validity bytes) into stage `st`
// and arrive on its barrier. Bytes a bulk copy cannot move (the last 1-3
// rows of each column, the validity bytes before and after its 16-byte
// boundaries) are copied by plain loads first, so they are in place when
// the barrier's phase completes; the rest of the last row quad is zero.
template <bool VALID, typename P>
__device__ void issue_tile(const P& p, uint8_t* st, uint64_t* bar, long long t) {
  const int R = p.rows;
  const long long row0 = t * R;
  const int L = tile_rows(p, t);
  const int whole = L & ~3;
  const uint32_t body = 4u * (uint32_t)whole;
  uint32_t tx = body * (uint32_t)p.n_cols;
  if (L != whole) {
    for (int c = 0; c < p.n_cols; ++c) {
      const uint32_t* g = reinterpret_cast<const uint32_t*>(p.col[c]) + row0;
      uint32_t* s = reinterpret_cast<uint32_t*>(st) + c * R;
      for (int r = whole; r < whole + 4; ++r) s[r] = r < L ? g[r] : 0u;
    }
  }
  const uint8_t* vg = nullptr;
  uint8_t* vs = nullptr;
  int head = 0, vbody = 0;
  if (VALID) {
    // row r's byte sits at shared byte m + r of the stage's validity area,
    // m the plane's offset from 16 bytes, so that the global and shared
    // ends of the bulk part are both 16-byte aligned
    const int m = (int)(reinterpret_cast<uintptr_t>(p.valid) & 15);
    vg = p.valid + row0;
    vs = st + 4 * R * p.n_cols + m;
    head = (16 - m) & 15;
    if (head > L) head = L;
    vbody = (L - head) & ~15;
    for (int i = 0; i < head; ++i) vs[i] = vg[i];
    for (int i = head + vbody; i < L; ++i) vs[i] = vg[i];
    tx += (uint32_t)vbody;
  }
  mbar_arrive_expect_tx(bar, tx);
  if (body) {
    for (int c = 0; c < p.n_cols; ++c)
      bulk_load(st + 4 * R * c, p.col[c] + 4 * row0, body, bar);
  }
  if (VALID && vbody) bulk_load(vs + head, vg + head, (uint32_t)vbody, bar);
}

// Bits 0..3 of the validity bytes of 4 staged rows (one 32-bit word).
__device__ __forceinline__ uint32_t valid_quad(const uint8_t* v) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(v);
  return (w & 1u) | (w >> 7 & 2u) | (w >> 14 & 4u) | (w >> 21 & 8u);
}

// Lane 0 of the producer warp, once the consumers are done with tile t:
// its mask leaves by one bulk store (the last L % 16 bytes by plain
// stores), and the store has read the stage's mask buffer when this
// returns, so the stage may take its next tile.
template <typename P>
__device__ __forceinline__ void store_mask(const P& p, const uint8_t* mk, long long t) {
  const int L = tile_rows(p, t);
  uint8_t* o = static_cast<uint8_t*>(p.out) + t * p.rows;
  const int bulk = L & ~15;
  if (bulk) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(o),
                 "r"(sptr(mk)), "r"((uint32_t)bulk)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  for (int i = bulk; i < L; ++i) o[i] = mk[i];
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// kWarps consumer warps interpret the staged tiles; one more warp, the
// producer, fills the stages and sends the masks out. Stage s has a `full`
// barrier (the producer's arrive and the copies' bytes complete a phase)
// and an `empty` one (one arrive per consumer warp), so no block-wide
// barrier stands between two tiles. The kernels carry the entry point's
// gm_filter_scan prefix, so a profiler trace names them by it.
template <bool VALID, bool MASK, int C>
__global__ void __launch_bounds__(kBlock, 4) gm_filter_scan_kernel(const Params<C> p) {
  extern __shared__ __align__(128) uint8_t sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kMaxStages;
  int* warp_sums = reinterpret_cast<int*>(empty + kMaxStages);
  uint32_t* prog = reinterpret_cast<uint32_t*>(sm + kHeader);
  uint8_t* stages = sm + kHeader + p.prog_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.rows, S = p.stages;
  const long long tiles = (p.n + R - 1) / R;
  const int words = p.n_instr * kInstrWords + p.n_const;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < words; i += kBlock) prog[i] = __ldg(p.prog + i);
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (lane != 0) return;
    long long k = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
      const int s = (int)(k % S);
      uint8_t* st = stages + s * p.stage_bytes;
      if (k >= S) {  // the stage's last tile, t - S * grid, is consumed
        mbar_wait(&empty[s], (uint32_t)((k / S - 1) & 1));
        if (MASK) store_mask(p, st + p.mask_at, t - (long long)S * gridDim.x);
      }
      issue_tile<VALID>(p, st, &full[s], t);
    }
    if (!MASK) return;
    // the masks of the last tile of each stage
    for (long long j = k > S ? k - S : 0; j < k; ++j) {
      const int s = (int)(j % S);
      mbar_wait(&empty[s], (uint32_t)((j / S) & 1));
      store_mask(p, stages + s * p.stage_bytes + p.mask_at, blockIdx.x + j * gridDim.x);
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  const int* ins = reinterpret_cast<const int*>(prog);
  const uint32_t* K = prog + p.n_instr * kInstrWords;
  const int vm = VALID ? (int)(reinterpret_cast<uintptr_t>(p.valid) & 15) : 0;
  int count = 0;
  int s = 0;
  uint32_t parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    uint8_t* st = stages + s * p.stage_bytes;
    mbar_wait(&full[s], parity);
    const int L = tile_rows(p, t);
    uint32_t* mk = reinterpret_cast<uint32_t*>(st + p.mask_at);
    for (int q = tid; 4 * q < L; q += kThreads) {
      uint32_t bits = eval_quad(reinterpret_cast<const uint32_t*>(st), R, ins, p.n_instr, K,
                                4 * q);
      if (4 * q + 4 > L) bits &= (1u << (L - 4 * q)) - 1u;
      if (VALID) bits &= valid_quad(st + 4 * R * p.n_cols + vm + 4 * q);
      if (MASK) {
        mk[q] = (bits & 1u) | (bits >> 1 & 1u) << 8 | (bits >> 2 & 1u) << 16 |
                (bits >> 3 & 1u) << 24;
      } else {
        count += __popc(bits);
      }
    }
    // the mask words are read next by the bulk store (the async proxy)
    if (MASK) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == S) {
      s = 0;
      parity ^= 1u;
    }
  }
  if (MASK) return;
  // the block's partial, written by every block (0 for a block with no
  // tile); the consumers meet at named barrier 1, without the producer
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_sums[warp] = count;
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
  if (warp == 0) {
    int v = lane < kWarps ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) static_cast<int*>(p.out)[blockIdx.x] = v;
  }
}

// One block: out[0] = the sum of the `blocks` partials that follow it.
__global__ void __launch_bounds__(kThreads) gm_filter_scan_sum(int* __restrict__ out, int blocks) {
  __shared__ int warp_sums[kThreads / 32];
  int v = 0;
  for (int i = threadIdx.x; i < blocks; i += kThreads) v += out[1 + i];
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) out[0] = v;
  }
}

// The dynamic shared memory limit of each kernel instance, raised to 227 KB
// once per device (bit i of ready[device] for instance i).
std::atomic<unsigned> ready[kMaxDevices];
constexpr int kNarrowCols = 8;

template <bool VALID, bool MASK, int C>
int launch(const Params<C>& p, int grid, size_t smem, void* out, int dev, cudaStream_t stream) {
  auto kern = gm_filter_scan_kernel<VALID, MASK, C>;
  const unsigned bit = 1u << (4 * (C != kNarrowCols) + 2 * VALID + MASK);
  cudaError_t e;
  if (!(ready[dev].load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    // all of the SM's 228 KB as shared memory: the stages bypass L1
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    ready[dev].fetch_or(bit, std::memory_order_acq_rel);
  }
  kern<<<grid, kBlock, smem, stream>>>(p);
  if (!MASK) gm_filter_scan_sum<<<1, kThreads, 0, stream>>>(static_cast<int*>(out), grid);
  return (int)cudaGetLastError();
}

}  // namespace

// One plane set's launch operands, built once on the host
// (ops/filter_scan.py _Launch mirrors this layout).
struct FilterScanLaunch {
  unsigned long long cols[kMaxCols];  // device pointers of the column planes
  unsigned long long valid;           // 0: every row live
  unsigned long long prog;            // device buffer of the program's words
  long long n;
  int n_cols, n_instr, n_const;
  int rows;    // R, a multiple of 32
  int stages;  // S, 2 to 8
  int grid;    // persistent blocks
  int device;  // the planes' device, made current for the launch if it is not
};

namespace {

// The shared-memory layout (ops/filter_scan.py stage_smem computes it too):
// the header, the program, and S stages of R rows of each column, R + 16
// validity bytes and R mask bytes; every part starts on 128 bytes (on the
// H100, bulk copies to 16-byte but not 128-byte aligned stages read slower).
int pad128(int b) { return (b + 127) & ~127; }

int prog_bytes(const FilterScanLaunch* a) {
  return pad128(4 * (a->n_instr * kInstrWords + a->n_const));
}

int mask_at(const FilterScanLaunch* a) {
  return 4 * a->rows * a->n_cols + (a->valid ? pad128(a->rows + 16) : 0);
}

int stage_bytes(const FilterScanLaunch* a, int want_mask) {
  return mask_at(a) + (want_mask ? pad128(a->rows) : 0);
}

// Fill one launch's parameters from the host record and launch the kernel
// instance for its validity plane and output.
template <int C>
int run(const FilterScanLaunch* a, size_t smem, void* out, int want_mask, cudaStream_t stream) {
  Params<C> p = {};
  for (int i = 0; i < a->n_cols; ++i) p.col[i] = reinterpret_cast<const uint8_t*>(a->cols[i]);
  p.valid = reinterpret_cast<const uint8_t*>(a->valid);
  p.prog = reinterpret_cast<const uint32_t*>(a->prog);
  p.n = a->n;
  p.out = want_mask ? out : static_cast<void*>(static_cast<int*>(out) + 1);
  p.n_cols = a->n_cols;
  p.n_instr = a->n_instr;
  p.n_const = a->n_const;
  p.rows = a->rows;
  p.stages = a->stages;
  p.prog_bytes = prog_bytes(a);
  p.stage_bytes = stage_bytes(a, want_mask);
  p.mask_at = mask_at(a);
  if (a->valid) {
    return want_mask ? launch<true, true, C>(p, a->grid, smem, out, a->device, stream)
                     : launch<true, false, C>(p, a->grid, smem, out, a->device, stream);
  }
  return want_mask ? launch<false, true, C>(p, a->grid, smem, out, a->device, stream)
                   : launch<false, false, C>(p, a->grid, smem, out, a->device, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). `a` is HOST memory (see
// FilterScanLaunch); `valid` is null (every row live) or n bytes, 4-byte
// aligned, 0 for a dead row. For a mask, `out` is n bytes; for the count,
// `out` is 1 + grid int32: the total lands in out[0] (nothing needs zeroing
// first), the blocks' partials after it. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for operands the kernel does not
// take (a layout over 227 KB among them).
extern "C" int gm_filter_scan(const FilterScanLaunch* a, void* out, int want_mask,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int words = a->n_instr * kInstrWords + a->n_const;
  if (a->n_cols < 0 || a->n_cols > kMaxCols || a->n_instr < 1 || a->n_const < 0 ||
      words > kMaxProgramWords || a->rows < 32 || a->rows % 32 || a->rows > kMaxSmem ||
      a->stages < 2 || a->stages > kMaxStages || a->grid < 1 || a->n < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kHeader + prog_bytes(a) + (size_t)a->stages * stage_bytes(a, want_mask);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (a->device < 0 || a->device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (want_mask && a->n == 0) return (int)cudaGetLastError();
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current != a->device && (e = cudaSetDevice(a->device)) != cudaSuccess) return (int)e;
  int rc = a->n_cols <= kNarrowCols ? run<kNarrowCols>(a, smem, out, want_mask, stream)
                                    : run<kMaxCols>(a, smem, out, want_mask, stream);
  if (current != a->device && (e = cudaSetDevice(current)) != cudaSuccess && rc == 0) rc = (int)e;
  return rc;
}
