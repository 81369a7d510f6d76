// Dim-plane key scan: count and mask over the de-interleaved Z3/Z2 key
// planes with runtime query bounds.
//
// Replaces: geomesa_tpu/ops/zscan.py::build_z3_dimscan_rt (count
// pallas_call at zscan.py:643, mask at :669) and
// geomesa_tpu/ops/zscan.py::build_z2_dimscan_rt (count :498, mask :521).
// One template serves both: NR = 0 is the 2-plane z2 scan, NR in
// {1, 2, 4, 8} the 3-plane z3 scan with NR inclusive bt ranges. The
// Q-batched scan of the scheduler's fused paths (gm_dimscan_batched, its
// own section below) answers up to 64 such queries in one pass.
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
// 2^26 rows). Bound on this card: the bytes (the planes once, 12 B a row z3,
// 8 B z2; 1 B a row and query for the mask) against the operations of the
// way the group takes. The wrapper (ops/zscan.py _BatchedDimScan) picks one
// of two ways by the group's shape: the compare loop for small groups, the
// interval lookup for the others.
//
// The compare way (gm_dimscan_batched_compare). Each thread loads its quad
// of rows once and tests every query of the group against it, the query
// matrix (at most 64 x 20 words) staged once per block in shared memory:
// Q x (4 + 2R) compares a row (each also ANDs or ORs into a predicate), so
// its work grows with Q. The count reduces each query per warp
// (__reduce_add_sync, the warp's lanes stepping through the rows together)
// into per-warp counters in shared memory, then one atomic per block and
// query. The mask writes each query's 4 bits of a quad with one store into
// the (Q, n) byte matrix (quad.cuh store_bits), one contiguous row of n
// bytes per query, so that a query's host take reads one row. With a
// validity plane, each quad's hit bits of every query are ANDed with its
// rows' validity bits.

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
void launch_compare_v(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
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
void launch_compare(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
                    const uint8_t* valid, long long n, const uint32_t* qmat, int nq,
                    int want_mask, void* out, cudaStream_t stream) {
  if (valid) {
    launch_compare_v<NR, true>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream);
  } else {
    launch_compare_v<NR, false>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream);
  }
}

// The lookup way (gm_dimscan_batched). The host packs the group once. In
// each dimension (nx, ny and, z3, bt) the cuts of its ranges -- lo and hi + 1
// of every range with lo <= hi, none for hi = 0xFFFFFFFF, none at 0 -- split
// the uint32 line into at most 2QR + 1 intervals, and the same queries'
// ranges hold every value of one interval. So each interval has a 64-bit
// membership word (bit q: a range of query q holds it; a query's bt ranges
// OR together), and a row's hit word is the AND of the words of its three
// intervals. The m sorted cuts of a dimension are padded with 0xFFFFFFFF to
// 2^d - 1 (d = bit length of m, at most 11) and laid out breadth-first
// (Eytzinger: node i's children are 2i and 2i + 1, e[0] unused), so a row
// finds its interval in d steps i = 2i + (v >= e[i]) that every lane takes
// alike (no branch; taken on shared addresses, a load, a compare, a select
// and a shift-add a level), and the first 5 levels' nodes lie in distinct
// banks or are read by every lane at once. After d steps, i - 2^d is the number of
// cuts <= v; the 2^d words are indexed by it, those past the m + 1 real
// intervals repeating the last one, so that a row at 0xFFFFFFFF, which the
// padding does not exceed, lands on the top interval's word.
//
// Its ALU work grows with log2 of the cuts, not with Q: about 2 operations
// a level and row, 20 levels at phase 3f's Q = 64 and R = 1, against the
// compare way's 384 compares. Each block copies the table (3 words a leaf:
// the cut and the 64-bit word; at most 2^8 leaves for nx and ny, 2^11 for
// bt, 30 KB) into shared memory once. A thread loads its quad of rows with
// 16-byte loads and walks its 4 rows down each tree together (4 independent
// loads a level). Hit words go to quad.cuh: the count's bit-plane counters
// (one atomic per block and query) and the mask's byte-permute transpose
// into the (Q, n) byte matrix. The mask is bound by its writes (64 B a row
// at Q = 64), so its threads take two quads, and each query's 8 bytes of
// them leave with one store. With a validity plane, a dead row's hit word
// is 0.

constexpr int kMaxDepth = 11;  // up to 2^11 - 1 cuts a dimension
constexpr long long kMaxDimTableBytes = 3LL * 3 * (1 << kMaxDepth) * 4;

// Words of a group's table: per dimension 2^d 64-bit words and 2^d cuts,
// padded to a multiple of 4 (16-byte copies).
inline long long dim_table_words(int n_dims, int dx, int dy, int dt) {
  const long long leaves = (1LL << dx) + (1LL << dy) + (n_dims == 3 ? (1LL << dt) : 0);
  return (3 * leaves + 3) / 4 * 4;
}

// Shared-memory loads by 32-bit shared address: the search steps on
// addresses, so that a level costs a load, a compare, a select and a
// shift-add.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ unsigned long long lds64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}

// One dimension of a block's table: the shared address of its tree's
// entry 0 (node i at tree + 4i), its depth, and `word`, which turns the
// address of a leaf (tree + 4 (2^depth + rank)) into its word's address
// (2 x leaf + word).
struct Dim {
  uint32_t tree, word;
  int depth;
};

// Each of a quad's 4 values down the tree: a = tree + 4i steps to the
// child tree + 4 (2i + (v >= e[i])) = 2a - tree (+ 4), and ends on the
// leaf of its rank. Returns the 4 leaves' words.
__device__ __forceinline__ void dim_words(const Dim& dm, const uint4& v,
                                          unsigned long long (&w)[4]) {
  const uint32_t left = 0u - dm.tree, right = 4u - dm.tree;
  uint32_t a0 = dm.tree + 4, a1 = a0, a2 = a0, a3 = a0;
  for (int k = 0; k < dm.depth; ++k) {
    a0 = 2 * a0 + (v.x >= lds32(a0) ? right : left);
    a1 = 2 * a1 + (v.y >= lds32(a1) ? right : left);
    a2 = 2 * a2 + (v.z >= lds32(a2) ? right : left);
    a3 = 2 * a3 + (v.w >= lds32(a3) ? right : left);
  }
  w[0] = lds64(2 * a0 + dm.word);
  w[1] = lds64(2 * a1 + dm.word);
  w[2] = lds64(2 * a2 + dm.word);
  w[3] = lds64(2 * a3 + dm.word);
}

// A block's copy of the table: the 2^d words of nx, ny and (BT) bt, then
// their trees of 2^d cuts.
struct Tables {
  Dim x, y, t;
};

template <bool BT>
__device__ __forceinline__ Tables stage_tables(const uint32_t* table, int words, int dx, int dy,
                                               int dt, uint4* stab) {
  const uint4* t4 = reinterpret_cast<const uint4*>(table);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) stab[i] = t4[i];
  const uint32_t w0 = (uint32_t)__cvta_generic_to_shared(stab);
  const uint32_t lx = 1u << dx, ly = 1u << dy, lt = BT ? 1u << dt : 0u;
  Tables t;
  t.x.tree = w0 + 8 * (lx + ly + lt);
  t.y.tree = t.x.tree + 4 * lx;
  t.t.tree = t.y.tree + 4 * ly;
  // a leaf at tree + 4 (2^d + rank) has its word at words + 8 rank
  t.x.word = w0 - 2 * t.x.tree - 8 * lx;
  t.y.word = w0 + 8 * lx - 2 * t.y.tree - 8 * ly;
  t.t.word = w0 + 8 * (lx + ly) - 2 * t.t.tree - 8 * lt;
  t.x.depth = dx;
  t.y.depth = dy;
  t.t.depth = dt;
  return t;
}

// The hit words of a quad's rows: bit q of hits[r] for query q; 0 for a
// row past n or (VALID) dead.
template <bool BT, bool VALID>
__device__ __forceinline__ void quad_words(const Tables& t, const Quad& d, const uint8_t* valid,
                                           long long row, long long n,
                                           unsigned long long (&hits)[4]) {
  uint32_t live = d.rows >= 4 ? 0xfu : (d.rows <= 0 ? 0u : (1u << d.rows) - 1u);
  if (VALID) live &= valid_bits(valid, row, n);
  unsigned long long wy[4], wt[4];
  dim_words(t.x, d.a, hits);
  dim_words(t.y, d.b, wy);
  if (BT) dim_words(t.t, d.c, wt);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    unsigned long long h = hits[r] & wy[r];
    if (BT) h &= wt[r];
    hits[r] = h & (0ull - (unsigned long long)((live >> r) & 1u));
  }
}

// The count: a thread's quads, their hit words into the bit-plane counters.
template <bool BT, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_group_count_kernel(const uint32_t* __restrict__ nx, const uint32_t* __restrict__ ny,
                           const uint32_t* __restrict__ bt, const uint8_t* __restrict__ valid,
                           long long n, const uint32_t* __restrict__ table, int words, int nq,
                           int dx, int dy, int dt, int* __restrict__ out) {
  extern __shared__ uint4 stab[];
  __shared__ int counts[kWarps][kMaxBatch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tables t = stage_tables<BT>(table, words, dx, dy, dt, stab);
  for (int q = lane; q < kMaxBatch; q += 32) counts[warp][q] = 0;
  __syncthreads();
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
    unsigned long long hits[4];
    quad_words<BT, VALID>(t, load_quad<BT ? 1 : 0>(nx, ny, bt, row, n), valid, row, n, hits);
#pragma unroll
    for (int r = 0; r < 4; ++r) count_hits(planes, hits[r]);
    if (++since == kFlushQuads) {
      flush_counts(planes, nq, counts[warp], lane);
      since = 0;
    }
  }
  flush_counts(planes, nq, counts[warp], lane);
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += counts[w][q];
    if (c) atomicAdd(out + q, c);
  }
}

// The mask: a thread's 8 rows at a time (two quads), so that each query's
// bytes of them leave with one 8-byte store (quad.cuh store_oct) and a
// warp writes 256 contiguous bytes of each query's row.
template <bool BT, bool VALID>
__global__ void __launch_bounds__(kThreads)
dimscan_group_mask_kernel(const uint32_t* __restrict__ nx, const uint32_t* __restrict__ ny,
                          const uint32_t* __restrict__ bt, const uint8_t* __restrict__ valid,
                          long long n, const uint32_t* __restrict__ table, int words, int nq,
                          int dx, int dy, int dt, uint8_t* __restrict__ out) {
  extern __shared__ uint4 stab[];
  const Tables t = stage_tables<BT>(table, words, dx, dy, dt, stab);
  __syncthreads();
  const long long octs = (n + 7) / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < octs; i += stride) {
    const long long row = 8 * i;
    const Quad d0 = load_quad<BT ? 1 : 0>(nx, ny, bt, row, n);
    const Quad d1 = load_quad<BT ? 1 : 0>(nx, ny, bt, row + 4, n);
    unsigned long long lo[4], hi[4];
    quad_words<BT, VALID>(t, d0, valid, row, n, lo);
    quad_words<BT, VALID>(t, d1, valid, row + 4, n, hi);
    store_oct(out, n, nq, row, lo, hi);
  }
}

template <bool BT, bool VALID>
cudaError_t launch_batched_v(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
                             const uint8_t* valid, long long n, const uint32_t* table, int words,
                             int nq, int dx, int dy, int dt, bool mask, void* out,
                             cudaStream_t stream) {
  const size_t smem = (size_t)words * sizeof(uint32_t);
  if (mask) {
    auto kern = dimscan_group_mask_kernel<BT, VALID>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxDimTableBytes);
    if (attr != cudaSuccess) return attr;
    // 8 rows a thread: the grid of a pass over n / 2 quads
    kern<<<grid_for((n + 1) / 2), kThreads, smem, stream>>>(
        nx, ny, bt, valid, n, table, words, nq, dx, dy, dt, static_cast<uint8_t*>(out));
  } else {
    auto kern = dimscan_group_count_kernel<BT, VALID>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxDimTableBytes);
    if (attr != cudaSuccess) return attr;
    kern<<<grid_for(n), kThreads, smem, stream>>>(
        nx, ny, bt, valid, n, table, words, nq, dx, dy, dt, static_cast<int*>(out));
  }
  return cudaGetLastError();
}

template <bool BT>
cudaError_t launch_batched(const uint32_t* nx, const uint32_t* ny, const uint32_t* bt,
                           const uint8_t* valid, long long n, const uint32_t* table, int words,
                           int nq, int dx, int dy, int dt, bool mask, void* out,
                           cudaStream_t stream) {
  return valid ? launch_batched_v<BT, true>(nx, ny, bt, valid, n, table, words, nq, dx, dy, dt,
                                            mask, out, stream)
               : launch_batched_v<BT, false>(nx, ny, bt, valid, n, table, words, nq, dx, dy, dt,
                                             mask, out, stream);
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

// Plain C entry point of the batched scan's lookup way (bound with ctypes).
// `table` is DEVICE memory of `words` uint32, 16-byte aligned, laid out as
// above for nq queries (1 <= nq <= 64) over n_dims planes (2: nx, ny, `bt`
// null; 3: nx, ny, bt): the 2^dx, 2^dy (and 2^dt) 64-bit words, then the
// 2^dx, 2^dy (and 2^dt) cut trees, padded to a multiple of 4 words; depths
// 0 to 11.
// `valid` as for gm_dimscan. For the count, `out` is nq int32 that this
// call zeroes on `stream` first; for the mask, nq * n bytes, row q holding
// query q's hits. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernels do not
// take.
extern "C" int gm_dimscan_batched(const uint32_t* nx, const uint32_t* ny,
                                  const uint32_t* bt, const uint8_t* valid, long long n,
                                  const uint32_t* table, int words, int nq, int n_dims,
                                  int dx, int dy, int dt, int want_mask, void* out,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto depth_ok = [](int d) { return d >= 0 && d <= kMaxDepth; };
  if (nq < 1 || nq > kMaxBatch || (n_dims != 2 && n_dims != 3) || !depth_ok(dx) ||
      !depth_ok(dy) || !depth_ok(dt) || (n_dims == 2 && dt != 0) ||
      words != dim_table_words(n_dims, dx, dy, dt) ||
      (n_dims == 3 && bt == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  if (!want_mask) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * nq, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const cudaError_t e =
        n_dims == 3 ? launch_batched<true>(nx, ny, bt, valid, n, table, words, nq, dx, dy, dt,
                                        want_mask != 0, out, stream)
                    : launch_batched<false>(nx, ny, nullptr, valid, n, table, words, nq, dx, dy, 0,
                                        want_mask != 0, out, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the batched scan's compare way (bound with ctypes).
// `qmat` is DEVICE memory: nq rows of 4 + 2 * n_ranges uint32 words, 1 <= nq
// <= 64; `valid` as for gm_dimscan. For the count, `out` is nq int32 that
// this call zeroes on `stream` first; for the mask, nq * n bytes, row q
// holding query q's hits. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int gm_dimscan_batched_compare(const uint32_t* nx, const uint32_t* ny,
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
      case 0: launch_compare<0>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 1: launch_compare<1>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 2: launch_compare<2>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 4: launch_compare<4>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      case 8: launch_compare<8>(nx, ny, bt, valid, n, qmat, nq, want_mask, out, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (n_ranges != 0 && n_ranges != 1 && n_ranges != 2 && n_ranges != 4 &&
             n_ranges != 8) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
