// Density rasterization: a (height, width) grid of the rows that are masked
// in and inside the viewport, as a count or as a sum of float32 weights.
//
// Replaces: geomesa_tpu/ops/density_pallas.py::build_density_pallas (its
// pallas_call at density_pallas.py:124, the one-hot MXU contraction, plus
// the XLA pre-pass at :105-119 that computes pixel ids and folds the mask),
// and the XLA scatter engine the counterpart keeps for grids past 512x512
// (geomesa_tpu/device_cache.py:2376-2418). The 512-pixel split is a TPU
// limit (VMEM holds the accumulator and the one-hot width); here the two
// engines below serve every grid of up to 2^31 - 1 cells.
//
// Per row: read x and y (float32), widen to float64 and compute the pixel
// as process/density.py::_pixel_ids does under x64 --
//   px = clip(floor((x - xmin) * sx), 0, width - 1)
//   inside = xmin <= x <= xmax && ymin <= y <= ymax
// with sx = width / (xmax - xmin) computed by the caller in float64 (0 for
// an axis of zero extent, whose rows on the line land in cell 0) -- so that
// f32-exact data lands in the reference's pixels bit for bit, border pixels
// included. __dsub_rn/__dmul_rn and -fmad=false keep every product and
// difference rounded on its own. Rows with a zero mask byte, or outside the
// viewport, add nothing (their weights are never read into a sum, so a
// non-finite weight there changes nothing); the rest add 1 (int32, exact)
// or their weight (float64). The wrapper zeroes the accumulator and casts
// it to the float32 grid.
//
// Bound on this card: memory, 8 B/row of coordinates plus 1 B of mask and
// 4 B of weight (the float64 pixel math hides under the loads: a probe
// that loads and bins without adding ran at the bytes rate). What holds a
// scatter back is the adds: unsorted rows send one atomic each to device
// memory, and clustered data sends most of them to a few L2 lines, where
// they serialise. Two engines take the adds off device memory; the wrapper
// chooses one by grid size and kind alone (a static choice, not a
// fallback, set by chip_smoke.py's timings), and a timing can force any:
//  - cluster engine (counted grids of at most 2^18 cells): a thread-block
//    cluster of C = 1, 2, 4 or 8 CTAs on neighbouring SMs holds the whole
//    int32 grid in distributed shared memory, each CTA a contiguous slice
//    of at most 32,768 cells (128 KB). A row adds with a shared-memory
//    atomic into its own CTA's slice when that owns its cell; for a
//    neighbour's cell it adds into a 4,096-slot table of neighbour cells
//    in its own shared memory (the hot-cell table below), and only a
//    table miss crosses to the neighbour as a red.shared::cluster. Each
//    CTA sends its table on at the end; after cluster.sync() each CTA
//    merges its slice into the grid with one global atomic per non-zero
//    cell. The launch holds as many clusters as can be resident at once
//    (one CTA per SM), and a grid-stride loop walks the rows. One CTA runs
//    near the bytes bound; what C > 1 pays for is the traffic between SMs,
//    which the table keeps to the cold cells;
//  - hot-cell engine (weighted grids, and counted grids past 2^18 cells):
//    each block keeps a 4,096-slot table of cells in shared memory (keys
//    claimed by atomicCAS, two linear probes) with an int32 count or a
//    float64 sum per slot. A row whose cell holds a slot adds there; a miss
//    adds to the grid with a global atomic. Each block flushes its occupied
//    slots with one global atomic each. Clustered data keeps its few hot
//    cells in the table; uniform data over a large grid misses, and its
//    global atomics bound it.
// Both engines first merge runs: lanes of a warp whose rows hit the cell of
// the lane before them (rows sorted by key come so) add once, through the
// run's first lane, which adds the run's count or its weight sum (summed in
// lane order from a per-warp scratch row). A shared float64 atomicAdd is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN.64), so a run of
// equal cells must not reach it lane by lane. Each lane holds 4 rows per
// iteration (rows base + 32k + lane: coalesced loads, all 4 issued before
// any math). Integer sums are order-independent, so counts are exact and
// deterministic; float64 weight sums depend on the order blocks run in.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerLane = 4;
constexpr long long kWarpRows = 32 * kRowsPerLane;  // rows a warp takes per step
constexpr int kClusterThreads = 1024;
constexpr int kHotThreads = 512;
constexpr int kSlotsLog2 = 12;
constexpr int kSlots = 1 << kSlotsLog2;
constexpr int kProbes = 2;

struct View {
  double xmin, ymin, xmax, ymax, sx, sy;
  int width, height;
};

// Flat cell id of a row, or -1 when the row contributes nothing.
__device__ __forceinline__ int cell_of(float xf, float yf, bool keep,
                                       const View& v) {
  const double xd = (double)xf;
  const double yd = (double)yf;
  if (!(keep && xd >= v.xmin && xd <= v.xmax && yd >= v.ymin && yd <= v.ymax)) {
    return -1;
  }
  // floor and convert in one rounding conversion, then clip as integers
  // (equal to clip(floor(.)) for every value a row inside can produce)
  const int px = min(max(__double2int_rd(__dmul_rn(__dsub_rn(xd, v.xmin), v.sx)), 0),
                     v.width - 1);
  const int py = min(max(__double2int_rd(__dmul_rn(__dsub_rn(yd, v.ymin), v.sy)), 0),
                     v.height - 1);
  return py * v.width + px;
}

// The cells (and, weighted, the float64 weights; 0 where the cell is -1) of
// a lane's rows base + 32k + lane, k < kRowsPerLane. All loads are issued
// before any pixel math, unpredicated: a lane past the last row reads the
// last row again and drops it.
template <bool kWeighted>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const uint8_t* __restrict__ m,
                                          const float* __restrict__ w,
                                          long long n, long long base, int lane,
                                          const View& v, int (&c)[kRowsPerLane],
                                          double (&wv)[kRowsPerLane]) {
  float xs[kRowsPerLane], ys[kRowsPerLane], ws[kRowsPerLane];
  uint8_t ms[kRowsPerLane];
#pragma unroll
  for (int k = 0; k < kRowsPerLane; ++k) {
    const long long i = base + 32 * k + lane;
    const long long j = i < n ? i : n - 1;
    xs[k] = __ldg(x + j);
    ys[k] = __ldg(y + j);
    ms[k] = m == nullptr ? (uint8_t)1 : __ldg(m + j);
    if (kWeighted) ws[k] = __ldg(w + j);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerLane; ++k) {
    const bool keep = base + 32 * k + lane < n && ms[k] != 0;
    c[k] = cell_of(xs[k], ys[k], keep, v);
    // a select, not a product: a non-finite weight of a row that does not
    // count must not reach any sum
    wv[k] = (kWeighted && c[k] >= 0) ? (double)ws[k] : 0.0;
  }
}

// Runs: the lanes of a warp whose rows hit the same cell as the lane
// before them join its run, and the first lane of each run adds for all of
// it. Returns true for that first lane and sets `end` to one past the
// run's last lane. Rows sorted by cell (a store that orders rows by key)
// come in long runs; rows in random order mostly in runs of one, which
// cost a shuffle and a ballot per row slot (__match_any_sync, which would
// merge duplicates anywhere in the warp, costs more than the adds it
// saves on this card).
__device__ __forceinline__ bool run_head(int c, int lane, int& end) {
  const int prev = __shfl_up_sync(kFull, c, 1);
  const bool head = lane == 0 || c != prev;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads past this lane
  end = later != 0 ? __ffs(later) - 1 : 32;
  return head;
}

// The weight sum of lanes [lane, end) in lane order, for a run's head
// (other lanes get an unused value). `row` is this warp's 32-double scratch
// row in shared memory.
__device__ __forceinline__ double run_sum(double wv, bool head, int lane, int end,
                                          double* row) {
  row[lane] = wv;
  __syncwarp();
  double s = 0.0;
  if (head) {
    for (int j = lane; j < end; ++j) s += row[j];
  }
  __syncwarp();
  return s;
}

// The slot of cell c in a table of 2^kSlotsLog2 keys (-1 = empty): the
// slot that holds c, or an empty one claimed for it, within kProbes linear
// probes; -1 when every probed slot holds another cell.
__device__ __forceinline__ int claim_slot(int* keys, int c) {
  unsigned h = ((unsigned)c * 2654435761u) >> (32 - kSlotsLog2);
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    int key = *(volatile int*)(keys + h);
    if (key == -1) {
      const int old = atomicCAS(keys + h, -1, c);
      key = old == -1 ? c : old;
    }
    if (key == c) return (int)h;
    h = (h + 1) & (unsigned)(kSlots - 1);
  }
  return -1;
}

// Add v to the int32 at `local` (this CTA's shared memory) in the shared
// memory of CTA `rank` of the cluster: an explicit shared::cluster
// reduction, where a pointer from map_shared_rank would compile to a
// generic atomic.
__device__ __forceinline__ void red_remote(int* local, int rank, int v) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;"
               :: "r"(remote), "r"(v) : "memory");
}

// Cluster engine (counts): the grid in the cluster's shared memory. Cell c
// belongs to CTA rank c >> shift at offset c - (rank << shift); with one
// CTA, shift is 31 and the slice is the whole grid. With more than one, a
// table of kSlots neighbour-owned cells ([keys][counts], after the slice)
// takes a CTA's adds to hot cells of its neighbours, which it sends on once
// at the end; only table misses cross to a neighbour row by row.
__global__ void __launch_bounds__(kClusterThreads, 1)
density_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const uint8_t* __restrict__ m, long long n, View v,
                       int shift, int slice, int* __restrict__ out) {
  extern __shared__ int h[];
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const bool shared_grid = cluster.num_blocks() > 1;
  int* keys = h + slice;
  int* counts = keys + kSlots;
  for (int c = threadIdx.x; c < slice; c += blockDim.x) h[c] = 0;
  if (shared_grid) {
    for (int c = threadIdx.x; c < kSlots; c += blockDim.x) {
      keys[c] = -1;
      counts[c] = 0;
    }
  }
  cluster.sync();  // every slice is zero before any CTA adds to it

  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // base is the same for every lane of a warp, so all 32 lanes run each
  // iteration together (the *_sync intrinsics need the full warp)
  for (long long base = warp * kWarpRows; base < n; base += warps * kWarpRows) {
    int c[kRowsPerLane];
    double unused[kRowsPerLane];
    load_rows<false>(x, y, m, nullptr, n, base, lane, v, c, unused);
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      int end;
      if (run_head(c[k], lane, end) && c[k] >= 0) {
        const int r = c[k] >> shift;
        int* slot = h + (c[k] - (r << shift));
        if (r == me) {
          atomicAdd(slot, end - lane);
        } else {
          const int t = claim_slot(keys, c[k]);
          if (t >= 0) {
            atomicAdd(counts + t, end - lane);
          } else {
            red_remote(slot, r, end - lane);
          }
        }
      }
    }
  }
  if (shared_grid) {
    __syncthreads();  // every add to this CTA's table has landed
    for (int t = threadIdx.x; t < kSlots; t += blockDim.x) {
      const int c = keys[t];
      if (c >= 0 && counts[t] != 0) {
        const int r = c >> shift;
        red_remote(h + (c - (r << shift)), r, counts[t]);
      }
    }
  }
  cluster.sync();  // every add to this CTA's slice has landed

  int* dst = out + ((long long)me << shift);
  for (int c = threadIdx.x; c < slice; c += blockDim.x) {
    const int cnt = h[c];
    if (cnt != 0) atomicAdd(dst + c, cnt);
  }
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

// Hot-cell engine.
template <bool kWeighted>
__global__ void __launch_bounds__(kHotThreads)
density_hot_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const uint8_t* __restrict__ m, const float* __restrict__ w,
                   long long n, View v, typename Acc<kWeighted>::T* __restrict__ out) {
  using T = typename Acc<kWeighted>::T;
  extern __shared__ __align__(8) unsigned char smem[];
  // [kSlots values][kSlots keys][kHotThreads doubles of run-sum scratch]
  T* vals = reinterpret_cast<T*>(smem);
  int* keys = reinterpret_cast<int*>(smem + kSlots * sizeof(T));
  double* scratch = reinterpret_cast<double*>(smem + kSlots * (sizeof(T) + sizeof(int)));
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    keys[s] = -1;
    vals[s] = T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  double* row = scratch + (threadIdx.x & ~31);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * kWarpRows; base < n; base += warps * kWarpRows) {
    int c[kRowsPerLane];
    double wv[kRowsPerLane];
    load_rows<kWeighted>(x, y, m, w, n, base, lane, v, c, wv);
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      int end;
      const bool head = run_head(c[k], lane, end);
      T a;
      if (kWeighted) {
        a = (T)run_sum(wv[k], head, lane, end, row);
      } else {
        a = (T)(end - lane);
      }
      if (head && c[k] >= 0) {
        // into this block's slot for the cell, else straight into the grid
        // (two calls: one pointer for both would make a generic atomic)
        const int slot = claim_slot(keys, c[k]);
        if (slot >= 0) {
          atomicAdd(vals + slot, a);
        } else {
          atomicAdd(out + c[k], a);
        }
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    const int key = keys[s];
    if (key >= 0 && vals[s] != T(0)) atomicAdd(out + key, vals[s]);
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

// Blocks of `threads` that cover n rows at kWarpRows rows per warp.
long long blocks_for(long long n, int threads) {
  const long long rows = (long long)threads / 32 * kWarpRows;
  return (n + rows - 1) / rows;
}

int launch_cluster(const float* x, const float* y, const uint8_t* m,
                   long long n, const View& v, int csize, int* out,
                   cudaStream_t stream) {
  const long long cells = (long long)v.width * v.height;
  int shift = 31;
  long long slice = cells;
  if (csize > 1) {
    int lg = 0;
    while ((1LL << lg) < cells) ++lg;
    int lc = 0;
    while ((1 << lc) < csize) ++lc;
    shift = lg > lc ? lg - lc : 0;
    slice = 1LL << shift;
  }
  const size_t smem = ((size_t)slice + (csize > 1 ? 2 * kSlots : 0)) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      density_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kClusterThreads);
  cfg.gridDim = dim3(csize * sm_count());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, density_cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  long long need = blocks_for(n, kClusterThreads);
  need = (need + csize - 1) / csize;  // clusters that cover the rows
  if (need < clusters) clusters = (int)need;
  cfg.gridDim = dim3(clusters * csize);
  e = cudaLaunchKernelEx(&cfg, density_cluster_kernel, x, y, m, n, v, shift,
                         (int)slice, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kWeighted>
int launch_hot(const float* x, const float* y, const uint8_t* m, const float* w,
               long long n, const View& v, void* out, cudaStream_t stream) {
  using T = typename Acc<kWeighted>::T;
  auto kern = density_hot_kernel<kWeighted>;
  const size_t smem = kSlots * (sizeof(T) + sizeof(int)) + kHotThreads * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kHotThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = blocks_for(n, kHotThreads);
  const long long cap = (long long)sm_count() * per_sm;  // grid-stride beyond
  const long long blocks = need < cap ? need : cap;
  kern<<<(int)blocks, kHotThreads, smem, stream>>>(x, y, m, w, n, v,
                                                  static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). `x`, `y` (and `w` when
// weighted) are float32 device arrays of n rows, `mask` one byte per row
// (0 = skip) or null for every row. `out` is the ZEROED accumulator of
// width * height cells: int32 when `w` is null, float64 otherwise.
// `engine`: 1 the cluster engine with `cluster` CTAs (1, 2, 4 or 8; counts
// only, at most 2^15 * cluster cells, or 227 KB of them on one CTA), 2 the
// hot-cell engine. The wrapper chooses.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take; n == 0
// launches nothing and leaves `out` as it is.
extern "C" int gm_density(const float* x, const float* y, const uint8_t* mask,
                          const float* w, long long n, double xmin,
                          double ymin, double xmax, double ymax, double sx,
                          double sy, int width, int height, int engine,
                          int cluster, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long cells = (long long)width * height;
  if (width <= 0 || height <= 0 || cells > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  if (engine == 1 && (w != nullptr || (cluster != 1 && cluster != 2 &&
                                       cluster != 4 && cluster != 8) ||
                      (cluster == 1 && cells * 4 > 227 * 1024) ||
                      (cluster > 1 && cells > 32768LL * cluster))) {
    return (int)cudaErrorInvalidValue;
  }
  if (engine != 1 && engine != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const View v = {xmin, ymin, xmax, ymax, sx, sy, width, height};
  if (engine == 1) {
    return launch_cluster(x, y, mask, n, v, cluster, static_cast<int*>(out), stream);
  }
  if (w != nullptr) return launch_hot<true>(x, y, mask, w, n, v, out, stream);
  return launch_hot<false>(x, y, mask, w, n, v, out, stream);
}
