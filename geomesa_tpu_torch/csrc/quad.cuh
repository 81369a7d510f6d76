// What the dim scan (dimscan.cu) and the interleaved scan (zscan.cu) share:
// the block size and grid of a pass over rows in quads of 4, the 16-byte
// load of a quad's words of one plane, the store of one query's 4 bits into
// its row of the (Q, n) byte matrix of a batched mask, and the Q-batched
// kernels' handling of a row's 64-bit hit word (bit q: query q's hit): the
// bit-plane counters of the count and the byte-permute transpose of the
// mask into that matrix. Included inside each source's anonymous namespace; a source
// that includes it rebuilds when it changes (kernels/_build.py hashes the
// headers with the source).

constexpr int kThreads = 256;

// The words of the 4 rows starting at `row` (a multiple of 4), read
// through the read-only cache; neighbouring threads read neighbouring
// 16 bytes.
__device__ __forceinline__ uint4 load4(const uint32_t* p, long long row) {
  return __ldg(reinterpret_cast<const uint4*>(p + row));
}

// Blocks for a grid-stride pass over ceil(n / 4) quads, one per thread:
// at most 8 blocks per SM, at least one.
inline int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // grid-stride beyond 8 blocks per SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

// Query q's 4 bits of a quad into row q of the (Q, n) byte matrix: one
// 32-bit store when the row's start keeps it aligned (n % 4 == 0), else
// byte by byte.
__device__ __forceinline__ void store_bits(uint8_t* out, long long n, int q,
                                           long long row, uint32_t bits) {
  uint8_t* p = out + (long long)q * n + row;
  if (row + 4 <= n && (n & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = (bits & 1u) | ((bits >> 1 & 1u) << 8) |
                                      ((bits >> 2 & 1u) << 16) | ((bits >> 3 & 1u) << 24);
  } else {
    for (int r = 0; r < 4 && row + r < n; ++r) p[r] = (bits >> r) & 1u;
  }
}

// -- the Q-batched kernels' hit words ------------------------------------------

constexpr int kMaxBatch = 64;  // queries of one batched launch: a 64-bit hit word
constexpr int kWarps = kThreads / 32;

// Vertical counters: bit q of plane i is bit i of query q's count; adding a
// row's hit word ripples a carry through the planes.
constexpr int kPlanes = 10;
constexpr int kFlushQuads = (1 << kPlanes) / 4 - 1;  // a thread's quads between flushes

__device__ __forceinline__ void count_hits(unsigned long long (&p)[kPlanes],
                                           unsigned long long v) {
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    if (!v) break;
    const unsigned long long carry = p[i] & v;
    p[i] ^= v;
    v = carry;
  }
}

// The warp's counts into its counters in shared memory; the planes restart.
__device__ __forceinline__ void flush_counts(unsigned long long (&p)[kPlanes], int nq,
                                             int* wcount, int lane) {
  unsigned long long any = 0;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) any |= p[i];
  if (__any_sync(0xffffffffu, any != 0)) {
    for (int q = 0; q < nq; ++q) {
      int v = 0;
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) v |= (int)((p[i] >> q) & 1ull) << i;
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) wcount[q] += v;
    }
  }
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) p[i] = 0;
}

// Query group k's (queries 8k..8k+7) bits of a quad's 4 hit words as one
// word: bit j of byte r is query 8k + j's hit of row r. Bytes 8k..8k+7 of
// the 4 words transpose by byte permutes.
__device__ __forceinline__ uint32_t quad_group(const unsigned long long (&hits)[4], int k) {
  const int sh = k < 4 ? 0 : 32;
  const uint32_t sel = (uint32_t)(k & 3) | ((uint32_t)(4 + (k & 3)) << 4);
  return __byte_perm(__byte_perm((uint32_t)(hits[0] >> sh), (uint32_t)(hits[1] >> sh), sel),
                     __byte_perm((uint32_t)(hits[2] >> sh), (uint32_t)(hits[3] >> sh), sel),
                     0x5410);
}

// The quad's bytes of every query: byte r of query q's word is bit q of
// hits[r], one 32-bit store a query when the rows' start keeps it aligned.
__device__ __forceinline__ void store_quad(uint8_t* out, long long n, int nq, long long row,
                                           const unsigned long long (&hits)[4]) {
  const bool aligned = row + 4 <= n && (n & 3) == 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (8 * k >= nq) break;
    uint32_t g = quad_group(hits, k);
    const int jn = min(8, nq - 8 * k);
    uint8_t* p = out + (long long)(8 * k) * n + row;
    for (int j = 0; j < jn; ++j, g >>= 1, p += n) {
      if (aligned) {
        *reinterpret_cast<uint32_t*>(p) = g & 0x01010101u;
      } else {
        for (int r = 0; r < 4 && row + r < n; ++r) p[r] = (g >> (8 * r)) & 1u;
      }
    }
  }
}

// Two quads' bytes of every query (rows `row` to row + 7: lo's rows, then
// hi's): one 64-bit store a query where n % 8 == 0, two 32-bit stores where
// n % 4 == 0, else byte by byte; nothing at or past n.
__device__ __forceinline__ void store_oct(uint8_t* out, long long n, int nq, long long row,
                                          const unsigned long long (&lo)[4],
                                          const unsigned long long (&hi)[4]) {
  if (row >= n) return;
  const bool full = row + 8 <= n;
  const int align = !full ? 1 : ((n & 7) == 0 ? 8 : ((n & 3) == 0 ? 4 : 1));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (8 * k >= nq) break;
    uint32_t g0 = quad_group(lo, k), g1 = quad_group(hi, k);
    const int jn = min(8, nq - 8 * k);
    uint8_t* p = out + (long long)(8 * k) * n + row;
    for (int j = 0; j < jn; ++j, g0 >>= 1, g1 >>= 1, p += n) {
      if (align == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(g0 & 0x01010101u, g1 & 0x01010101u);
      } else if (align == 4) {
        reinterpret_cast<uint32_t*>(p)[0] = g0 & 0x01010101u;
        reinterpret_cast<uint32_t*>(p)[1] = g1 & 0x01010101u;
      } else {
        for (int r = 0; r < 8 && row + r < n; ++r)
          p[r] = ((r < 4 ? g0 : g1) >> (8 * (r & 3))) & 1u;
      }
    }
  }
}
