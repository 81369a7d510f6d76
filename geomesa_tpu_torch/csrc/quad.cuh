// What the dim scan (dimscan.cu) and the interleaved scan (zscan.cu) share:
// the block size and grid of a pass over rows in quads of 4, the 16-byte
// load of a quad's words of one plane, and the batched masks' store of a
// query's 4 bits into its row of the (Q, n) byte matrix. Included inside
// each source's anonymous namespace; a source that includes it rebuilds
// when it changes (kernels/_build.py hashes the headers with the source).

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
