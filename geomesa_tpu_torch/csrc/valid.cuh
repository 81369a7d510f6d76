// The validity operand of the count and mask kernels (dimscan.cu, zscan.cu,
// filter_scan.cu): one byte a row, 0 for a dead row (evicted, or past a
// streaming index's live rows), 1 for a live one; a null plane means every
// row is live, and the kernels then take a compiled path that reads nothing.
// Included inside each source's anonymous namespace; kernels/_build.py
// hashes the headers with every source.

// Bits 0..3 of the validity bytes of the 4 rows starting at `row` (a
// multiple of 4; the plane 4-byte aligned): bit r set when row + r < n and
// the row is live. One 32-bit load for a whole quad.
__device__ __forceinline__ uint32_t valid_bits(const uint8_t* valid, long long row,
                                               long long n) {
  if (row + 4 <= n) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(valid + row));
    return (w & 1u) | (w >> 7 & 2u) | (w >> 14 & 4u) | (w >> 21 & 8u);
  }
  uint32_t b = 0;
  for (int r = 0; r < 3; ++r) {
    if (row + r < n && valid[row + r]) b |= 1u << r;
  }
  return b;
}
