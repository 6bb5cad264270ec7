// K7: batched crc32, one block per row.
//
// Replaces zlib_rs_tpu/ops/pallas/crc_kernels.py:crc32_batch_pallas (body
// _crc_kernel): the crc32 of every row, equal to zlib.crc32. The TPU kernel
// folds bit-planes through a chain of GF(2) matrices on the matrix unit;
// that shape fits the MXU and is not carried over.
//
// Bound on the H100: bytes. Every row byte is read once; a table lookup,
// a shift and two xors per byte are far below the card's integer rate, so
// the floor is the row bytes over 3.35 TB/s.
//
// Design: the 256 threads of a block split the row into contiguous
// segments; each runs the table-driven crc32 over its segment, with the
// byte table in shared memory. The segment crcs are then joined by a
// log-depth tree of zlib's crc32_combine: crc(A + B) = crc(A) * x^(8|B|)
// ^ crc(B), the product taken carry-less mod P in 32-bit operations, and
// x^(8|B|) mod P built from the 32 powers x^(2^k) mod P that the block
// computes first. Any row length and any length up to it per row; rows
// may have any stride. No state crosses blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // reflected IEEE 802.3
constexpr int kThreads = 256;

// a * b mod P, both reflected (bit 31 is x^0): zlib's multmodp
__device__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// x^(8 * n) mod P from x2n[k] = x^(2^k) mod P
__device__ uint32_t x8nmodp(const uint32_t* x2n, long long n) {
  uint32_t p = 1u << 31;  // x^0
  int k = 3;
  while (n) {
    if (n & 1) p = multmodp(x2n[k & 31], p);
    n >>= 1;
    k++;
  }
  return p;
}

__global__ void crc32_rows(const uint8_t* __restrict__ data,
                           long long row_stride, int n,
                           const int32_t* __restrict__ lens,
                           int32_t* __restrict__ out) {
  __shared__ uint32_t table[256];
  __shared__ uint32_t x2n[32];
  __shared__ uint32_t crc[kThreads];
  __shared__ int seg_len[kThreads];

  const int t = threadIdx.x;
  {
    uint32_t c = (uint32_t)t;
    for (int j = 0; j < 8; j++) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    table[t] = c;
  }
  if (t == 0) {
    uint32_t p = 1u << 30;  // x^1
    x2n[0] = p;
    for (int k = 1; k < 32; k++) {
      p = multmodp(p, p);
      x2n[k] = p;
    }
  }
  __syncthreads();

  const int row = blockIdx.x;
  const uint8_t* src = data + row * row_stride;
  int len = lens[row];
  if (len < 0) len = 0;
  if (len > n) len = n;
  const int seg = (len + kThreads - 1) / kThreads;
  int lo = t * seg;
  int hi = lo + seg;
  if (lo > len) lo = len;
  if (hi > len) hi = len;

  uint32_t c = 0xFFFFFFFFu;
  for (int i = lo; i < hi; i++) {
    c = table[(c ^ __ldg(src + i)) & 0xFF] ^ (c >> 8);
  }
  crc[t] = (hi > lo) ? ~c : 0u;  // crc32 of an empty segment is 0
  seg_len[t] = hi - lo;
  __syncthreads();

  // segment t joins segment t + s: crc[t] = combine(crc[t], crc[t+s], len)
  for (int s = 1; s < kThreads; s <<= 1) {
    if ((t & (2 * s - 1)) == 0) {
      const int l2 = seg_len[t + s];
      if (l2) crc[t] = multmodp(x8nmodp(x2n, l2), crc[t]) ^ crc[t + s];
      seg_len[t] += l2;
    }
    __syncthreads();
  }
  if (t == 0) out[row] = (int32_t)crc[0];
}

}  // namespace

extern "C" int zrs_crc32_batch(const void* data, long long row_stride,
                               int batch, int n, const void* lens, void* out,
                               void* stream) {
  if (batch > 0) {
    crc32_rows<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, n, (const int32_t*)lens,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
