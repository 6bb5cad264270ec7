// K7: batched crc32, one block per row.
//
// Replaces zlib_rs_tpu/ops/pallas/crc_kernels.py:crc32_batch_pallas (body
// _crc_kernel): the crc32 of every row, equal to zlib.crc32. The TPU kernel
// folds bit-planes through a chain of GF(2) matrices on the matrix unit;
// that shape fits the MXU and is not carried over.
//
// Bound on the H100: bytes. Every row byte is read once at 3.35 TB/s. The
// practical floor is the shared-memory lookup rate: one 4-byte table
// lookup a byte, at most 32 lookups a cycle an SM, fewer where the lanes of
// a warp hit one bank.
//
// Design. The raw crc (zero register in, no final inversion) of a string
// does not change when zeros are put before it, so a row is read as if
// front-padded to whole passes of kThreads * kSeg bytes that end at the
// row's end rounded up to 16 bytes (e_up). Thread t owns the kSeg bytes
// of each pass that lie (kThreads - 1 - t) * kSeg bytes before the pass's
// end, so the shift that carries its raw crc to e_up is one constant a
// thread, shifts[t] = x^(8 (kThreads - 1 - t) kSeg) mod P, the same for
// every row; the wrapper builds the table on the host (crc_kernels.
// shift_table) and keeps it on the card. A thread
//   1. issues the 16-byte loads of its whole segment at once (addresses
//      aligned; bytes outside the row zeroed, so a misaligned start, end
//      or stride needs no other path), while the block builds the
//      slice-by-8 tables (8 x 256 words, 8 KiB) in shared memory, one
//      column a thread;
//   2. runs slice-by-8 over its segment, 8 bytes a step; across passes it
//      carries its register with one shift by shifts[0];
//   3. shifts its raw crc once, branch-free, by shifts[t]; the block XORs
//      the results, by warp shuffles and one shared-memory step.
// zlib's init 0xFFFFFFFF enters as the inversion of the row's first four
// bytes (for len >= 4 the two give the same register: the init term
// x^(8 len) * 0xFFFFFFFF mod P); the bytes zeroed past the row's end,
// k = e_up - end, are taken out by one shift by x^(-8k) mod P
// (shifts[kThreads + k]); then the final inversion. Rows under 4 bytes
// run bytewise on one thread. Any row length, any length per row, any row
// stride with contiguous rows; no state crosses blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // reflected IEEE 802.3
constexpr int kThreads = 512;            // a block a row
constexpr int kSeg = 64;                 // bytes a thread a pass: 4 loads of 16 bytes
constexpr int kVecs = kSeg / 16;
constexpr long long kPass = (long long)kThreads * kSeg;
constexpr int kWarps = kThreads / 32;

// a * b mod P, both reflected (bit 31 is x^0): zlib's multmodp, branch-free
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    p ^= b & (0u - (a >> 31));
    a <<= 1;
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// the bytes [lo, hi) of a little-endian word, each clipped to [0, 4)
__device__ __forceinline__ uint32_t byte_mask(long long lo, long long hi) {
  const int l = lo < 0 ? 0 : (lo > 4 ? 4 : (int)lo);
  const int h = hi < 0 ? 0 : (hi > 4 ? 4 : (int)hi);
  if (h <= l) return 0u;
  const uint32_t upto = h == 4 ? 0xFFFFFFFFu : (1u << (8 * h)) - 1u;
  return upto & ~((1u << (8 * l)) - 1u);
}

// a word at address `a`: bytes outside [p, e) zeroed, bytes in
// [p, p + 4) inverted (zlib's init)
__device__ __forceinline__ uint32_t edge_word(uint32_t w, long long a, long long p,
                                              long long e) {
  return (w & byte_mask(p - a, e - a)) ^ byte_mask(p - a, p + 4 - a);
}

__device__ __forceinline__ uint32_t step8(const uint32_t (*tab)[256], uint32_t c, uint32_t w0,
                                          uint32_t w1) {
  c ^= w0;
  return tab[7][c & 0xFF] ^ tab[6][(c >> 8) & 0xFF] ^ tab[5][(c >> 16) & 0xFF] ^
         tab[4][c >> 24] ^ tab[3][w1 & 0xFF] ^ tab[2][(w1 >> 8) & 0xFF] ^
         tab[1][(w1 >> 16) & 0xFF] ^ tab[0][w1 >> 24];
}

// the segment at address s (16-byte aligned): every vector that holds a
// byte of [p_al, e_up) loaded, the others zero
__device__ __forceinline__ void load_segment(uint4 (&v)[kVecs], long long s, long long p_al) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long a = s + 16 * i;
    v[i] = a >= p_al ? __ldg(reinterpret_cast<const uint4*>(a)) : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
crc32_rows(const uint8_t* __restrict__ data, long long row_stride, int n,
           const int32_t* __restrict__ lens, const uint32_t* __restrict__ shifts,
           int32_t* __restrict__ out) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t part[kWarps];

  const int t = threadIdx.x, row = blockIdx.x;
  const uint8_t* src = data + row * row_stride;
  int len = lens[row];
  if (len < 0) len = 0;
  if (len > n) len = n;
  if (len < 4) {  // too short for the init as four inverted bytes
    if (t == 0) {
      uint32_t c = 0xFFFFFFFFu;
      for (int i = 0; i < len; ++i) {
        c ^= src[i];
        for (int j = 0; j < 8; ++j) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
      }
      out[row] = (int32_t)~c;
    }
    return;
  }
  const long long p = (long long)src, e = p + len;
  const long long p_al = p & ~15LL, e_up = (e + 15) & ~15LL;
  int q = (int)((e_up - p_al + kPass - 1) / kPass) - 1;  // passes from the front
  const uint32_t shift = shifts[t];
  const uint32_t carry = shifts[0];

  uint4 v[kVecs];
  long long s = e_up - (q + 1) * kPass + (long long)t * kSeg;
  load_segment(v, s, p_al);

  // column b of the 8 tables: byte b, then 0-7 zero bytes, into a zero register
  for (int b = t; b < 256; b += kThreads) {
    uint32_t c = (uint32_t)b;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
      tab[k][b] = c;
    }
  }
  __syncthreads();

  uint32_t c = 0;
  for (;;) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const long long a = s + 16 * i;
      uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      if (a < p + 4 || a + 16 > e) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = edge_word(w[j], a + 4 * j, p, e);
      }
      c = step8(tab, c, w[0], w[1]);
      c = step8(tab, c, w[2], w[3]);
    }
    if (--q < 0) break;
    s += kPass;
    load_segment(v, s, p_al);
    if (c) c = multmodp(carry, c);  // across the other threads' kThreads - 1 segments
  }

  c = multmodp(shift, c);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c ^= __shfl_xor_sync(0xFFFFFFFFu, c, o);
  if ((t & 31) == 0) part[t >> 5] = c;
  __syncthreads();
  if (t == 0) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) x ^= part[i];
    const int k = (int)(e_up - e);
    if (k) x = multmodp(shifts[kThreads + k], x);
    out[row] = (int32_t)~x;
  }
}

}  // namespace

extern "C" int zrs_crc32_batch(const void* data, long long row_stride, int batch, int n,
                               const void* lens, const void* shifts, void* out, void* stream) {
  if (batch > 0) {
    crc32_rows<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, n, (const int32_t*)lens, (const uint32_t*)shifts,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
