// K1: batched adler32, one block per row.
//
// Replaces zlib_rs_tpu/ops/pallas/checksum_kernels.py:adler32_batch_pallas
// (body _adler_kernel/_adler_rows): adler32 of every zero-padded row over
// its true length, returned as (b << 16) | a.
//
// Bound on the H100: bytes. The work is one read of B * N bytes and a few
// integer ops per byte, far below the card's integer rate, so the floor is
// the row bytes over 3.35 TB/s.
//
// Design: 1024 threads a row (the encode's 128-row batch puts 32 warps on
// an SM), each owning kSeg contiguous bytes of every pass of 32 KiB, taken
// from the row's start rounded down to 16 bytes. A thread issues the
// 16-byte loads of its segment at once (aligned; bytes outside the row
// zeroed, so any start, length and stride take the same path) and keeps
// two 32-bit partials of its segment [lo, hi): s = sum d_i and
// w = sum (hi - i) d_i, each word of 4 bytes by two __dp4a with constant
// weights (the weights of a byte are its distance to hi, at most kSeg, so
// they fit a byte and no partial can overflow: w <= 255 * kSeg (kSeg + 1)
// / 2). With absolute weights b = len + sum over segments (w + s (len -
// hi)), so a segment's share of b does not depend on any other; a thread
// folds its passes in 64 bits, the block sums by warp shuffles and one
// shared-memory step, and thread 0 reduces mod 65521. No state crosses
// blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 65521;
constexpr int kThreads = 1024;
constexpr int kSeg = 32;  // bytes a thread a pass: 2 loads of 16 bytes
constexpr int kVecs = kSeg / 16;
constexpr long long kPass = (long long)kThreads * kSeg;
constexpr int kWarps = kThreads / 32;

// the bytes [lo, hi) of a little-endian word, each clipped to [0, 4)
__device__ __forceinline__ uint32_t byte_mask(long long lo, long long hi) {
  const int l = lo < 0 ? 0 : (lo > 4 ? 4 : (int)lo);
  const int h = hi < 0 ? 0 : (hi > 4 ? 4 : (int)hi);
  if (h <= l) return 0u;
  const uint32_t upto = h == 4 ? 0xFFFFFFFFu : (1u << (8 * h)) - 1u;
  return upto & ~((1u << (8 * l)) - 1u);
}

// weights of word m of a segment, bytes 4m..4m+3: kSeg - 4m - j, packed
__host__ __device__ constexpr uint32_t weights(int m) {
  return (uint32_t)(kSeg - 4 * m) | (uint32_t)(kSeg - 4 * m - 1) << 8 |
         (uint32_t)(kSeg - 4 * m - 2) << 16 | (uint32_t)(kSeg - 4 * m - 3) << 24;
}
static_assert(kSeg <= 255, "a weight must fit a byte of __dp4a");

__global__ void __launch_bounds__(kThreads)
adler32_rows(const uint8_t* __restrict__ data, long long row_stride, int n,
             const int32_t* __restrict__ lens, int32_t* __restrict__ out) {
  __shared__ uint32_t part_s[kWarps], part_b[kWarps];
  const int t = threadIdx.x, row = blockIdx.x;
  int len = lens[row];
  if (len < 0) len = 0;
  if (len > n) len = n;
  const long long p = (long long)(data + row * row_stride), e = p + len;
  const long long p_al = p & ~15LL, e_up = (e + 15) & ~15LL;
  const int passes = len ? (int)((e_up - p_al + kPass - 1) / kPass) : 0;

  unsigned long long s_sum = 0, b_sum = 0;
  for (int q = 0; q < passes; ++q) {
    const long long lo = p_al + q * kPass + (long long)t * kSeg;
    uint4 v[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {  // every vector that holds a row byte
      const long long a = lo + 16 * i;
      v[i] = a < e_up ? __ldg(reinterpret_cast<const uint4*>(a)) : make_uint4(0, 0, 0, 0);
    }
    uint32_t s = 0, w = 0;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const long long a = lo + 16 * i;
      uint32_t x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      if (a < p || a + 16 > e) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] &= byte_mask(p - a - 4 * j, e - a - 4 * j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s = __dp4a(x[j], 0x01010101u, s);
        w = __dp4a(x[j], weights(4 * i + j), w);
      }
    }
    // (len - i) = (hi - i) + (e - hi); e - hi may be negative, the sum is not
    b_sum += (unsigned long long)((long long)w + (long long)s * (e - (lo + kSeg)));
    s_sum += s;
  }
  uint32_t s32 = (uint32_t)(s_sum % kBase), b32 = (uint32_t)(b_sum % kBase);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s32 += __shfl_xor_sync(0xFFFFFFFFu, s32, o);
    b32 += __shfl_xor_sync(0xFFFFFFFFu, b32, o);
  }
  if ((t & 31) == 0) {
    part_s[t >> 5] = s32;
    part_b[t >> 5] = b32;
  }
  __syncthreads();
  if (t < 32) {
    s32 = t < kWarps ? part_s[t] : 0u;
    b32 = t < kWarps ? part_b[t] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s32 += __shfl_xor_sync(0xFFFFFFFFu, s32, o);
      b32 += __shfl_xor_sync(0xFFFFFFFFu, b32, o);
    }
    if (t == 0) {
      const uint32_t a = (1u + s32 % kBase) % kBase;
      const uint32_t b = ((uint32_t)len % kBase + b32 % kBase) % kBase;
      out[row] = (int32_t)((b << 16) | a);
    }
  }
}

}  // namespace

extern "C" int zrs_adler32_batch(const void* data, long long row_stride, int batch, int n,
                                 const void* lens, void* out, void* stream) {
  if (batch > 0) {
    adler32_rows<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, n, (const int32_t*)lens, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
