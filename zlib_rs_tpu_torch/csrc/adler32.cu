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
// Design: the 256 threads of a block stride over the row, neighbouring
// threads on neighbouring bytes (coalesced). With absolute weights
// (len - i) every byte's contribution to b is independent of the thread
// that reads it, so each thread keeps two 64-bit partial sums (no
// overflow: a term is < 2^24) and the block reduces them mod 65521. No
// state crosses blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 65521;
constexpr int kThreads = 256;

__global__ void adler32_rows(const uint8_t* __restrict__ data,
                             long long row_stride, int n,
                             const int32_t* __restrict__ lens,
                             int32_t* __restrict__ out) {
  const int row = blockIdx.x;
  const uint8_t* p = data + row * row_stride;
  int len = lens[row];
  if (len < 0) len = 0;
  if (len > n) len = n;

  unsigned long long s = 0, w = 0;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const unsigned long long d = p[i];
    s += d;
    w += (unsigned long long)(len - i) * d;
  }
  s %= kBase;
  w %= kBase;

  __shared__ unsigned long long sh_s[kThreads];
  __shared__ unsigned long long sh_w[kThreads];
  sh_s[threadIdx.x] = s;
  sh_w[threadIdx.x] = w;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) {
      sh_s[threadIdx.x] += sh_s[threadIdx.x + k];
      sh_w[threadIdx.x] += sh_w[threadIdx.x + k];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const uint32_t a = (uint32_t)((1 + sh_s[0]) % kBase);
    const uint32_t b = (uint32_t)(((unsigned long long)len % kBase + sh_w[0]) % kBase);
    out[row] = (int32_t)((b << 16) | a);
  }
}

}  // namespace

extern "C" int zrs_adler32_batch(const void* data, long long row_stride,
                                 int batch, int n, const void* lens,
                                 void* out, void* stream) {
  if (batch > 0) {
    adler32_rows<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, n, (const int32_t*)lens,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
