// K9: the 320-bin symbol histogram of a compact match stream, one chunk
// per block.
//
// Replaces the freq branch of
// zlib_rs_tpu/ops/pallas/deflate_kernel.py:freq_pack_chunks_pallas (body
// _freq_kernel), which the chain (K8) and tab (K10) routes run before the
// trees: literal bytes of every gap between matches at bins 0..255 (gap k
// is [end of match k - 1, mpos[k]), the first from `start`, the last to
// n_valid), 257 + the length code and 288 + the distance code of every
// match (the _len_sym/_dist_sym arithmetic); EOB is not counted. A chunk
// that arrives with nmatch = 0 (a bad chunk's all-literal parse) counts
// every byte of [start, n_valid).
//
// Bound on the H100: a reduction over the span's bytes and the match
// stream, both read once; it is bound by bytes, and by the atomics into
// the 320 shared bins.
//
// Design: a block of 256 threads per chunk keeps the histogram in shared
// memory. The matches are taken in tiles of 256, one a thread: its codes,
// and its gap when the gap is short. A gap longer than kLongGap is noted
// in shared memory and counted by the whole block after the tile, as is
// the gap after the last match, so a chunk of few matches (long literal
// runs) spreads over all threads. Reads of the match stream clamp the
// slot to [0, C-1] and word reads to [0, W-1], as the TPU's SMEM reads
// clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kBins = 320;
constexpr int kThreads = 256;
constexpr int kLongGap = 64;

struct Words {
  const uint32_t* __restrict__ w;
  int W;

  __device__ __forceinline__ int byte_at(int p) const {
    const uint32_t x = __ldg(w + min(max(p >> 2, 0), W - 1));
    return (int)((x >> ((p & 3) << 3)) & 0xFFu);
  }
};

__device__ __forceinline__ int bit_length(int x) { return x > 0 ? 32 - __clz(x) : 0; }

__device__ __forceinline__ int len_code(int mlen) {
  const int v = mlen - kMinMatch;
  if (v == 255) return 28;
  if (v < 8) return v;
  const int e = bit_length(v) - 3;
  return 4 + 4 * e + ((v >> e) & 3);
}

__device__ __forceinline__ int dist_code(int dist) {
  const int d = dist - 1;
  if (d < 4) return d;
  const int e = bit_length(d) - 2;
  return 2 * (e + 1) + ((d >> e) & 1);
}

__device__ __forceinline__ void count_gap(const Words& w, int* hist, int frm, int to, int t0,
                                          int step) {
  for (int p = frm + t0; p < to; p += step) atomicAdd(&hist[w.byte_at(p)], 1);
}

__global__ void __launch_bounds__(kThreads)
freq_kernel(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ mpos,
            const uint32_t* __restrict__ mld, int C, const int32_t* __restrict__ meta,
            int32_t* __restrict__ freq) {
  __shared__ int hist[kBins];
  __shared__ int gap_a[kThreads];
  __shared__ int gap_b[kThreads];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const Words w{words + (long long)row * W, W};
  const int32_t* mp = mpos + (long long)row * C;
  const uint32_t* md = mld + (long long)row * C;
  const int32_t* m = meta + (long long)row * 8;
  const int n_valid = m[0], start = m[1], nmatch = m[2];
  for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;

  auto slot = [&](int k) { return min(max(k, 0), C - 1); };
  auto match_end = [&](int k) {  // end of match k; `start` before the first
    if (k < 0) return start;
    const int s = slot(k);
    return mp[s] + (int)(__ldg(md + s) >> 15) + kMinMatch;
  };
  __syncthreads();

  for (int tile = 0; tile < nmatch; tile += kThreads) {
    const int k = tile + tid;
    int a = 0, b = 0;
    if (k < nmatch) {
      const int s = slot(k);
      const uint32_t x = __ldg(md + s);
      atomicAdd(&hist[min(257 + len_code((int)(x >> 15) + kMinMatch), kBins - 1)], 1);
      atomicAdd(&hist[288 + dist_code((int)(x & 0x7FFFu) + 1)], 1);
      a = match_end(k - 1);
      b = mp[s];
      if (b - a <= kLongGap) {
        count_gap(w, hist, a, b, 0, 1);
        a = b = 0;
      }
    }
    gap_a[tid] = a;
    gap_b[tid] = b;
    __syncthreads();
    for (int j = 0; j < kThreads; ++j) count_gap(w, hist, gap_a[j], gap_b[j], tid, kThreads);
    __syncthreads();
  }
  count_gap(w, hist, match_end(nmatch - 1), n_valid, tid, kThreads);
  __syncthreads();
  int32_t* f = freq + (long long)row * kBins;
  for (int b = tid; b < kBins; b += kThreads) f[b] = hist[b];
}

}  // namespace

extern "C" int zrs_freq(const void* words, int W, const void* mpos, const void* mld, int C,
                        const void* meta, void* freq, int batch, void* stream) {
  if (batch > 0) {
    freq_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)mpos, (const uint32_t*)mld, C,
        (const int32_t*)meta, (int32_t*)freq);
  }
  return (int)cudaGetLastError();
}
