// K2: the hop-table pointer chase, one chunk per block.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_hop_pallas
// (body _make_kernel_hop). With the lazy decision chain precomputed in
// htab (ops/lzvec.build_hop_tables), the parse is one iteration per
// emitted match: read the slot at the current position (a literal slot
// holds the delta to the next match stop), land on the match entry,
// recover the byte-exact length from the word-granular table length,
// emit (mpos, mld = (len-3) << 15 | (dist-1)), jump past the match. The
// literals crossed on the way are counted word-wise into a 4-bank,
// 320-bin histogram (bank k takes byte k of each 4-byte read; a byte past
// the span end lands in the dead bin 319 of its bank).
//
// Bound on the H100: the chase is a chain of dependent loads, one chain
// per chunk, so it is latency-bound; the byte floor (words + htab slice
// read once, the match stream written once) is far below it.
//
// Design: one thread per chunk runs the chase (grid of B blocks of one
// warp); the block's other threads only zero and write back the
// histogram, kept in shared memory. words and htab are read through L1.
// C has no harmless out-of-range read: every read is bounded as the
// reference bounds it (landing slot clamped to n_valid - 1; a jump that
// runs off the end stops before any speculative read), a match source
// before the row clamps to byte 0 as the plain version's does, and an unaligned
// word read branches before the `>> 32` that C leaves undefined.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kCapM = 12288;
constexpr int kBins = 320;
constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t get32(const uint32_t* __restrict__ w, int p) {
  const int wi = p >> 2;
  const int sh = (p & 3) << 3;
  const uint32_t w0 = __ldg(w + wi);
  if (sh == 0) return w0;
  return (w0 >> sh) | (__ldg(w + wi + 1) << (32 - sh));
}

__device__ __forceinline__ int tail_bytes(uint32_t x) {
  const int t0 = (x & 0xFFu) == 0;
  const int t1 = t0 & ((x & 0xFFFFu) == 0);
  const int t2 = t1 & ((x & 0xFFFFFFu) == 0);
  return t0 + t1 + t2;
}

__device__ __forceinline__ void count_span(const uint32_t* __restrict__ w,
                                           int* hist, int frm, int to) {
  for (int p = frm; p < to; p += 4) {
    const uint32_t x = get32(w, p);
    const int rem = to - p;
    hist[x & 0xFFu] += 1;
    hist[kBins + (rem >= 2 ? (int)((x >> 8) & 0xFFu) : kBins - 1)] += 1;
    hist[2 * kBins + (rem >= 3 ? (int)((x >> 16) & 0xFFu) : kBins - 1)] += 1;
    hist[3 * kBins + (rem >= 4 ? (int)(x >> 24) : kBins - 1)] += 1;
  }
}

// word-wise extension of a cap-hitting table length (the sub-word tail
// follows at the call); a source before the row clamps to byte 0
__device__ int extend(const uint32_t* __restrict__ w, int i, int blen,
                      int dist, int cap) {
  int k = blen;
  while (k < cap && get32(w, i + k) == get32(w, max(i - dist + k, 0))) k += 4;
  return min(k, cap);
}

__global__ void hop_chase(const uint32_t* __restrict__ words, int W,
                          const int32_t* __restrict__ htab, long long htab_stride,
                          const int32_t* __restrict__ n_valid_arr, int start,
                          int cap_g, int32_t* __restrict__ mpos,
                          int32_t* __restrict__ mld, int C,
                          int32_t* __restrict__ st, int32_t* __restrict__ freq) {
  __shared__ int hist[4 * kBins];
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < 4 * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    const uint32_t* w = words + (long long)row * W;
    // htab slot of position p is ht[p]; the parse only reads p >= start
    const int32_t* ht = htab + (long long)row * htab_stride;
    int32_t* mp = mpos + (long long)row * C;
    int32_t* md = mld + (long long)row * C;
    const int n_valid = n_valid_arr[row];
    int i0 = start, mc = 0;
    bool bad = false;
    while (i0 < n_valid && !bad) {
      int32_t e = ht[i0];
      const bool is_m = (e >> 30) > 0;
      int i = i0;
      if (!is_m) {
        // a run with no following stop jumps to >= n_valid: clamp
        i = min(i0 + e, n_valid);
        e = ht[min(i, n_valid - 1)];
      }
      if (i >= n_valid) {  // the tail [i0, n_valid) is all literals
        count_span(w, hist, i0, n_valid);
        break;
      }
      const int h = (e >> 23) & 0x7F;
      int mlen = (e >> 16) & 0x7F;
      const int dist = e & 0xFFFF;
      const int ip = i + h;
      // run literals [i0, i) and deferred literals [i, ip): one span
      count_span(w, hist, i0, ip);
      const int cap = min(n_valid - ip, kMaxMatch);
      if (mlen == cap_g) mlen = extend(w, ip, mlen, dist, cap);
      const uint32_t xt = get32(w, ip + mlen) ^ get32(w, max(ip - dist + mlen, 0));
      mlen = min(mlen + tail_bytes(xt), cap);
      const int slot = mc < kCapM ? mc : kCapM;
      mp[slot] = ip;
      md[slot] = (int32_t)(((uint32_t)(mlen - kMinMatch) << 15) | (uint32_t)(dist - 1));
      bad = mc >= kCapM;
      mc += 1;
      i0 = ip + mlen;
    }
    if (bad) {
      // the overflowing chunk degrades to an all-literal parse downstream:
      // recount (bank 0 only is cleared, as the reference does)
      for (int b = 0; b < kBins; ++b) hist[b] = 0;
      count_span(w, hist, start, n_valid);
    }
    int32_t* s = st + (long long)row * 8;
    s[0] = mc;
    s[1] = bad ? 1 : 0;
    for (int k = 2; k < 8; ++k) s[k] = 0;
  }
  __syncthreads();
  int32_t* f = freq + (long long)row * 4 * kBins;
  for (int i = threadIdx.x; i < 4 * kBins; i += kThreads) f[i] = hist[i];
}

}  // namespace

extern "C" int zrs_hop_chase(const void* words, int W, const void* htab,
                             long long htab_stride, const void* n_valid,
                             int start, int cap_g, void* mpos, void* mld,
                             int C, void* st, void* freq, int batch,
                             void* stream) {
  if (batch > 0) {
    hop_chase<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)htab, htab_stride,
        (const int32_t*)n_valid, start, cap_g, (int32_t*)mpos,
        (int32_t*)mld, C, (int32_t*)st, (int32_t*)freq);
  }
  return (int)cudaGetLastError();
}
