// K10: the one-step-lazy parse over precomputed match tables, one chunk
// per block.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_tab_pallas
// (body _make_kernel_tab). ops/lzvec.build_match_tables gives, for every
// position, zlib's longest_match summary as (len << 16 | dist) for the full
// chain budget (tabf) and the quartered one (tabq), len capped at 4 * w_g
// and word-granular past its first words. The walk is deflate_slow's
// decision loop with the chain walk replaced by one table read:
//   * with no pending match, a run of zero tabf entries is literals (the
//     literal sprint);
//   * tabq once the pending match is at least `good`, else tabf;
//   * the walk's nice = min(nice, n_valid - i, 258) and TOO_FAR (a length-3
//     match more than 4096 back) as in K8; a pending match at least
//     max_lazy long skips the search;
//   * every emitted match is extended byte-exactly from its table length,
//     word-wise and then by the byte tail, capped at min(n_valid - pos, 258).
// Output as K8: mpos, mld = (len - 3) << 15 | (dist - 1), st = (nmatch,
// bad, 0...); a write past CAP_M lands in slot CAP_M and sets bad.
//
// Bound on the H100: one dependent chain of table and word reads per
// chunk, so it is latency-bound; the byte floor (both tables over the
// span, the chunk, the match stream out) is far below it.
//
// Design: one thread of a one-warp block per chunk (the chunks' parses
// share nothing, and one block per SM keeps each chain's loads in its own
// L1); tables and words are read from device memory through L1. Every
// word index is clamped to [0, W-1] and every table index to [0, tabn-1],
// as the TPU's SMEM reads clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kTooFar = 4096;
constexpr int kCapM = 12288;
constexpr int kThreads = 32;

struct Words {
  const uint32_t* __restrict__ w;
  int W;

  __device__ __forceinline__ uint32_t at(int wi) const {
    return __ldg(w + min(max(wi, 0), W - 1));
  }
  __device__ __forceinline__ uint32_t get32(int p) const {
    const int sh = (p & 3) << 3;
    const uint32_t w0 = at(p >> 2);
    if (sh == 0) return w0;
    return (w0 >> sh) | (at((p >> 2) + 1) << (32 - sh));
  }
};

__device__ __forceinline__ int tail_bytes(uint32_t x) {
  const int t0 = (x & 0xFFu) == 0;
  const int t1 = t0 & ((x & 0xFFFFu) == 0);
  const int t2 = t1 & ((x & 0xFFFFFFu) == 0);
  return t0 + t1 + t2;
}

// byte-exact continuation of a table length: word-wise, then the tail
__device__ int extend(const Words& w, int i, int blen, int dist, int cap) {
  int k = blen;
  while (k < cap && w.get32(i + k) == w.get32(i - dist + k)) k += 4;
  k = min(k, cap);
  const uint32_t x = w.get32(i + k) ^ w.get32(i - dist + k);
  return min(k + (x == 0 ? 0 : tail_bytes(x)), cap);
}

__global__ void __launch_bounds__(kThreads)
tab_scan(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ tabf,
         const int32_t* __restrict__ tabq, long long tab_stride, int tabn,
         const int32_t* __restrict__ n_valid_arr, int start, int nice, int good, int max_lazy,
         int32_t* __restrict__ mpos, int32_t* __restrict__ mld, int C,
         int32_t* __restrict__ st) {
  if (threadIdx.x != 0) return;
  const int row = blockIdx.x;
  const Words w{words + (long long)row * W, W};
  const int32_t* tf = tabf + (long long)row * tab_stride;
  const int32_t* tq = tabq + (long long)row * tab_stride;
  int32_t* mp = mpos + (long long)row * C;
  int32_t* md = mld + (long long)row * C;
  const int n_valid = n_valid_arr[row];
  auto tab_at = [&](const int32_t* t, int p) {
    return __ldg(t + min(max(p - start, 0), tabn - 1));
  };

  int mc = 0;
  bool bad = false;
  // extend the pending match at pos, then emit it; returns its length
  auto emit = [&](int pos, int len, int dist) {
    len = extend(w, pos, len, dist, min(n_valid - pos, kMaxMatch));
    const int slot = mc < kCapM ? mc : kCapM;
    mp[slot] = pos;
    md[slot] = (int32_t)(((uint32_t)(len - kMinMatch) << 15) | (uint32_t)(dist - 1));
    bad = bad || mc >= kCapM;
    mc += 1;
    return len;
  };

  int i = start, plen = 0, pdist = 0;
  bool avail = false;
  while (i < n_valid && !bad) {
    if (!avail) {
      while (i < n_valid && tab_at(tf, i) == 0) ++i;  // the literal sprint
    }
    const int bl0 = avail ? plen : 0;
    const int cap = min(n_valid - i, kMaxMatch);
    const int32_t t = tab_at(bl0 >= good ? tq : tf, i);
    const int m = min(t >> 16, cap);
    const int d = t & 0xFFFF;
    int blen = 0, bdist = 0;
    if ((!avail || plen < max_lazy) && bl0 < min(nice, cap) && m > bl0 && m >= kMinMatch &&
        !(m == kMinMatch && d > kTooFar)) {
      blen = m;
      bdist = d;
    }
    if (avail && blen == 0 && plen >= kMinMatch) {
      // one-step lazy: the match pending at i - 1 stands
      i = i - 1 + emit(i - 1, plen, pdist);
      plen = pdist = 0;
      avail = false;
    } else {
      avail = blen >= kMinMatch;
      plen = avail ? blen : 0;
      pdist = avail ? bdist : 0;
      i += 1;
    }
  }
  if (avail && plen >= kMinMatch && i - 1 + plen <= n_valid) emit(i - 1, plen, pdist);

  int32_t* s = st + (long long)row * 8;
  s[0] = mc;
  s[1] = bad ? 1 : 0;
  for (int k = 2; k < 8; ++k) s[k] = 0;
}

}  // namespace

extern "C" int zrs_tab_scan(const void* words, int W, const void* tabf, const void* tabq,
                            long long tab_stride, int tabn, const void* n_valid, int start,
                            int nice, int good, int max_lazy, void* mpos, void* mld, int C,
                            void* st, int batch, void* stream) {
  if (batch > 0) {
    tab_scan<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)tabf, (const int32_t*)tabq, tab_stride,
        tabn, (const int32_t*)n_valid, start, nice, good, max_lazy, (int32_t*)mpos,
        (int32_t*)mld, C, (int32_t*)st);
  }
  return (int)cudaGetLastError();
}
