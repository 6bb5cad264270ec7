// K12: the interleaved hop chase, two chunks per block in lockstep.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_hop_pallas
// under ZRS_TPU_HOP_IL=2 (body _make_kernel_hop_il(cap_g, 2)). It computes
// K2's parse (csrc/hop_chase.cu) in two phases per chunk:
//   1. the chase alone: read the slot at the current position (a literal
//      slot holds the delta to the next match stop), land on the match
//      entry, recover the byte-exact length from the word-granular table
//      length (the word extension runs only where the table length is the
//      cap, shared by both lanes of the block), emit (mpos, mld = (len-3)
//      << 15 | (dist-1)), jump past the match;
//   2. the literal histogram, replayed from the emitted match stream: the
//      spans before, between and after the matches, counted word-wise into
//      four banks of 320 bins (bank k takes byte k of each 4-byte read; a
//      byte past the span end lands in the dead bin 319 of its bank).
// A chunk that overflows CAP_M matches is bad, and phase 2 counts its whole
// span once as literals (K2 clears bank 0 only and recounts, so its banks
// 1-3 keep the counts from before the overflow).
//
// Bound on the H100: like K2, a chain of dependent loads per chunk, so
// latency; the byte floor (words and htab slice read once, the match stream
// written once and read back once) is far below it.
//
// Design: one block of one warp per pair of chunks (2b, 2b + 1); thread 0
// drives both chains in lockstep, as the reference's lanes do, so the two
// chains' load latencies overlap; the other threads zero and write back the
// two histograms, kept in shared memory. words and htab stay in device
// memory, read through L1, laid out as K2 reads them. In an odd batch the
// last block has one inert lane, which reads and writes nothing; so does a
// lane with n_valid <= start. Every htab read is clamped to n_valid - 1 as
// the reference clamps it, and an unaligned word read branches before the
// `>> 32` that C leaves undefined.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kCapM = 12288;
constexpr int kBins = 320;
constexpr int kThreads = 32;
constexpr int kLanes = 2;

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

struct Lane {
  const uint32_t* w;
  const int32_t* ht;  // slot of position p is ht[p]
  int32_t* mp;
  int32_t* md;
  int nv;
  int i, mc;  // phase 1: position, matches emitted
  bool bad;
  int meff, j, p, e;  // phase 2: matches replayed, match index, position, span end
  int* hist;

  __device__ __forceinline__ bool chasing() const { return i < nv && !bad; }
};

__global__ void hop_chase_il(const uint32_t* __restrict__ words, int W,
                             const int32_t* __restrict__ htab, long long htab_stride,
                             const int32_t* __restrict__ n_valid_arr, int start,
                             int cap_g, int32_t* __restrict__ mpos,
                             int32_t* __restrict__ mld, int C,
                             int32_t* __restrict__ st, int32_t* __restrict__ freq,
                             int B) {
  __shared__ int hist[kLanes][4 * kBins];
  const int row0 = blockIdx.x * kLanes;
  for (int i = threadIdx.x; i < kLanes * 4 * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    Lane ln[kLanes];
    for (int k = 0; k < kLanes; ++k) {
      const int r = row0 + k;
      const int rr = r < B ? r : row0;  // an inert lane never dereferences these
      Lane& L = ln[k];
      L.w = words + (long long)rr * W;
      L.ht = htab + (long long)rr * htab_stride;
      L.mp = mpos + (long long)rr * C;
      L.md = mld + (long long)rr * C;
      L.nv = r < B ? n_valid_arr[r] : start;  // an inert lane: no position to chase
      L.i = start;
      L.mc = 0;
      L.bad = false;
      L.hist = hist[k];
    }

    // -- phase 1: both chases in lockstep --------------------------------
    while (ln[0].chasing() || ln[1].chasing()) {
      bool act[kLanes], dov[kLanes], need[kLanes];
      int ip[kLanes], ml[kLanes], dd[kLanes], cap[kLanes], kk[kLanes];
      for (int k = 0; k < kLanes; ++k) {  // the delta jump
        Lane& L = ln[k];
        act[k] = L.chasing();
        dov[k] = need[k] = false;
        if (!act[k]) continue;
        int32_t e = L.ht[L.i];
        int i = L.i;
        if ((e >> 30) <= 0) {
          // a run with no following stop jumps to >= n_valid: clamp
          i = min(L.i + e, L.nv);
          e = L.ht[min(i, L.nv - 1)];
        }
        dov[k] = i < L.nv;
        ip[k] = i + ((e >> 23) & 0x7F);
        ml[k] = (e >> 16) & 0x7F;
        dd[k] = e & 0xFFFF;
        cap[k] = min(L.nv - ip[k], kMaxMatch);
        need[k] = dov[k] && ml[k] == cap_g;
        kk[k] = ml[k];
      }
      // the word extension of cap-hitting lengths, shared by both lanes
      bool al[kLanes] = {need[0], need[1]};
      while (al[0] || al[1]) {
        for (int k = 0; k < kLanes; ++k) {
          if (!al[k]) continue;
          al[k] = kk[k] < cap[k] &&
              get32(ln[k].w, ip[k] + kk[k]) == get32(ln[k].w, max(ip[k] - dd[k] + kk[k], 0));
          if (al[k]) kk[k] += 4;
        }
      }
      for (int k = 0; k < kLanes; ++k) {  // sub-word tail, emit, jump
        Lane& L = ln[k];
        if (!act[k]) continue;
        if (!dov[k]) {  // the tail [i, n_valid) is all literals
          L.i = L.nv;
          continue;
        }
        if (need[k]) ml[k] = min(kk[k], cap[k]);
        const uint32_t xt = get32(L.w, ip[k] + ml[k]) ^ get32(L.w, max(ip[k] - dd[k] + ml[k], 0));
        const int mlen = min(ml[k] + tail_bytes(xt), cap[k]);
        const int slot = L.mc < kCapM ? L.mc : kCapM;
        L.mp[slot] = ip[k];
        L.md[slot] = (int32_t)(((uint32_t)(mlen - kMinMatch) << 15) | (uint32_t)(dd[k] - 1));
        L.bad = L.mc >= kCapM;
        L.mc += 1;
        L.i = ip[k] + mlen;
      }
    }

    // -- phase 2: the literal spans, replayed from the match streams -------
    // a bad lane's parse degrades to all literals: its span is one run
    for (int k = 0; k < kLanes; ++k) {
      Lane& L = ln[k];
      L.meff = L.bad ? 0 : L.mc;
      L.j = 0;
      L.p = start;
      L.e = L.meff > 0 ? L.mp[0] : L.nv;
    }
    while (ln[0].p < ln[0].nv || ln[1].p < ln[1].nv) {
      for (int k = 0; k < kLanes; ++k) {
        Lane& L = ln[k];
        if (L.p >= L.nv) continue;
        if (L.p < L.e) {  // one word of the span
          const uint32_t x = get32(L.w, L.p);
          const int rem = L.e - L.p;
          L.hist[x & 0xFFu] += 1;
          L.hist[kBins + (rem >= 2 ? (int)((x >> 8) & 0xFFu) : kBins - 1)] += 1;
          L.hist[2 * kBins + (rem >= 3 ? (int)((x >> 16) & 0xFFu) : kBins - 1)] += 1;
          L.hist[3 * kBins + (rem >= 4 ? (int)(x >> 24) : kBins - 1)] += 1;
          L.p += 4;
        }
        if (L.p >= L.e) {  // span done: hop over match j to the next span
          if (L.j < L.meff) {
            L.p = L.mp[L.j] + (int)((uint32_t)L.md[L.j] >> 15) + kMinMatch;
            L.j += 1;
            L.e = L.j < L.meff ? L.mp[L.j] : L.nv;
          } else {
            L.p = L.nv;
          }
        }
      }
    }

    for (int k = 0; k < kLanes; ++k) {
      if (row0 + k >= B) continue;
      int32_t* s = st + (long long)(row0 + k) * 8;
      s[0] = ln[k].mc;
      s[1] = ln[k].bad ? 1 : 0;
      for (int q = 2; q < 8; ++q) s[q] = 0;
    }
  }
  __syncthreads();
  for (int k = 0; k < kLanes; ++k) {
    if (row0 + k >= B) break;
    int32_t* f = freq + (long long)(row0 + k) * 4 * kBins;
    for (int i = threadIdx.x; i < 4 * kBins; i += kThreads) f[i] = hist[k][i];
  }
}

}  // namespace

extern "C" int zrs_hop_chase_il(const void* words, int W, const void* htab,
                                long long htab_stride, const void* n_valid,
                                int start, int cap_g, void* mpos, void* mld,
                                int C, void* st, void* freq, int batch,
                                void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kLanes - 1) / kLanes;
    hop_chase_il<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)htab, htab_stride,
        (const int32_t*)n_valid, start, cap_g, (int32_t*)mpos, (int32_t*)mld,
        C, (int32_t*)st, (int32_t*)freq, batch);
  }
  return (int)cudaGetLastError();
}
