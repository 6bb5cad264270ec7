// K2 and K12: the hop chase as a parallel resolve into shared memory, a
// parallel chase over it and a parallel literal histogram, one block per
// chunk. One templated body serves both kernels; they differ only in how
// a lane that overflows CAP_M counts its literals.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_hop_pallas,
// both its default body _make_kernel_hop (K2, `zrs_hop_chase`, the level
// 3-7 encode's chase) and its ZRS_TPU_HOP_IL=2 body _make_kernel_hop_il(
// cap_g, 2) (K12, `zrs_hop_chase_il`). K2's reference walks the chunk in
// one serial loop and counts each literal span as it passes; this body
// computes the same parse and counts the spans afterwards, from the match
// stream. The reference's K12 interleaves two chunks in one grid step so
// that their SMEM loads overlap; that pairing is a TPU layout, and a block
// of the card gains nothing from it, so each chunk has its own block.
//
// Why resolving before the chase is exact. K2's serial loop (`Serial::run`
// below, deflate_kernel.py `_chase_row`) does at each step: read the slot
// at i0; if it is a literal slot, jump by its delta and read the slot
// where it lands, as a match entry; then recover the byte-exact length of
// that match entry (the word extension where the table length is cap_g,
// then the byte tail, capped at min(n_valid - ip, 258), ip = landing +
// h) and jump past it. The length depends on the landing position alone:
// ip, cap and dist follow from it and the table, and the words are fixed.
// So every match entry of the span can be resolved at once, by all threads,
// into a 32-bit slot
//     1 << 31 | h << 24 | (len - 3) << 16 | dist   (h < 128, the table's
//                                                   16-bit dist as it is)
// and a literal entry (0 < delta < 2^30) is copied as it is. A step of the
// chase is then one or two shared loads. A slot of 0 marks a position the
// resolve leaves to the serial step: a literal entry <= 0, or a match
// entry whose length would not fit (ip at or past n_valid, a table length
// past the cap, a length under 3). A landing that is not a resolved match
// takes the serial step too: K2 decodes whatever it lands on as a match
// entry. Tables from ops/lzvec.build_hop_tables never do either (a
// literal's delta points at the next stop, and every stop's length is at
// least 3 and within the cap).
//
// Why the parallel chase is exact. A step of the chase is a pure function
// of the position it starts from (a clean arrival): its next position and
// the match it emits, if any. One thread walking that function from
// `start` is K2's loop, and slow on the card: one warp cannot hide its own
// chain of dependent loads. So the tile is cut into one segment a thread,
// and each thread walks from an entry until it reaches its segment's end,
// counting its matches. Segment 0's entry is the true one; each other
// entry starts as its segment's first position and is then replaced by
// the exit of the segment before, and the segments whose entry changed
// walk again, until no entry changes. At that fixed point every entry is
// the previous segment's exit, so by induction from segment 0 the walks
// are the serial path cut into pieces. Parses resynchronise within a few
// matches, so a few rounds reach it; in a run of long matches a wrong
// entry stays out of step and the fixed point moves one segment a round,
// so after kRounds one thread finishes it in a single pass over the
// segments in order, walking only those whose walk did not start from the
// true entry (a long match crosses segments in one step). A prefix sum of
// the counts gives each segment its first match slot, and a last walk
// writes the matches. The serial loop's CAP_M rule is a count: the match
// of index CAP_M goes to slot CAP_M and sets bad, and none after it is
// written. Any walk that meets a serial-step position sends the lane to
// K2's loop, run by one thread from device memory from the tile's true
// entry.
//
// Tiles. The slots of [t0, t0 + tile) live in dynamic shared memory; a
// tile starts at `start`, then at the exit of the previous tile's last
// segment. A landing past the tile is resolved from device memory where
// it is needed. On the main path one tile holds the whole 32 KiB span.
//
// The histogram is then replayed from the match stream, in parallel: span
// j runs from the end of match j - 1 (or `start`) to mpos[j] (or n_valid
// after the last), counted word-wise from its own start into four banks of
// 320 bins (bank k takes byte k of each 4-byte read; a byte past the span
// end lands in the dead bin 319 of its bank), by shared atomics. A thread
// counts the first kShortWords words of each span it takes; a warp
// finishes a longer span, its lanes 32 words apart. Shared atomics make
// the order of the counts free, so the bins are the serial loop's.
//
// Where a span starts. K12 reads a match's end back from its mld, as its
// reference does: (len - 3) << 15 | (dist - 1), which holds the length
// only while dist - 1 < 2^15. K2's serial loop jumps by the true length,
// so under kK2 the chase also writes each match's end into a scratch row
// (`ends`, B x C int32 from the wrapper) and the spans start there. The
// two differ only on tables whose dist runs past the 32 KiB window.
//
// The overflow rule. A bad lane (more than CAP_M matches) degrades to an
// all-literal parse downstream. K12 counts its whole span [start, n_valid)
// once. K2 keeps its reference's rule: the serial loop has counted the
// spans before matches 0..CAP_M when it stops, then clears bank 0 only and
// counts the whole span again, so banks 1-3 keep their counts from before
// the overflow, the dead bins 319 included. The template argument kK2
// picks the rule: under it a bad lane counts its CAP_M + 1 spans that end
// at a match, then, after a barrier, bank 0 is cleared and the whole span
// is counted by all threads.
//
// Bound on the H100: the resolve reads a few words a match entry (more
// where a table length hits cap_g and the match runs on), the chase a few
// shared loads a step, the histogram a word read a literal word; the byte
// floor (words and htab over the span read once, the match stream written
// once) is far below each.
//
// Every htab read of the serial step is clamped to n_valid - 1 as the
// reference clamps it; the resolve reads only positions below n_valid and
// words below n_valid + 4 (it leaves anything longer to the serial step),
// a match source before the row clamps to byte 0, and an unaligned word
// read branches before the `>> 32` that C leaves undefined. An empty lane
// (n_valid <= start) writes zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kCapM = 12288;
constexpr int kBins = 320;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kShortWords = 32;
constexpr int kRounds = 6;  // chase rounds before the sequential fix-up
constexpr uint32_t kMatch = 0x80000000u;

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

// the byte-exact length of the match entry (ml, dist) at ip, as K2 has it
__device__ __forceinline__ int exact_len(const uint32_t* __restrict__ w, int ip, int ml,
                                         int dist, int cap, int cap_g) {
  if (ml == cap_g) {
    int k = ml;
    while (k < cap && get32(w, ip + k) == get32(w, max(ip - dist + k, 0))) k += 4;
    ml = min(k, cap);
  }
  const uint32_t xt = get32(w, ip + ml) ^ get32(w, max(ip - dist + ml, 0));
  return min(ml + tail_bytes(xt), cap);
}

// the resolved slot of position p (see the header); 0 leaves it to the
// serial step
__device__ uint32_t resolve(const uint32_t* __restrict__ w, const int32_t* __restrict__ ht,
                            int nv, int p, int cap_g) {
  const int32_t e = __ldg(ht + p);
  if ((e >> 30) <= 0) return e > 0 ? (uint32_t)e : 0u;
  const int h = (e >> 23) & 0x7F;
  const int ml = (e >> 16) & 0x7F;
  const int dist = e & 0xFFFF;
  const int ip = p + h;
  if (ip >= nv) return 0u;
  const int cap = min(nv - ip, kMaxMatch);
  if (ml != cap_g && ml > cap) return 0u;
  const int mlen = exact_len(w, ip, ml, dist, cap, cap_g);
  if (mlen < kMinMatch) return 0u;
  return kMatch | (uint32_t)h << 24 | (uint32_t)(mlen - kMinMatch) << 16 | (uint32_t)dist;
}

__device__ __forceinline__ int32_t mld_of(uint32_t m) {
  return (int32_t)((((m >> 16) & 0xFFu) << 15) | (uint32_t)((int)(m & 0xFFFFu) - 1));
}

struct Lane {
  const uint32_t* w;
  const int32_t* ht;
  const uint32_t* R;  // the slots of [t0, t0 + tn)
  int nv, cap_g, t0, tn;

  // one step of the chase from the clean position p of the tile: the next
  // position, with the match it emits in m (0 for none: a literal run to
  // the end); -1 where the serial step must take over
  __device__ __forceinline__ int step(int p, int& ip, uint32_t& m) const {
    uint32_t s = R[p - t0];
    int i = p;
    if (!(s & kMatch)) {
      if (s == 0) return -1;
      i = min(p + (int)s, nv);
      if (i >= nv) {
        m = 0;
        return nv;
      }
      s = i - t0 < tn ? R[i - t0] : resolve(w, ht, nv, i, cap_g);
      if (!(s & kMatch)) return -1;
    }
    m = s;
    ip = i + (int)((s >> 24) & 0x7F);
    return ip + (int)((s >> 16) & 0xFF) + kMinMatch;
  }
};

// the walk of one segment from p to hi: the exit, with the matches
// emitted in cnt; -1 where the serial step must take over
__device__ __forceinline__ int walk(const Lane& ln, int p, int hi, int& cnt) {
  int ip = 0;
  uint32_t m = 0;
  cnt = 0;
  while (p < hi) {
    const int nx = ln.step(p, ip, m);
    if (nx < 0) return -1;
    cnt += m != 0;
    p = nx;
  }
  return p;
}

// K2's loop body from device memory, for what the resolve leaves
struct Serial {
  const uint32_t* w;
  const int32_t* ht;
  int32_t* mp;
  int32_t* md;
  int32_t* me;  // K2: each match's end; null for K12
  int nv, cap_g;
  int i0, mc;
  bool bad;

  __device__ void run() {
    while (i0 < nv && !bad) {
      int32_t e = __ldg(ht + i0);
      int i = i0;
      if ((e >> 30) <= 0) {
        i = min(i0 + e, nv);
        e = __ldg(ht + min(i, nv - 1));
      }
      if (i >= nv) return;  // the tail [i0, n_valid) is all literals
      const int ip = i + ((e >> 23) & 0x7F);
      const int dist = e & 0xFFFF;
      const int mlen = exact_len(w, ip, (e >> 16) & 0x7F, dist, min(nv - ip, kMaxMatch), cap_g);
      const int slot = mc < kCapM ? mc : kCapM;
      mp[slot] = ip;
      if (me) me[slot] = ip + mlen;
      md[slot] = (int32_t)(((uint32_t)(mlen - kMinMatch) << 15) | (uint32_t)(dist - 1));
      bad = mc >= kCapM;
      mc += 1;
      i0 = ip + mlen;
    }
  }
};

__device__ __forceinline__ void count_words(const uint32_t* __restrict__ w, int* hist, int p,
                                            int e, int k0, int k1, int step) {
  for (int k = k0; k < k1; k += step) {
    const int q = p + 4 * k;
    const uint32_t x = get32(w, q);
    const int rem = e - q;
    atomicAdd(hist + (x & 0xFFu), 1);
    atomicAdd(hist + kBins + (rem >= 2 ? (int)((x >> 8) & 0xFFu) : kBins - 1), 1);
    atomicAdd(hist + 2 * kBins + (rem >= 3 ? (int)((x >> 16) & 0xFFu) : kBins - 1), 1);
    atomicAdd(hist + 3 * kBins + (rem >= 4 ? (int)(x >> 24) : kBins - 1), 1);
  }
}

template <bool kK2>
__global__ void __launch_bounds__(kThreads)
hop_chase_body(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ htab,
             long long htab_stride, const int32_t* __restrict__ n_valid_arr, int start,
             int cap_g, int32_t* __restrict__ mpos, int32_t* __restrict__ mld, int C,
             int32_t* __restrict__ st, int32_t* __restrict__ freq,
             int32_t* __restrict__ ends, int tile) {
  extern __shared__ uint32_t R[];  // the tile's slots; then the long spans
  __shared__ int hist[4 * kBins];
  __shared__ int s_from[kThreads], s_exit[kThreads], s_cnt[kThreads], s_wsum[kWarps];
  __shared__ int s_serial, s_mc, s_bad, s_nlong;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t* w = words + (long long)row * W;
  const int32_t* ht = htab + (long long)row * htab_stride;
  int32_t* mp = mpos + (long long)row * C;
  int32_t* md = mld + (long long)row * C;
  int32_t* me = kK2 ? ends + (long long)row * C : nullptr;
  const int nv = n_valid_arr[row];
  for (int k = tid; k < 4 * kBins; k += kThreads) hist[k] = 0;
  int cnt = 0;
  if (tid == 0) s_serial = 0;

  int t0 = start, mc = 0;  // block-uniform
  bool bad = false;
  while (t0 < nv && !bad) {
    const int tn = min(nv - t0, tile);
    for (int k = tid; k < tn; k += kThreads) R[k] = resolve(w, ht, nv, t0 + k, cap_g);
    __syncthreads();
    const Lane ln{w, ht, R, nv, cap_g, t0, tn};
    const int seg = (tn + kThreads - 1) / kThreads;
    const int hi = t0 + min((tid + 1) * seg, tn);
    // rounds: every segment whose entry changed walks again
    int from = t0 + min(tid * seg, tn), exitp = walk(ln, from, hi, cnt), entry;
    bool settled = false;
    for (int round = 1;; ++round) {
      if (exitp < 0) s_serial = 1;
      s_exit[tid] = exitp;
      __syncthreads();
      entry = tid == 0 ? t0 : s_exit[tid - 1];
      settled = !__syncthreads_or(entry != from);
      if (settled || s_serial || round == kRounds) break;
      if (entry != from) {
        from = entry;
        exitp = walk(ln, from, hi, cnt);
      }
    }
    if (!settled && !s_serial) {  // the fix-up: one thread, segment by segment
      s_from[tid] = from;
      s_cnt[tid] = cnt;
      __syncthreads();
      if (tid == 0) {
        for (int k = 0, p = t0; k < kThreads; p = s_exit[k++]) {
          if (p == s_from[k]) continue;  // walked from its true entry
          int c;
          const int x = walk(ln, p, t0 + min((k + 1) * seg, tn), c);
          if (x < 0) {
            s_serial = 1;
            break;
          }
          s_from[k] = p;
          s_exit[k] = x;
          s_cnt[k] = c;
        }
      }
      __syncthreads();
      from = s_from[tid];
      cnt = s_cnt[tid];
    }
    if (s_serial) {  // the serial step, by one thread, to the end of the span
      if (tid == 0) {
        Serial sr{w, ht, mp, md, me, nv, cap_g, t0, mc, false};
        sr.run();
        s_mc = sr.mc;
        s_bad = sr.bad;
      }
      __syncthreads();
      mc = s_mc;
      bad = s_bad;
      break;
    }
    // the first match slot of each segment: a block prefix sum of the counts
    int v = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d) v += y;
    }
    if (lane == 31) s_wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int x = lane < kWarps ? s_wsum[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
      }
      if (lane < kWarps) s_wsum[lane] = x;
    }
    __syncthreads();
    int j = mc + (warp ? s_wsum[warp - 1] : 0) + v - cnt;
    if (cnt > 0 && j <= kCapM) {
      int p = from, ip = 0;
      uint32_t m = 0;
      while (p < hi && j <= kCapM) {
        p = ln.step(p, ip, m);
        if (m != 0) {
          mp[j] = ip;  // slot CAP_M takes the overflowing match
          if (kK2) me[j] = ip + (int)((m >> 16) & 0xFFu) + kMinMatch;
          md[j] = mld_of(m);
          ++j;
        }
      }
    }
    mc += s_wsum[kWarps - 1];
    if (mc > kCapM) {
      bad = true;
      mc = kCapM + 1;
    }
    t0 = s_exit[kThreads - 1];
    __syncthreads();  // every read of the slots, the sums and the exits is done
  }
  if (tid == 0) {
    s_nlong = 0;
    int32_t* s = st + (long long)row * 8;
    s[0] = mc;
    s[1] = bad ? 1 : 0;
    for (int q = 2; q < 8; ++q) s[q] = 0;
  }
  __syncthreads();  // the match stream is visible to the block: read it through L2

  // pass 1: a thread a span, its first kShortWords words. Span j ends at
  // match j for j < nm, at n_valid for the tail span j == nm; a bad lane
  // has no tail span under K2's rule and one span, the whole, under K12's
  const int nm = bad && !kK2 ? 0 : mc;
  const int nspan = bad && kK2 ? mc : nm + 1;
  auto span = [&](int jj, int& p, int& e) {
    p = jj == 0 ? start
        : kK2   ? __ldcg(me + jj - 1)
                : __ldcg(mp + jj - 1) + (int)((uint32_t)__ldcg(md + jj - 1) >> 15) + kMinMatch;
    e = jj < nm ? __ldcg(mp + jj) : nv;
  };
  for (int jj = tid; jj < nspan; jj += kThreads) {
    int p, e;
    span(jj, p, e);
    const int nw = e > p ? (e - p + 3) >> 2 : 0;
    count_words(w, hist, p, e, 0, min(nw, kShortWords), 1);
    if (nw > kShortWords) {
      const int k = atomicAdd(&s_nlong, 1);
      if (k < tile) R[k] = (uint32_t)jj;
      else count_words(w, hist, p, e, kShortWords, nw, 1);  // the list is full
    }
  }
  __syncthreads();
  // pass 2: a warp a long span, its lanes 32 words apart
  const int nlong = min(s_nlong, tile);
  for (int k = warp; k < nlong; k += kWarps) {
    int p, e;
    span((int)R[k], p, e);
    count_words(w, hist, p, e, kShortWords + lane, (e - p + 3) >> 2, 32);
  }
  __syncthreads();
  if (kK2 && bad) {  // K2's recount: bank 0 cleared, the whole span again
    for (int k = tid; k < kBins; k += kThreads) hist[k] = 0;
    __syncthreads();
    count_words(w, hist, start, nv, tid, nv > start ? (nv - start + 3) >> 2 : 0, kThreads);
    __syncthreads();
  }
  int32_t* f = freq + (long long)row * 4 * kBins;
  for (int k = tid; k < 4 * kBins; k += kThreads) f[k] = hist[k];
}

template <bool kK2>
int launch(const void* words, int W, const void* htab, long long htab_stride,
           const void* n_valid, int start, int cap_g, void* mpos, void* mld, int C, void* st,
           void* freq, void* ends, int batch, int tile, void* stream) {
  if (tile < 1024 || (kK2 && ends == nullptr)) return (int)cudaErrorInvalidValue;
  const int smem = tile * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(hop_chase_body<kK2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    hop_chase_body<kK2><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)htab, htab_stride,
        (const int32_t*)n_valid, start, cap_g, (int32_t*)mpos, (int32_t*)mld,
        C, (int32_t*)st, (int32_t*)freq, (int32_t*)ends, tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2: the overflow recount of the reference's _make_kernel_hop; ends is
// the B x C int32 scratch of match ends
extern "C" int zrs_hop_chase(const void* words, int W, const void* htab,
                             long long htab_stride, const void* n_valid, int start,
                             int cap_g, void* mpos, void* mld, int C, void* st,
                             void* freq, void* ends, int batch, int tile, void* stream) {
  return launch<true>(words, W, htab, htab_stride, n_valid, start, cap_g, mpos, mld, C, st,
                      freq, ends, batch, tile, stream);
}

// K12: a bad lane's span counted once; ends is unused (null)
extern "C" int zrs_hop_chase_il(const void* words, int W, const void* htab,
                                long long htab_stride, const void* n_valid,
                                int start, int cap_g, void* mpos, void* mld,
                                int C, void* st, void* freq, void* ends, int batch,
                                int tile, void* stream) {
  return launch<false>(words, W, htab, htab_stride, n_valid, start, cap_g, mpos, mld, C, st,
                       freq, ends, batch, tile, stream);
}
