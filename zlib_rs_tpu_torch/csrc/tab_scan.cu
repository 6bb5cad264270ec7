// K10: the one-step-lazy parse over precomputed match tables, as a
// parallel resolve of every position into shared memory and a chase over
// it, one block per chunk.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_tab_pallas
// (body _make_kernel_tab). ops/lzvec.build_match_tables gives, for every
// position, zlib's longest_match summary as (len << 16 | dist) for the full
// chain budget (tabf) and the quartered one (tabq), len capped at 4 * w_g
// and word-granular past its first words. The parse is deflate_slow's
// decision loop with the chain walk replaced by one table read; as a serial
// walk (the plain `_tab_scan_row` in ops/kernels/deflate_kernel.py) it is:
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
// Why the per-position resolution is exact. The walk is at a clean arrival
// (nothing pending) at `start` and after every emitted match. From a clean
// arrival at p, what follows depends on p alone: either p is no stop
// (tabf gives no match of at least 3 within the cap, or a length-3 match
// past TOO_FAR, or nice is 0), and the walk moves to p + 1, again a clean
// arrival (the sprint only skips such positions faster); or p is a stop,
// and the deferral chain reads tabf or tabq at p + 1, p + 2, ... (the
// choice depends on the pending length), each step a pure function of the
// position and the pending match, until a step finds no longer match; the
// pending match at q - 1 is then extended (a function of q - 1, its length
// and its dist) and emitted, and the walk arrives clean at q - 1 + len. So
// all threads resolve every position of a tile at once into a 32-bit slot
//     stop:    1 << 31 | h << 23 | (len - 3) << 15 | (dist - 1)
//              (h = q - 1 - p; the low 23 bits are the mld word)
//     literal: the distance to the next stop of its warp's segment, or to
//              the segment's end (a suffix minimum, by ballots)
// and the slots are chased: one step a match and one a literal run. The
// resolve strides the positions over the block, as the work per stop
// varies by a chain and an extension; a second pass of ballots, each warp
// over a contiguous segment, then turns each literal into its distance.
// h fits 8 bits: each chain step raises the pending length by at least 1
// from at least 3, and a step needs it below min(nice, cap) <= 258, so
// h <= 255 (max_lazy = 258 at levels 8-9). A stop whose dist is outside
// [1, 32768] does not fit the slot; it gets 0, and a chase that meets it
// hands the lane to the serial walk, by one thread from device memory
// from the tile's true entry (build_match_tables gives no such dist).
//
// The chase is K12's (csrc/hop_chase_il.cu says why it is exact): the tile
// is cut into one segment a thread; each thread walks from an entry to its
// segment's end, counting matches; every entry but the first is replaced
// by the exit of the segment before, until none changes or kRounds have
// passed, and then one thread fixes the rest up in order; a prefix sum of
// the counts places each segment's matches, and a last walk writes them.
// One thread walking all the slots would be slow: one warp cannot hide its
// own chain of dependent loads.
//
// The end of the walk. The serial walk also emits a match still pending
// when it runs off n_valid (if it fits). That never happens: a stop at p
// needs a match of at least 3 within cap = n_valid - p, so p + 1 <
// n_valid; a chain step at q that continues needs the pending length below
// the cap at q and takes a longer one within it, at least 4, so q + 1 <
// n_valid too. Every pending match is decided before n_valid, and the
// chase needs no flush. The `bad` stop is the walk's: the emit that writes
// slot CAP_M ends the parse.
//
// Tiles. The slots of [t0, t0 + tile) live in dynamic shared memory. A
// tile starts at `start`, then where the chase first leaves the previous
// one (the end of a match, or a literal run to the tile's end); only the
// tiles the chase enters are resolved. On the main path one tile holds the
// whole 32 KiB span.
//
// Bound on the H100: the resolve reads both tables a few positions past
// each stop and the words of each extension; the chase a shared load a
// step; the byte floor (both tables over the span, the chunk, the match
// stream out) is far below both.
//
// Every word index is clamped to [0, W-1] and every table index to
// [0, tabn-1], as the TPU's SMEM reads clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kTooFar = 4096;
constexpr int kCapM = 12288;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 6;  // chase rounds before the sequential fix-up
constexpr uint32_t kStop = 0x80000000u;

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

struct Tables {
  const int32_t* __restrict__ tf;
  const int32_t* __restrict__ tq;
  int tabn, start, nv, nice, good, max_lazy;

  __device__ __forceinline__ int32_t at(const int32_t* t, int p) const {
    return __ldg(t + min(max(p - start, 0), tabn - 1));
  }

  // the clean-arrival outcome at p < n_valid: false for no stop, else the
  // match it leaves (pos, exact len, dist)
  __device__ bool resolve(const Words& w, int p, int& pos, int& len, int& dist) const {
    int cap = min(nv - p, kMaxMatch);
    int32_t t = at(tf, p);
    int m = min(t >> 16, cap);
    int d = t & 0xFFFF;
    if (!(0 < min(nice, cap) && m >= kMinMatch && !(m == kMinMatch && d > kTooFar))) return false;
    int plen = m, pdist = d, q = p + 1;
    for (;;) {  // q < n_valid throughout (see the header)
      cap = min(nv - q, kMaxMatch);
      t = at(plen >= good ? tq : tf, q);
      m = min(t >> 16, cap);
      if (!(plen < max_lazy && plen < min(nice, cap) && m > plen)) break;
      plen = m;
      pdist = t & 0xFFFF;
      ++q;
    }
    pos = q - 1;
    dist = pdist;
    len = extend(w, pos, plen, pdist, min(nv - pos, kMaxMatch));
    return true;
  }
};

// one step of the chase from the clean position p of the tile [t0, ...):
// the next position, with the match slot it emits in m (0 for a literal
// run); -1 where the serial walk must take over
__device__ __forceinline__ int step(const uint32_t* R, int t0, int p, int& pos, uint32_t& m) {
  const uint32_t s = R[p - t0];
  if (s & kStop) {
    m = s;
    pos = p + (int)((s >> 23) & 0xFF);
    return pos + (int)((s >> 15) & 0xFF) + kMinMatch;
  }
  m = 0;
  return s ? p + (int)s : -1;
}

// the walk of one segment from p to hi: the exit, with the matches
// emitted in cnt; -1 where the serial walk must take over
__device__ __forceinline__ int walk(const uint32_t* R, int t0, int p, int hi, int& cnt) {
  int pos = 0;
  uint32_t m = 0;
  cnt = 0;
  while (p < hi) {
    const int nx = step(R, t0, p, pos, m);
    if (nx < 0) return -1;
    cnt += m != 0;
    p = nx;
  }
  return p;
}

__global__ void __launch_bounds__(kThreads)
tab_scan(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ tabf,
         const int32_t* __restrict__ tabq, long long tab_stride, int tabn,
         const int32_t* __restrict__ n_valid_arr, int start, int nice, int good, int max_lazy,
         int32_t* __restrict__ mpos, int32_t* __restrict__ mld, int C,
         int32_t* __restrict__ st, int tile) {
  extern __shared__ uint32_t R[];  // the tile's slots
  __shared__ int s_from[kThreads], s_exit[kThreads], s_cnt[kThreads], s_wsum[kWarps];
  __shared__ int s_serial, s_mc, s_bad;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Words w{words + (long long)row * W, W};
  const int nv = n_valid_arr[row];
  const Tables tb{tabf + (long long)row * tab_stride, tabq + (long long)row * tab_stride,
                  tabn, start, nv, nice, good, max_lazy};
  int32_t* mp = mpos + (long long)row * C;
  int32_t* md = mld + (long long)row * C;
  if (tid == 0) s_serial = 0;

  int t0 = start, mc = 0;  // block-uniform
  bool bad = false;
  while (t0 < nv && !bad) {
    const int tn = min(nv - t0, tile);
    // resolve, positions strided over the block (the work per stop varies
    // a lot, and a contiguous share would leave a warp with a run's worth):
    // a stop's slot, or 1 for a literal
    for (int k = tid; k < tn; k += kThreads) {
      int pos, len, dist;
      uint32_t slot = 1;
      if (tb.resolve(w, t0 + k, pos, len, dist))
        slot = dist >= 1 && dist <= 32768
                   ? kStop | (uint32_t)(pos - t0 - k) << 23 | (uint32_t)(len - kMinMatch) << 15 |
                         (uint32_t)(dist - 1)
                   : 0u;
      R[k] = slot;
    }
    __syncthreads();
    // each literal's distance to the next stop: each warp walks its segment
    // of whole groups of 32 backward, carrying the next stop at or after the
    // group's end
    const int rseg = (tn + kWarps * 32 - 1) / (kWarps * 32) * 32;
    const int s0 = min(warp * rseg, tn);
    const int s1 = min(s0 + rseg, tn);
    int carry = s1;
    for (int gb = s0 + (s1 - s0 - 1) / 32 * 32; s1 > s0 && gb >= s0; gb -= 32) {
      const int k = gb + lane;
      const uint32_t slot = k < s1 ? R[k] : 0u;
      const bool stop = k < s1 && slot != 1;
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, stop);
      if (k < s1 && !stop) {
        const unsigned hi = mask & (0xFFFFFFFFu << lane);
        R[k] = (uint32_t)((hi ? gb + __ffs(hi) - 1 : carry) - k);
      }
      if (mask) carry = gb + __ffs(mask) - 1;
    }
    __syncthreads();

    // chase: a segment a thread, walked from its entry until the entries
    // are the exits before them, or a fix-up (see the header)
    const int seg = (tn + kThreads - 1) / kThreads;
    const int hi = t0 + min((tid + 1) * seg, tn);
    int cnt, from = t0 + min(tid * seg, tn), exitp = walk(R, t0, from, hi, cnt), entry;
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
        exitp = walk(R, t0, from, hi, cnt);
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
          const int x = walk(R, t0, p, t0 + min((k + 1) * seg, tn), c);
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
    if (s_serial) {  // the walk, by one thread, to the end of the span
      if (tid == 0) {
        int i = t0;
        while (i < nv && !bad) {
          int pos, len, dist;
          if (!tb.resolve(w, i, pos, len, dist)) {
            ++i;
            continue;
          }
          const int slot = mc < kCapM ? mc : kCapM;
          mp[slot] = pos;
          md[slot] = (int32_t)(((uint32_t)(len - kMinMatch) << 15) | (uint32_t)(dist - 1));
          bad = mc >= kCapM;
          mc += 1;
          i = pos + len;
        }
        s_mc = mc;
        s_bad = bad;
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
    for (int p = from, pos = 0; cnt > 0 && p < hi && j <= kCapM;) {
      uint32_t m = 0;
      p = step(R, t0, p, pos, m);
      if (m != 0) {
        mp[j] = pos;  // slot CAP_M takes the overflowing match
        md[j] = (int32_t)(m & 0x7FFFFFu);
        ++j;
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
    int32_t* s = st + (long long)row * 8;
    s[0] = mc;
    s[1] = bad ? 1 : 0;
    for (int k = 2; k < 8; ++k) s[k] = 0;
  }
}

}  // namespace

extern "C" int zrs_tab_scan(const void* words, int W, const void* tabf, const void* tabq,
                            long long tab_stride, int tabn, const void* n_valid, int start,
                            int nice, int good, int max_lazy, void* mpos, void* mld, int C,
                            void* st, int batch, int tile, void* stream) {
  if (tile < 1024) return (int)cudaErrorInvalidValue;
  const int smem = tile * (int)sizeof(uint32_t);
  cudaError_t err =
      cudaFuncSetAttribute(tab_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    tab_scan<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)tabf, (const int32_t*)tabq, tab_stride,
        tabn, (const int32_t*)n_valid, start, nice, good, max_lazy, (int32_t*)mpos,
        (int32_t*)mld, C, (int32_t*)st, tile);
  }
  return (int)cudaGetLastError();
}
