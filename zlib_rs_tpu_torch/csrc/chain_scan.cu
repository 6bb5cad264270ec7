// K8: zlib's hash-chain scan, one chunk per block, the chain walked by a
// warp 32 candidates a step.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:scan_chunks_pallas
// (body _kernel). The chunk's positions [ins_from, start) are inserted as
// dictionary, then [start, n_valid) is parsed with zlib's longest_match
// under deflate_slow's one-step-lazy rules, decision for decision:
//   * zlib's 3-byte hash (b0 << 10) ^ (b1 << 5) ^ b2 over 15 bits;
//   * the chain budget `depth`, quartered once when the pending match is
//     at least `good`; every candidate visited costs one unit;
//   * the anchored-byte skip: a candidate whose byte at the current best
//     length differs is passed over without a full compare;
//   * the walk stops at nice = min(nice, n_valid - i, 258) and at the
//     32 KiB window edge;
//   * a length-3 match more than 4096 back is no match (TOO_FAR);
//   * a pending match at least max_lazy long skips the search;
//   * a pending match is flushed at the end only if it fits n_valid.
// Output: mpos, mld = (len - 3) << 15 | (dist - 1) per emitted match; st =
// (nmatch, bad, chain candidates visited, 0...). A write past CAP_M
// matches lands in slot CAP_M and sets bad, which ends the parse.
//
// Why the chain can be read from a sorted array. The serial walk this
// kernel replaces, which the plain version keeps (ops/kernels/
// deflate_kernel.py:_chain_scan_row, its `while cand >= 0 ...` loop over
// prev), inserts the dictionary, then each parse position at the top of
// its step, then an emitted match's interior. So every position of
// [lo, n_valid), lo = min(ins_from, start), is inserted once and in
// increasing order, whatever the parse decides, and prev is indexed by
// absolute position and never aliases (positions are below MAX_BUF + 8).
// The chain at i is then exactly the positions q in [lo, i) with
// hash(q) == hash(i), in decreasing order. With the positions sorted
// stably by hash into S, that chain is the run of S below the rank of i,
// down to its bucket's first index: the parse needs no prev chase and no
// head table.
//
// Why a warp's pick equals the serial walk's. The serial walk replaces the
// best only on a strictly longer match and stops right after the first
// candidate that reaches nice. A candidate beats the running best bl only
// if its true length exceeds bl, and then it also passes the anchored-byte
// test at bl; a candidate that fails the test at the group's starting bl
// cannot exceed it. So lane j takes S[top - j], tests it at the group's
// starting bl and, if it passes, computes its length capped at the cap.
// The lanes inside the bucket, the budget and the 32 KiB window form a
// prefix (S ascends within a bucket, so distance grows with j). The group
// is cut after its first lane whose length reaches nice; the greatest
// length among the lanes it used, if above bl, is taken at the first lane
// that has it; the candidates visited grow by the lanes used. The walk
// ends at nice, at a group short of 32 lanes, or at the budget.
//
// Bound on the H100: the serial walk on the card was a chain of dependent
// loads, about 240 cycles a candidate in one thread a chunk (1,280 ms a
// 128-chunk level-9 launch on an H100 80GB HBM3 at 700 W, where the worst
// chunk visits 11.2 M candidates). Here a group of 32 candidates costs one
// shared read each, an anchor test, a ballot and a reduction, all of them
// latency that one warp a block cannot hide (about 106 ms the same
// launch, ~580 cycles a group); the lazy parse stays serial per chunk.
// The byte floor (the chunk read once, the match stream written once)
// stays far below either.
//
// Layout: S (u16, 130,064 bytes at most) and the chunk's words (at most
// 65,040 bytes) live in dynamic shared memory (195,104 bytes, the limit
// raised with cudaFuncSetAttribute); one chunk a block, one block an SM, so
// a 128-chunk super-batch is one wave over the 132 SMs. Each block has two
// device-memory scratch rows that the wrapper allocates: 32K int32 bucket
// counters (counts, then bucket starts, then bucket ends) and, per
// position, (bucket's first index << 16) | rank. The build: all 256
// threads copy the words and count the hashes with atomics, the block
// scans the counters, warp 0 scatters the positions in order 32 at a time
// (__match_any_sync groups equal hashes; a lane's slot is its bucket's
// cursor plus the lower lanes of its group, and the group's highest lane
// advances the cursor), then all threads pack each parsed position's rank
// and first index. Warps 1-7 then leave and warp 0 runs the parse, every
// lane holding the same state; it loads the packed ranks 32 positions at a
// time. Every word index is clamped to [0, W-1], as the TPU's SMEM reads
// clamp, and an unaligned read branches before the `>> 32` that C leaves
// undefined. The wrapper guarantees n_valid <= 4 (W - 2) <= MAX_BUF + 8, so
// every position fits S and the words fit their buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHSize = 1 << 15;
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 32768;
constexpr int kTooFar = 4096;
constexpr int kCapM = 12288;
constexpr int kPosLen = 65024 + 8;
constexpr int kMaxWords = kPosLen / 4 + 2;
constexpr int kThreads = 256;
constexpr int kSortBytes = kPosLen * (int)sizeof(uint16_t);
constexpr int kMaxSmemBytes = kSortBytes + kMaxWords * (int)sizeof(uint32_t);
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Words {  // the chunk's words, in shared memory
  const uint32_t* w;
  int W;

  __device__ __forceinline__ uint32_t at(int wi) const { return w[min(max(wi, 0), W - 1)]; }
  __device__ __forceinline__ uint32_t get32(int p) const {
    const int sh = (p & 3) << 3;
    const uint32_t w0 = at(p >> 2);
    if (sh == 0) return w0;
    return (w0 >> sh) | (at((p >> 2) + 1) << (32 - sh));
  }
  __device__ __forceinline__ int byte_at(int p) const {
    return (int)((at(p >> 2) >> ((p & 3) << 3)) & 0xFFu);
  }
  __device__ __forceinline__ int hash_at(int p) const {
    const uint32_t x = get32(p);
    return (int)((((x & 0xFFu) << 10) ^ (((x >> 8) & 0xFFu) << 5) ^ ((x >> 16) & 0xFFu)) &
                 (uint32_t)(kHSize - 1));
  }
};

__device__ __forceinline__ int tail_bytes(uint32_t x) {
  const int t0 = (x & 0xFFu) == 0;
  const int t1 = t0 & ((x & 0xFFFFu) == 0);
  const int t2 = t1 & ((x & 0xFFFFFFu) == 0);
  return t0 + t1 + t2;
}

// common prefix of positions i and cand, word-wise then the tail, capped
__device__ int match_len(const Words& w, int i, int cand, int cap) {
  int k = 0;
  while (k < cap && w.get32(i + k) == w.get32(cand + k)) k += 4;
  k = min(k, cap);
  const uint32_t x = w.get32(i + k) ^ w.get32(cand + k);
  return min(k + (x == 0 ? 0 : tail_bytes(x)), cap);
}

// exclusive scan of the 32K counters in place, by the whole block: thread
// t owns counters [128 t, 128 t + 128)
__device__ void scan_counts(int32_t* cnt) {
  __shared__ int32_t warp_sum[kThreads / 32];
  constexpr int kPer = kHSize / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* seg = reinterpret_cast<int4*>(cnt + threadIdx.x * kPer);
  int sum = 0;
  for (int k = 0; k < kPer / 4; ++k) {
    const int4 v = __ldcg(seg + k);
    sum += v.x + v.y + v.z + v.w;
  }
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int v = 0; v < warp; ++v) run += warp_sum[v];
  for (int k = 0; k < kPer / 4; ++k) {
    const int4 v = __ldcg(seg + k);
    int4 o;
    o.x = run;
    o.y = o.x + v.x;
    o.z = o.y + v.y;
    o.w = o.z + v.z;
    run = o.w + v.w;
    seg[k] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
chain_scan(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ n_valid_arr,
           const int32_t* __restrict__ start_arr, const int32_t* __restrict__ ins_from_arr,
           int depth, int nice, int good, int max_lazy, int32_t* __restrict__ counts,
           uint32_t* __restrict__ ranks, int32_t* __restrict__ mpos, int32_t* __restrict__ mld,
           int C, int32_t* __restrict__ st) {
  extern __shared__ uint32_t smem[];
  uint16_t* S = reinterpret_cast<uint16_t*>(smem);
  uint32_t* ws = smem + kSortBytes / 4;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t* src = words + (long long)row * W;
  for (int k = threadIdx.x; k < W; k += kThreads) ws[k] = src[k];
  int32_t* cnt = counts + (long long)row * kHSize;
  uint32_t* rk = ranks + (long long)row * kPosLen;
  for (int h = threadIdx.x; h < kHSize; h += kThreads) cnt[h] = 0;
  __syncthreads();

  const Words w{ws, W};
  const int n_valid = n_valid_arr[row];
  const int start = start_arr[row];
  const int lo = min(ins_from_arr[row], start);

  // 1. bucket counts, then bucket starts
  for (int p = lo + (int)threadIdx.x; p < n_valid; p += kThreads) atomicAdd(cnt + w.hash_at(p), 1);
  __syncthreads();
  scan_counts(cnt);
  __syncthreads();

  // 2. the stable scatter, in position order by warp 0; the counters end
  // as bucket ends
  if (threadIdx.x < 32) {
    const unsigned below = (1u << lane) - 1u;
    for (int base = lo; base < n_valid; base += 32) {
      const int p = base + lane;
      const bool valid = p < n_valid;
      const int h = valid ? w.hash_at(p) : kHSize + lane;  // a lane past the end groups alone
      const unsigned peers = __match_any_sync(kFull, h);
      if (valid) {
        const int cur = __ldcg(cnt + h);
        const int slot = cur + __popc(peers & below);
        S[slot] = (uint16_t)p;
        rk[p] = (uint32_t)slot;
        // the group's highest lane advances the cursor
        if ((peers >> lane) == 1u) __stcg(cnt + h, cur + __popc(peers));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. each parsed position's rank beside its bucket's first index (the
  // end of the bucket below)
  for (int p = start + (int)threadIdx.x; p < n_valid; p += kThreads) {
    const int h = w.hash_at(p);
    const uint32_t first = h == 0 ? 0u : (uint32_t)__ldcg(cnt + h - 1);
    rk[p] = __ldcg(rk + p) | (first << 16);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // 4. the lazy parse, by warp 0 in lockstep
  int32_t* mp = mpos + (long long)row * C;
  int32_t* md = mld + (long long)row * C;
  int mc = 0;
  bool bad = false;
  long long visits = 0;
  auto emit = [&](int pos, int len, int dist) {
    const int slot = mc < kCapM ? mc : kCapM;
    if (lane == 0) {
      mp[slot] = pos;
      md[slot] = (int32_t)(((uint32_t)(len - kMinMatch) << 15) | (uint32_t)(dist - 1));
    }
    bad = bad || mc >= kCapM;
    mc += 1;
  };

  int i = start, plen = 0, pdist = 0, pre_base = -32;
  uint32_t pre = 0;  // lane j: the packed rank of position pre_base + j
  bool avail = false;
  while (i < n_valid && !bad) {
    int blen = 0, bdist = 0;
    if (!avail || plen < max_lazy) {
      if (i - pre_base >= 32) {
        pre_base = i;
        pre = __ldcg(rk + min(i + lane, n_valid - 1));
      }
      const uint32_t packed = __shfl_sync(kFull, pre, i - pre_base);
      const int rank = (int)(packed & 0xFFFFu), first = (int)(packed >> 16);
      const int bl0 = avail ? plen : 0;
      const int cap = min(n_valid - i, kMaxMatch);
      const int nice_eff = min(nice, cap);
      if (rank > first && bl0 < nice_eff) {
        // longest_match, 32 candidates a step
        const int budget = bl0 >= good ? depth >> 2 : depth;
        int bl = bl0, bd = 0, d = 0, top = rank - 1;
        while (bl < nice_eff) {
          const int endb = w.byte_at(i + bl);
          const int k = top - lane;
          bool live = k >= first && d + lane < budget;
          const int cand = live ? (int)S[k] : 0;
          live = live && i - cand <= kMaxDist;
          const unsigned lanes = __ballot_sync(kFull, live);
          if (lanes == 0) break;
          int ml = 0;
          if (live && w.byte_at(cand + bl) == endb) ml = match_len(w, i, cand, cap);
          const unsigned hit = __ballot_sync(kFull, live && ml >= nice_eff);
          const int used = hit ? __ffs(hit) : __popc(lanes);
          const int m = __reduce_max_sync(kFull, lane < used ? ml : 0);
          if (m > bl) {
            const int f = __ffs(__ballot_sync(kFull, lane < used && ml == m)) - 1;
            bd = i - __shfl_sync(kFull, cand, f);
            bl = m;
          }
          d += used;
          if (used < 32 || d >= budget) break;
          top -= 32;
        }
        visits += d;
        if (bl > bl0 && bl >= kMinMatch && !(bl == kMinMatch && bd > kTooFar)) {
          blen = bl;
          bdist = bd;
        }
      }
    }
    if (avail && blen == 0 && plen >= kMinMatch) {
      // one-step lazy: the match pending at i - 1 stands
      emit(i - 1, plen, pdist);
      i = i - 1 + plen;
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

  if (lane == 0) {
    int32_t* s = st + (long long)row * 8;
    s[0] = mc;
    s[1] = bad ? 1 : 0;
    s[2] = (int32_t)min(visits, (long long)INT32_MAX);
    for (int k = 3; k < 8; ++k) s[k] = 0;
  }
}

}  // namespace

extern "C" int zrs_chain_scan(const void* words, int W, const void* n_valid,
                              const void* start, const void* ins_from, int depth,
                              int nice, int good, int max_lazy, void* counts, void* ranks,
                              void* mpos, void* mld, int C, void* st, int batch, void* stream) {
  if (W > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    chain_scan<<<batch, kThreads, kSortBytes + W * (int)sizeof(uint32_t), (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)n_valid, (const int32_t*)start,
        (const int32_t*)ins_from, depth, nice, good, max_lazy, (int32_t*)counts,
        (uint32_t*)ranks, (int32_t*)mpos, (int32_t*)mld, C, (int32_t*)st);
  }
  return (int)cudaGetLastError();
}
