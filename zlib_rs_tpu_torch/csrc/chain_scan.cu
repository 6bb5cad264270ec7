// K8: zlib's hash-chain scan, one chunk per block.
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
//   * an emitted match's interior is inserted up to n_valid;
//   * a pending match is flushed at the end only if it fits n_valid.
// Output: mpos, mld = (len - 3) << 15 | (dist - 1) per emitted match; st =
// (nmatch, bad, chain candidates visited, 0...). A write past CAP_M
// matches lands in slot CAP_M and sets bad, which ends the parse.
//
// Bound on the H100: the walk is a chain of dependent loads (the next
// candidate comes from the previous one's prev slot) plus a byte read per
// candidate, one chain per chunk, so it is latency-bound; the byte floor
// (the chunk read once, the match stream written once) is far below it.
//
// Layout: the TPU kernel keeps an i32 head table (128 KiB) and the prev
// chain as packed u16 (127 KiB) in SMEM, and the chunk's words in SMEM
// too. 255 KiB is more than the 227 KiB a Hopper block may use. The walk
// reads prev and one chunk byte for every candidate, and the heads once a
// position, so prev (u16 with 0xFFFF as NIL: every position is below
// MAX_BUF + 8 = 65032, 130,064 bytes) and the chunk's words (at most
// 65,040 bytes) live in dynamic shared memory (195,104 bytes at most, the
// limit raised with cudaFuncSetAttribute), and the 32K u16 heads of each
// chunk in a device-memory scratch row (64 KiB a chunk) that the wrapper
// allocates. (A first layout with head and prev in shared memory and the
// words read through L1 took 1.48 s a level-9 super-batch on the H100,
// this one 1.38 s: ~240 cycles a candidate either way, so the walk is
// bound by one thread's chain of dependent instructions, not by where the
// bytes live.) One chunk a block, one block an SM: a 128-chunk
// super-batch is one wave over the 132 SMs. The block's 256 threads copy
// the words in and clear the heads; thread 0 then runs the serial parse
// (prev is read only at positions that were inserted, so it needs no
// clearing). Every word index is clamped to [0, W-1], as the TPU's SMEM
// reads clamp, and an unaligned read branches before the `>> 32` that C
// leaves undefined. The wrapper guarantees n_valid <= 4 (W - 2) <= MAX_BUF
// + 8, so every position fits prev and the words fit their buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHSize = 1 << 15;
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 32768;
constexpr int kTooFar = 4096;
constexpr int kCapM = 12288;
constexpr int kPrevLen = 65024 + 8;
constexpr uint16_t kNil = 0xFFFF;
constexpr int kMaxWords = kPrevLen / 4 + 2;
constexpr int kThreads = 256;
constexpr int kPrevBytes = kPrevLen * (int)sizeof(uint16_t);
constexpr int kMaxSmemBytes = kPrevBytes + kMaxWords * (int)sizeof(uint32_t);

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

__global__ void __launch_bounds__(kThreads)
chain_scan(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ n_valid_arr,
           const int32_t* __restrict__ start_arr, const int32_t* __restrict__ ins_from_arr,
           int depth, int nice, int good, int max_lazy, uint16_t* __restrict__ heads,
           int32_t* __restrict__ mpos, int32_t* __restrict__ mld, int C,
           int32_t* __restrict__ st) {
  extern __shared__ uint32_t smem[];
  uint16_t* prev = reinterpret_cast<uint16_t*>(smem);
  uint32_t* ws = smem + kPrevBytes / 4;
  const int row = blockIdx.x;
  const uint32_t* src = words + (long long)row * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) ws[k] = src[k];
  uint16_t* head = heads + (long long)row * kHSize;
  uint32_t* head2 = reinterpret_cast<uint32_t*>(head);
  for (int h = threadIdx.x; h < kHSize / 2; h += blockDim.x) head2[h] = 0xFFFFFFFFu;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const Words w{ws, W};
  int32_t* mp = mpos + (long long)row * C;
  int32_t* md = mld + (long long)row * C;
  const int n_valid = n_valid_arr[row];
  const int start = start_arr[row];

  auto insert = [&](int p) {
    const int h = w.hash_at(p);
    prev[p] = head[h];
    head[h] = (uint16_t)p;
  };
  for (int p = ins_from_arr[row]; p < start; ++p) insert(p);

  int mc = 0;
  bool bad = false;
  long long visits = 0;
  auto emit = [&](int pos, int len, int dist) {
    const int slot = mc < kCapM ? mc : kCapM;
    mp[slot] = pos;
    md[slot] = (int32_t)(((uint32_t)(len - kMinMatch) << 15) | (uint32_t)(dist - 1));
    bad = bad || mc >= kCapM;
    mc += 1;
  };

  int i = start, plen = 0, pdist = 0;
  bool avail = false;
  while (i < n_valid && !bad) {
    const int h = w.hash_at(i);
    const uint16_t c0 = head[h];
    prev[i] = c0;
    head[h] = (uint16_t)i;
    int blen = 0, bdist = 0;
    if ((!avail || plen < max_lazy) && c0 != kNil) {
      // longest_match
      const int bl0 = avail ? plen : 0;
      const int cap = min(n_valid - i, kMaxMatch);
      const int nice_eff = min(nice, cap);
      const int budget = bl0 >= good ? depth >> 2 : depth;
      int bl = bl0, bd = 0, d = 0, cand = c0;
      int endb = w.byte_at(i + bl);
      while (cand >= 0 && i - cand <= kMaxDist && d < budget && bl < nice_eff) {
        const uint16_t nx = prev[cand];  // issued before the anchor test
        if (w.byte_at(cand + bl) == endb) {
          const int ml = match_len(w, i, cand, cap);
          if (ml > bl) {
            bl = ml;
            bd = i - cand;
            endb = w.byte_at(i + min(ml, cap - 1));
          }
        }
        cand = nx == kNil ? -1 : (int)nx;
        ++d;
      }
      visits += d;
      if (bl > bl0 && bl >= kMinMatch && !(bl == kMinMatch && bd > kTooFar)) {
        blen = bl;
        bdist = bd;
      }
    }
    if (avail && blen == 0 && plen >= kMinMatch) {
      // one-step lazy: the match pending at i - 1 stands
      emit(i - 1, plen, pdist);
      const int hi = min(i - 1 + plen, n_valid);
      for (int p = i + 1; p < hi; ++p) insert(p);
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

  int32_t* s = st + (long long)row * 8;
  s[0] = mc;
  s[1] = bad ? 1 : 0;
  s[2] = (int32_t)min(visits, (long long)INT32_MAX);
  for (int k = 3; k < 8; ++k) s[k] = 0;
}

}  // namespace

extern "C" int zrs_chain_scan(const void* words, int W, const void* n_valid,
                              const void* start, const void* ins_from, int depth,
                              int nice, int good, int max_lazy, void* heads, void* mpos,
                              void* mld, int C, void* st, int batch, void* stream) {
  if (W > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    chain_scan<<<batch, kThreads, kPrevBytes + W * (int)sizeof(uint32_t), (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)n_valid, (const int32_t*)start,
        (const int32_t*)ins_from, depth, nice, good, max_lazy, (uint16_t*)heads,
        (int32_t*)mpos, (int32_t*)mld, C, (int32_t*)st);
  }
  return (int)cudaGetLastError();
}
