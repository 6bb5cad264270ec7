// K4: the two-plane vector Huffman decode, one thread per walker.
//
// Replaces zlib_rs_tpu/ops/pallas/vhuff_kernel.py:decode_tokens_vector2
// (body _make_kernel2). A walker starts at an encoder-recorded seed (bit
// offset, output span) of one chunk and decodes its span into tape rows.
// Each row holds up to three literals and the match that follows them, or
// four literals, or a lone match: tapeA the literal bytes LSB first, tapeB
// cnt | has << 3 | (len - 3) << 4 | dist << 12. Rows after the walker
// stops are zero. Outputs per walker: bits consumed (cons), a bad flag and
// the span left undecoded (rem).
//
// The bit window is 128 bits (two 64-bit registers). Before each row three
// refills of one word each keep at least 93 bits in it (the largest row:
// three 15-bit literals and a 48-bit match), exactly as the reference:
// four refills and a consume of the seed's sub-word alignment at the
// start, a refill only where bitcnt <= 92. A code's length is 1 + the
// number of 15-bit limits it reaches (the canonical compare cascade); its
// symbol is work[off[len] + (v15 - base15[len]) >> (15 - len)], the index
// clamped to the table as the reference clamps it.
//
// Bound on the H100: bytes. Each walker reads its body words once and
// writes cap rows of two planes; the decode itself is a few hundred
// integer operations a row, far below the card's rate. The loop is serial
// per walker, so the kernel is latency-bound in practice.
//
// Design: 128 walkers (always of one chunk, since S % 128 == 0) form a
// block; the block holds its chunk's six cascade tables (576 ints) in
// shared memory. Tapes are row-major [cap, W], so row t of a warp's 32
// walkers is one coalesced store. Every word read is clamped to the body
// array as the reference's staged FIFO clamps it. C leaves shifts by 32
// or more undefined where the TPU code uses clamps and selects: each
// shift below is by less than the register width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTableWords = 576;
constexpr int kLlLim = 0, kLlPack = 16, kLlWork = 32;
constexpr int kDLim = 416, kDPack = 432, kDWork = 448;
constexpr int kKindLit = 0, kKindMatch = 1;

struct Window {
  uint64_t lo, hi;  // bits 0..63 and 64..127, LSB first
  int bitcnt;
};

__device__ __forceinline__ uint32_t peek(const Window& w, int s) {
  // 32 bits from bit s (0 <= s <= 127); bits past 127 read as 0
  if (s == 0) return (uint32_t)w.lo;
  if (s < 64) return (uint32_t)((w.lo >> s) | (w.hi << (64 - s)));
  return (uint32_t)(w.hi >> (s - 64));
}

__device__ __forceinline__ void consume(Window& w, int n) {
  // an exact 128-bit right shift by n (0 <= n <= 127)
  if (n == 0) return;
  if (n < 64) {
    w.lo = (w.lo >> n) | (w.hi << (64 - n));
    w.hi >>= n;
  } else {
    w.lo = w.hi >> (n - 64);
    w.hi = 0;
  }
  w.bitcnt -= n;
}

__device__ __forceinline__ void insert(Window& w, uint32_t word) {
  // word at bit bitcnt (<= 92): it ends below bit 124
  const uint64_t x = word;
  const int b = w.bitcnt;
  if (b < 64) {
    w.lo |= x << b;
    if (b > 32) w.hi |= x >> (64 - b);
  } else {
    w.hi |= x << (b - 64);
  }
  w.bitcnt += 32;
}

__device__ __forceinline__ int rev15(uint32_t x) {
  x = ((x >> 1) & 0x5555u) | ((x & 0x5555u) << 1);
  x = ((x >> 2) & 0x3333u) | ((x & 0x3333u) << 2);
  x = ((x >> 4) & 0x0F0Fu) | ((x & 0x0F0Fu) << 4);
  x = ((x >> 8) & 0x00FFu) | ((x & 0x00FFu) << 8);
  return (int)(x >> 1);
}

// one cascade lookup: returns the work entry, sets the code length
__device__ __forceinline__ int32_t lookup(const int32_t* tab, int lim_at,
                                          int pack_at, int work_at,
                                          int work_max, const Window& w,
                                          int s, int& len) {
  const int v15 = rev15(peek(w, s) & 0x7FFFu);
  int ln = 1;
#pragma unroll
  for (int l = 1; l < 15; ++l) ln += v15 >= tab[lim_at + l];
  const int32_t pk = tab[pack_at + ln];
  const uint32_t delta = (uint32_t)(v15 - (pk & 0xFFFF)) >> (15 - ln);
  int idx = (int)((uint32_t)(pk >> 16) + delta);  // int32 wrap, as the reference
  idx = idx < 0 ? 0 : (idx > work_max ? work_max : idx);
  len = ln;
  return tab[work_at + idx];
}

__global__ void vhuff_decode(const uint32_t* __restrict__ words, int B, int Lw,
                             const int32_t* __restrict__ start_word,
                             const int32_t* __restrict__ align,
                             const int32_t* __restrict__ span,
                             const int32_t* __restrict__ tables, int S, int K,
                             int cap, int W, int32_t* __restrict__ tapeA,
                             int32_t* __restrict__ tapeB, int32_t* __restrict__ cons_out,
                             int32_t* __restrict__ bad_out,
                             int32_t* __restrict__ rem_out) {
  __shared__ int32_t tab[kTableWords];
  const int w0 = blockIdx.x * kThreads;
  const int chunk = w0 / S;
  for (int i = threadIdx.x; i < kTableWords; i += kThreads)
    tab[i] = tables[(long long)chunk * kTableWords + i];
  __syncthreads();

  const int w = w0 + threadIdx.x;
  if (w >= W) return;
  const long long wbase = (long long)chunk * Lw + start_word[w];
  const long long last_word = (long long)B * Lw - 1;
  int widx = 0;
  auto fetch = [&]() -> uint32_t {
    long long i = wbase + (widx < K - 1 ? widx : K - 1);
    i = i < 0 ? 0 : (i > last_word ? last_word : i);
    return __ldg(words + i);
  };

  Window win = {0, 0, 0};
  const int sp = span[w];
  const bool live0 = sp > 0;
  int remaining = live0 ? sp : 0;
  int cons = 0;
  bool bad = false;
  if (live0) {
    for (int r = 0; r < 4; ++r) {
      if (win.bitcnt <= 92) {
        insert(win, fetch());
        widx = min(widx + 1, K - 1);
      }
    }
    consume(win, align[w] & 31);  // a seed's bit within its word
  }

  int it = 0;
  for (; it < cap && remaining > 0 && !bad; ++it) {
    for (int r = 0; r < 3; ++r) {
      if (win.bitcnt <= 92) {
        insert(win, fetch());
        widx = min(widx + 1, K - 1);
      }
    }
    int l1, l2, l3, l4;
    const int32_t e1 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, 0, l1);
    const int32_t e2 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, l1, l2);
    const int32_t e3 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, l1 + l2, l3);
    const int32_t e4 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, l1 + l2 + l3, l4);
    const bool lit1 = (e1 >> 28) == kKindLit;
    const bool lit2 = lit1 && (e2 >> 28) == kKindLit && remaining >= 2;
    const bool lit3 = lit2 && (e3 >> 28) == kKindLit && remaining >= 3;
    const bool lit4 = lit3 && (e4 >> 28) == kKindLit && remaining >= 4;
    const int cnt = (int)lit1 + (int)lit2 + (int)lit3 + (int)lit4;
    uint32_t litreg = 0;
    int lbits = 0;
    if (lit1) { litreg |= (uint32_t)(e1 & 0xFF); lbits += l1; }
    if (lit2) { litreg |= (uint32_t)(e2 & 0xFF) << 8; lbits += l2; }
    if (lit3) { litreg |= (uint32_t)(e3 & 0xFF) << 16; lbits += l3; }
    if (lit4) { litreg |= (uint32_t)(e4 & 0xFF) << 24; lbits += l4; }

    // the match candidate: the first code after the literals taken
    const int32_t ce = cnt == 0 ? e1 : cnt == 1 ? e2 : cnt == 2 ? e3 : e4;
    const int cl = cnt == 0 ? l1 : cnt == 1 ? l2 : cnt == 2 ? l3 : l4;
    const int coff = cnt == 0 ? 0 : cnt == 1 ? l1 : cnt == 2 ? l1 + l2 : l1 + l2 + l3;
    const bool is_len = (ce >> 28) == kKindMatch;
    const bool want_m = is_len && cnt < 4 && remaining > cnt;
    const int x1 = (ce >> 20) & 0xF;
    const int length =
        (ce & 0xFFFFF) + (int)(peek(win, coff + cl) & ((1u << x1) - 1u));
    const int s_d = coff + cl + x1;
    int ld;
    const int32_t ed = lookup(tab, kDLim, kDPack, kDWork, 127, win, s_d, ld);
    const int dkind = ed >> 28;
    const int dx = (ed >> 20) & 0xF;
    const int dist = (ed & 0xFFFFF) + (int)(peek(win, s_d + ld) & ((1u << dx) - 1u));
    const bool is_match = want_m && dkind == kKindMatch;

    bool bad_now = (cnt == 0 && !is_len) || (want_m && dkind != kKindMatch);
    const int cover = cnt + (is_match ? length : 0);
    bad_now = bad_now || cover > remaining;
    const long long row = (long long)it * W + w;
    if (bad_now) {
      tapeA[row] = 0;
      tapeB[row] = 0;
      bad = true;
      ++it;
      break;
    }
    uint32_t tok_b = (uint32_t)cnt;
    if (is_match)
      tok_b |= 8u | ((uint32_t)(length - 3) << 4) | ((uint32_t)dist << 12);
    tapeA[row] = (int32_t)litreg;
    tapeB[row] = (int32_t)tok_b;
    const int n = lbits + (is_match ? cl + x1 + ld + dx : 0);
    consume(win, n);
    cons += n;
    remaining -= cover;
  }
  for (; it < cap; ++it) {
    const long long row = (long long)it * W + w;
    tapeA[row] = 0;
    tapeB[row] = 0;
  }
  cons_out[w] = cons;
  bad_out[w] = bad ? 1 : 0;
  rem_out[w] = remaining;
}

}  // namespace

extern "C" int zrs_vhuff_decode(const void* words, int B, int Lw,
                                const void* start_word, const void* align,
                                const void* span, const void* tables, int S,
                                int K, int cap, int W, void* tapeA, void* tapeB,
                                void* cons, void* bad, void* rem, void* stream) {
  if (W > 0) {
    const int blocks = (W + kThreads - 1) / kThreads;
    vhuff_decode<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, B, Lw, (const int32_t*)start_word,
        (const int32_t*)align, (const int32_t*)span, (const int32_t*)tables, S,
        K, cap, W, (int32_t*)tapeA, (int32_t*)tapeB, (int32_t*)cons,
        (int32_t*)bad, (int32_t*)rem);
  }
  return (int)cudaGetLastError();
}
