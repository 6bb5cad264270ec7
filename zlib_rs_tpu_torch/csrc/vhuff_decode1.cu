// K11a: the single-plane vector Huffman decode, one thread per walker.
//
// Replaces zlib_rs_tpu/ops/pallas/vhuff_kernel.py:decode_tokens_vector
// (body _make_kernel), the engine of ZRS_VECTOR_TWOPLANE=0. A walker starts
// at an encoder-recorded seed (bit offset, output span) of one chunk and
// decodes its span into one tape row a step: up to three literals, or one
// match. Token words: LIT 1 << 30 | (cnt - 1) << 24 | bytes (LSB first),
// MATCH 2 << 30 | (len - 3) << 16 | dist; 0 for a walker that does not emit,
// so every row after a walker stops is zero. Outputs per walker: bits
// consumed (cons), a bad flag and the span left undecoded (rem).
//
// The reference's window is 96 bits: three refills and a consume of the
// seed's sub-word alignment at the start, then two refills a step, each
// only where bitcnt <= 64, so at least 65 bits are there before every step
// (the largest step: a 15-bit length code, 5 extra bits, a 15-bit distance
// code and 13 extra bits, 48 bits). A step is bad on an invalid code, an end
// of block, a length without a distance code, or a cover past the span
// left. A code's length is 1 + the number of 15-bit limits it reaches (the
// canonical compare cascade); its symbol is
// work[off[len] + (v15 - base15[len]) >> (15 - len)], the index clamped to
// the table as the reference clamps it.
//
// Bound on the H100: bytes. Each walker reads its body words once and
// writes its used tape rows; the decode is a few hundred integer operations
// a row, far below the card's rate. The loop is serial per walker, so the
// kernel is latency-bound in practice.
//
// Design, as K4 (csrc/vhuff_decode.cu): 128 walkers of one chunk (S % 128
// == 0) form a block, which holds the chunk's six cascade tables (576 ints)
// in shared memory; the window lives in two 64-bit registers (bits past 96
// stay zero); the tape is row-major [cap, W], so row t of a warp's walkers
// is one coalesced store. Every word read is clamped to the body array as
// the reference's staged FIFO clamps it, and every shift is by less than
// the register width (C leaves wider shifts undefined, where the TPU code
// splits them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTableWords = 576;
constexpr int kLlLim = 0, kLlPack = 16, kLlWork = 32;
constexpr int kDLim = 416, kDPack = 432, kDWork = 448;
constexpr int kKindLit = 0, kKindMatch = 1;
constexpr uint32_t kTokLit = 1u << 30, kTokMatch = 2u << 30;

struct Window {
  uint64_t lo, hi;  // bits 0..63 and 64..127, LSB first
  int bitcnt;
};

__device__ __forceinline__ uint32_t peek(const Window& w, int s) {
  // 32 bits from bit s (0 <= s <= 63)
  if (s == 0) return (uint32_t)w.lo;
  return (uint32_t)((w.lo >> s) | (w.hi << (64 - s)));
}

__device__ __forceinline__ void consume(Window& w, int n) {
  // an exact right shift by n (0 <= n <= 63)
  if (n == 0) return;
  w.lo = (w.lo >> n) | (w.hi << (64 - n));
  w.hi >>= n;
  w.bitcnt -= n;
}

__device__ __forceinline__ void insert(Window& w, uint32_t word) {
  // word at bit bitcnt (<= 64): it ends at or below bit 96
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

__global__ void vhuff_decode1(const uint32_t* __restrict__ words, int B, int Lw,
                              const int32_t* __restrict__ start_word,
                              const int32_t* __restrict__ align,
                              const int32_t* __restrict__ span,
                              const int32_t* __restrict__ tables, int S, int K,
                              int cap, int W, int32_t* __restrict__ tape,
                              int32_t* __restrict__ cons_out,
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
  Window win = {0, 0, 0};
  auto refill = [&]() {
    if (win.bitcnt > 64) return;
    long long i = wbase + (widx < K - 1 ? widx : K - 1);
    i = i < 0 ? 0 : (i > last_word ? last_word : i);
    insert(win, __ldg(words + i));
    widx = min(widx + 1, K - 1);
  };

  const int sp = span[w];
  const bool live0 = sp > 0;
  int remaining = live0 ? sp : 0;
  int cons = 0;
  bool bad = false;
  if (live0) {
    for (int r = 0; r < 3; ++r) refill();
    consume(win, align[w] & 31);  // a seed's bit within its word
  }

  int it = 0;
  for (; it < cap && remaining > 0 && !bad; ++it) {
    refill();
    refill();
    int l1, l2, l3, ld;
    const int32_t e1 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, 0, l1);
    const int kind1 = e1 >> 28;
    const long long row = (long long)it * W + w;
    uint32_t tok = 0;
    int n = 0, cover = 0;
    if (kind1 == kKindLit) {
      // up to two more literals, while the span allows
      const int32_t e2 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, l1, l2);
      const int32_t e3 = lookup(tab, kLlLim, kLlPack, kLlWork, 383, win, l1 + l2, l3);
      const bool take2 = (e2 >> 28) == kKindLit && remaining >= 2;
      const bool take3 = take2 && (e3 >> 28) == kKindLit && remaining >= 3;
      cover = 1 + (int)take2 + (int)take3;
      uint32_t litreg = (uint32_t)(e1 & 0xFF);
      n = l1;
      if (take2) { litreg |= (uint32_t)(e2 & 0xFF) << 8; n += l2; }
      if (take3) { litreg |= (uint32_t)(e3 & 0xFF) << 16; n += l3; }
      tok = kTokLit | (uint32_t)(cover - 1) << 24 | litreg;
    } else if (kind1 == kKindMatch) {
      // length extra, distance code and distance extra, all this step
      const int x1 = (e1 >> 20) & 0xF;
      const int length = (e1 & 0xFFFFF) + (int)(peek(win, l1) & ((1u << x1) - 1u));
      const int s_d = l1 + x1;
      const int32_t ed = lookup(tab, kDLim, kDPack, kDWork, 127, win, s_d, ld);
      if ((ed >> 28) != kKindMatch) {
        bad = true;
      } else {
        const int dx = (ed >> 20) & 0xF;
        const int dist = (ed & 0xFFFFF) + (int)(peek(win, s_d + ld) & ((1u << dx) - 1u));
        cover = length;
        n = s_d + ld + dx;
        tok = kTokMatch | (uint32_t)(length - 3) << 16 | (uint32_t)dist;
      }
    } else {  // an invalid code or an end of block
      bad = true;
    }
    if (!bad && cover > remaining) bad = true;
    if (bad) {
      tape[row] = 0;
      ++it;
      break;
    }
    tape[row] = (int32_t)tok;
    consume(win, n);
    cons += n;
    remaining -= cover;
  }
  for (; it < cap; ++it) tape[(long long)it * W + w] = 0;
  cons_out[w] = cons;
  bad_out[w] = bad ? 1 : 0;
  rem_out[w] = remaining;
}

}  // namespace

extern "C" int zrs_vhuff_decode1(const void* words, int B, int Lw,
                                 const void* start_word, const void* align,
                                 const void* span, const void* tables, int S,
                                 int K, int cap, int W, void* tape, void* cons,
                                 void* bad, void* rem, void* stream) {
  if (W > 0) {
    const int blocks = (W + kThreads - 1) / kThreads;
    vhuff_decode1<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, B, Lw, (const int32_t*)start_word,
        (const int32_t*)align, (const int32_t*)span, (const int32_t*)tables, S,
        K, cap, W, (int32_t*)tape, (int32_t*)cons, (int32_t*)bad,
        (int32_t*)rem);
  }
  return (int)cudaGetLastError();
}
