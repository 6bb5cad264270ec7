// K4 and K11a: the vector Huffman decodes, one body over two row policies.
//
// Replaces zlib_rs_tpu/ops/pallas/vhuff_kernel.py:decode_tokens_vector2
// (body _make_kernel2; entry zrs_vhuff_decode) and decode_tokens_vector
// (body _make_kernel, the engine of ZRS_VECTOR_TWOPLANE=0; entry
// zrs_vhuff_decode1). A walker starts at an encoder-recorded seed (bit
// offset, output span) of one chunk and decodes its span into tape rows;
// rows after the walker stops are zero. Outputs per walker: bits consumed
// (cons), a bad flag and the span left undecoded (rem).
//
// The two policies (TwoPlane for K4, OnePlane for K11a):
// - K4: a row holds up to three literals and the match that follows them,
//   or four literals, or a lone match: tapeA the literal bytes LSB first,
//   tapeB cnt | has << 3 | (len - 3) << 4 | dist << 12. The window is 128
//   bits: four refills and a consume of the seed's sub-word alignment at the
//   start, then three refills a row, each only where bitcnt <= 92, so at
//   least 93 bits are there (three 15-bit literals and a 48-bit match).
// - K11a: a row holds up to three literals, LIT 1 << 30 | (cnt - 1) << 24 |
//   bytes, or one match, MATCH 2 << 30 | (len - 3) << 16 | dist. The window
//   is 96 bits: three refills at the start, two a row, each where bitcnt <=
//   64. A row is bad on an invalid code, an end of block, a length without a
//   distance code, or a cover past the span left.
// A code's length is 1 + the number of 15-bit limits it reaches (the
// canonical compare cascade); its symbol is
// work[off[len] + (v15 - base15[len]) >> (15 - len)], the index clamped to
// the table as the reference clamps it. Word widx of walker w is
// words.flat[clip(chunk * Lw + start_word[w] + min(widx, K - 1), 0, B * Lw - 1)]:
// the reference's staged FIFO, read in place.
//
// Bound on the H100: bytes. Each walker reads its body words once and
// writes its rows; the decode is a few hundred integer operations a row.
// The contract's [cap, W] tapes hold zero rows past every walker's stop
// (67 MB a launch on the 8 MiB corpus), whose stores alone take 0.020 ms at
// 3.35 TB/s. The loop is serial per walker, so the decode is latency-bound:
// a row is a chain of code lookups, each starting where the last ended.
//
// Design: a block is the 128 walkers of one chunk (S % 128 == 0), with in
// shared memory:
// 1. The window of body words every fetch of the block falls in, from
//    clip(chunk * Lw + min start_word) to clip(chunk * Lw + max start_word
//    + K - 1), before clipping to the array, copied once with cp.async (16
//    bytes a copy from lo rounded down; the clipped word where an index
//    passes either end) while the tables below are built. A refill reads
//    it with one add and no clamp. A block whose window exceeds
//    the budget (only a damaged index makes one: a clean window is at most
//    Lw + K - 1 words) takes the same body with global reads; the blocks on
//    each branch are counted.
// 2. The six cascade tables, and two direct tables built from them,
//    indexed by the next 13 (K4) or 12 (K11a) literal/length and 9
//    distance stream bits. (At 10 bits, on binaries, about half of a
//    warp's lookups have a lane that needs the cascade; wider tables make
//    that rare.)
//    An entry is the work entry with the code length in its free bits
//    24-27, or 0: run the cascade. An entry is direct only where every
//    15-bit value it stands for gives the cascade's length and index: the
//    cascade's length is nondecreasing in v15, so equal lengths at the two
//    ends of the entry's range fix it; and when that length is at most the
//    index width and the low 15 - len bits of base15[len] are zero (as in
//    every canonical table) the index is fixed too. A work entry with bits
//    in 24-27 stays on the cascade. So any table, corrupt ones included,
//    decodes exactly as the cascade decodes it.
// 3. A row's refills read their (up to 3) words at once and place them at
//    once, since the refills taken are a prefix; literal/length codes, at
//    most three before the last one, are peeked from the low register;
//    K11a's literal and match lookups both run every row (a literal's
//    distance lookup sits at the second code's bit), so a warp does not
//    run two paths.
// 4. Each walker writes its rows and the row that ends it, then its rows up
//    to its warp's last; the rest of the warp's rows, to cap, go as 16-byte
//    stores, 8 lanes a row of 32 columns. (Zeroing a few rows of its own
//    column from the top with each decoded row, to spread these stores
//    over the decode, measured slower: the stores hold up the decode.)
// C leaves shifts by 32 or more undefined where the TPU code uses clamps
// and selects: each shift below is by less than the register width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTableWords = 576;
constexpr int kLlLim = 0, kLlPack = 16, kLlWork = 32;
constexpr int kDLim = 416, kDPack = 432, kDWork = 448;
constexpr int kLlMax = 383, kDMax = 127;  // the work tables' last index
constexpr int kKindLit = 0, kKindMatch = 1;
constexpr uint32_t kTokLit = 1u << 30, kTokMatch = 2u << 30;
constexpr int kDBits = 9;  // the distance table's index width (a policy sets the other)
constexpr int kLenField = 0xF << 24;
constexpr int kMaxStageWords = 44 * 1024;  // 176 KiB of staged body at most

// ints of shared memory before the staged window: the cascade tables and
// the direct tables (a 16-byte multiple, so the window starts aligned)
template <class P>
__host__ __device__ constexpr int tab_smem() {
  return kTableWords + (1 << P::kLlBits) + (1 << kDBits);
}

// blocks on the staged and on the global branch since the last read
__device__ unsigned long long g_blocks[2];

struct Window {
  uint64_t lo, hi;  // bits 0..63 and 64..127, LSB first
  int bitcnt;
};

// The window's operations are branch-free: selects and funnel shifts, so
// that a warp's lanes, whatever their bit counts, run one path.

__device__ __forceinline__ uint32_t peek(const Window& w, int s) {
  // 32 bits from bit s (0 <= s <= 127); bits past 127 read as 0
  const uint64_t a = s < 64 ? w.lo : w.hi;
  const uint64_t b = s < 64 ? w.hi : 0;
  const int r = s & 63;
  return r < 32 ? __funnelshift_r((uint32_t)a, (uint32_t)(a >> 32), r)
                : __funnelshift_r((uint32_t)(a >> 32), (uint32_t)b, r);
}

__device__ __forceinline__ uint32_t peek_lo(const Window& w, int s) {
  // 32 bits from bit s of the low register (0 <= s <= 63): a code of up to
  // 15 bits at s <= 49 is whole
  return (uint32_t)(w.lo >> s);
}

__device__ __forceinline__ void consume(Window& w, int n) {
  // an exact 128-bit right shift by n (0 <= n <= 127)
  const int r = n & 63;
  const uint64_t lo = (w.lo >> r) | ((w.hi << 1) << (63 - r)), hi = w.hi >> r;
  w.lo = n < 64 ? lo : hi;
  w.hi = n < 64 ? hi : 0;
  w.bitcnt -= n;
}

__device__ __forceinline__ int rev15(uint32_t x) {
  x = ((x >> 1) & 0x5555u) | ((x & 0x5555u) << 1);
  x = ((x >> 2) & 0x3333u) | ((x & 0x3333u) << 2);
  x = ((x >> 4) & 0x0F0Fu) | ((x & 0x0F0Fu) << 4);
  x = ((x >> 8) & 0x00FFu) | ((x & 0x00FFu) << 8);
  return (int)(x >> 1);
}

// the cascade's work index of v15 at code length ln, clamped
__device__ __forceinline__ int work_index(int32_t pk, int v15, int ln, int work_max) {
  const uint32_t delta = (uint32_t)(v15 - (pk & 0xFFFF)) >> (15 - ln);
  const int idx = (int)((uint32_t)(pk >> 16) + delta);  // int32 wrap, as the reference
  return idx < 0 ? 0 : (idx > work_max ? work_max : idx);
}

struct Code {
  int32_t e;  // the work entry
  int len;
};

// one cascade lookup of the 15 bits p, off the direct path
__device__ __noinline__ Code cascade(const int32_t* tab, int lim_at, int pack_at, int work_at,
                                     int work_max, uint32_t p) {
  const int v15 = rev15(p & 0x7FFFu);
  int ln = 1;
#pragma unroll
  for (int l = 1; l < 15; ++l) ln += v15 >= tab[lim_at + l];
  return {tab[work_at + work_index(tab[pack_at + ln], v15, ln, work_max)], ln};
}

// one alphabet's 14 limits in ascending order, at sorted[1..14], and
// sorted[15] = INT_MAX: the cascade's length of v is the least l with
// sorted[l] > v. Thread l - 1 of a warp places limit l by its rank.
__device__ __forceinline__ void sort_limits(const int32_t* tab, int lim_at, int* sorted) {
  const int l = (threadIdx.x & 31) + 1;
  if (l < 15) {
    const int v = tab[lim_at + l];
    int rank = 1;
#pragma unroll
    for (int m = 1; m < 15; ++m) {
      const int u = tab[lim_at + m];
      rank += u < v || (u == v && m < l);
    }
    sorted[rank] = v;
  } else if (l == 15) {
    sorted[15] = 0x7FFFFFFF;
  }
}

// the direct table of one alphabet: entry i stands for the 15-bit values
// v0..v0 + 2^(15 - kBits) - 1 whose first kBits stream bits are i (v0 the
// bit reversal of i, shifted up). Each thread takes a run of consecutive v0
// and keeps the length of its v0 as it climbs the sorted limits; the length
// holds over the entry's range when the next limit lies past its end. The
// lanes of a warp take runs whose top 5 bits differ, so that their stores
// to bit-reversed places fall in 32 banks.
template <int kBits>
__device__ void build_direct(const int32_t* tab, const int* sorted, int pack_at, int work_at,
                             int work_max, int32_t* out) {
  constexpr int kPer = (1 << kBits) / kThreads, kStep = 1 << (15 - kBits);
  const int m0 = (threadIdx.x & 31) * ((1 << kBits) / 32) + (threadIdx.x >> 5) * kPer;
  int l = 1, next = sorted[1], pk = 0;
  bool fits = false;  // l <= kBits and base15[l]'s low 15 - l bits are zero
#pragma unroll 4
  for (int j = 0; j < kPer; ++j) {
    const int v0 = (m0 + j) * kStep;
    if (v0 >= next || j == 0) {
      while (v0 >= next) next = sorted[++l];
      pk = tab[pack_at + l];
      fits = l <= kBits && (pk & ((1 << (15 - l)) - 1)) == 0;
    }
    int32_t entry = 0;
    if (fits && next > v0 + kStep - 1) {
      const int32_t e = tab[work_at + work_index(pk, v0, l, work_max)];
      if ((e & kLenField) == 0) entry = e | (l << 24);
    }
    out[__brev((uint32_t)(m0 + j)) >> (32 - kBits)] = entry;
  }
}

struct Tables {
  const int32_t* tab;  // the six cascade tables
  const int32_t* ll;   // direct literal/length table, ll_mask + 1 entries
  const int32_t* d;    // direct distance table, 1 << kDBits entries
  uint32_t ll_mask;
};

// a literal/length code at bit s <= 49 (after at most three codes)
__device__ __forceinline__ int32_t litlen(const Tables& t, const Window& w, int s, int& len) {
  const uint32_t p = peek_lo(w, s);
  const int32_t e = t.ll[p & t.ll_mask];
  if (__builtin_expect(e != 0, 1)) {
    len = (e >> 24) & 0xF;
    return e & ~kLenField;
  }
  const Code c = cascade(t.tab, kLlLim, kLlPack, kLlWork, kLlMax, p);
  len = c.len;
  return c.e;
}

__device__ __forceinline__ int32_t dist(const Tables& t, const Window& w, int s, int& len) {
  const uint32_t p = peek(w, s);
  const int32_t e = t.d[p & ((1u << kDBits) - 1)];
  if (__builtin_expect(e != 0, 1)) {
    len = (e >> 24) & 0xF;
    return e & ~kLenField;
  }
  const Code c = cascade(t.tab, kDLim, kDPack, kDWork, kDMax, p);
  len = c.len;
  return c.e;
}

__device__ __forceinline__ uint32_t low_bits(uint32_t x, int n) {
  return x & ((1u << n) - 1u);  // n <= 15
}

// one decoded row: its tape words, the bits it consumes and the bytes it covers
struct Row {
  uint32_t a, b;
  int n, cover;
  bool bad;
};

// K4: up to three literals and the match after them, or four literals
struct TwoPlane {
  static constexpr int kStartRefills = 4, kRowRefills = 3, kRefillAt = 92;
  // the literal/length table's index width: 13 bits measured faster than
  // 12 here (five lookups a row), slower for OnePlane (its build weighs more)
  static constexpr int kLlBits = 13;
  int32_t* tapeA;
  int32_t* tapeB;

  __device__ __forceinline__ static Row decode(const Tables& t, const Window& win,
                                               int remaining) {
    int l1, l2, l3, l4;
    const int32_t e1 = litlen(t, win, 0, l1);
    const int32_t e2 = litlen(t, win, l1, l2);
    const int32_t e3 = litlen(t, win, l1 + l2, l3);
    const int32_t e4 = litlen(t, win, l1 + l2 + l3, l4);
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
    const int length = (ce & 0xFFFFF) + (int)low_bits(peek(win, coff + cl), x1);
    const int s_d = coff + cl + x1;
    int ld;
    const int32_t ed = dist(t, win, s_d, ld);
    const int dkind = ed >> 28;
    const int dx = (ed >> 20) & 0xF;
    const int dst = (ed & 0xFFFFF) + (int)low_bits(peek(win, s_d + ld), dx);
    const bool is_match = want_m && dkind == kKindMatch;

    Row r;
    r.cover = cnt + (is_match ? length : 0);
    r.bad = (cnt == 0 && !is_len) || (want_m && dkind != kKindMatch) || r.cover > remaining;
    r.a = litreg;
    r.b = (uint32_t)cnt |
          (is_match ? 8u | ((uint32_t)(length - 3) << 4) | ((uint32_t)dst << 12) : 0u);
    r.n = lbits + (is_match ? cl + x1 + ld + dx : 0);
    return r;
  }

  __device__ __forceinline__ void put(long long i, const Row& r) const {
    tapeA[i] = (int32_t)r.a;
    tapeB[i] = (int32_t)r.b;
  }
  __device__ __forceinline__ void zero(long long i) const {
    tapeA[i] = 0;
    tapeB[i] = 0;
  }
  __device__ __forceinline__ void zero4(long long i) const {
    *reinterpret_cast<int4*>(tapeA + i) = make_int4(0, 0, 0, 0);
    *reinterpret_cast<int4*>(tapeB + i) = make_int4(0, 0, 0, 0);
  }
};

// K11a: up to three literals, or one match
struct OnePlane {
  static constexpr int kStartRefills = 3, kRowRefills = 2, kRefillAt = 64;
  static constexpr int kLlBits = 12;
  int32_t* tape;

  __device__ __forceinline__ static Row decode(const Tables& t, const Window& win,
                                               int remaining) {
    int l1, l2, l3, ld;
    const int32_t e1 = litlen(t, win, 0, l1);
    const int kind1 = e1 >> 28;
    // the match's length extra and distance code, and the next literals'
    // codes, both every row
    const int x1 = (e1 >> 20) & 0xF;
    const int s_d = l1 + x1;
    const int32_t ed = dist(t, win, s_d, ld);
    const int32_t e2 = litlen(t, win, l1, l2);
    const int32_t e3 = litlen(t, win, l1 + l2, l3);
    const int length = (e1 & 0xFFFFF) + (int)low_bits(peek(win, l1), x1);
    const int dx = (ed >> 20) & 0xF;
    const int dst = (ed & 0xFFFFF) + (int)low_bits(peek(win, s_d + ld), dx);

    const bool lit = kind1 == kKindLit;
    const bool take2 = lit && (e2 >> 28) == kKindLit && remaining >= 2;
    const bool take3 = take2 && (e3 >> 28) == kKindLit && remaining >= 3;
    const bool match = kind1 == kKindMatch && (ed >> 28) == kKindMatch;
    const int cnt = 1 + (int)take2 + (int)take3;
    const uint32_t litreg = (uint32_t)(e1 & 0xFF) | (take2 ? (uint32_t)(e2 & 0xFF) << 8 : 0u) |
                            (take3 ? (uint32_t)(e3 & 0xFF) << 16 : 0u);

    Row r;
    r.cover = lit ? cnt : length;
    r.bad = !(lit || match) || r.cover > remaining;
    r.a = lit ? kTokLit | (uint32_t)(cnt - 1) << 24 | litreg
              : kTokMatch | (uint32_t)(length - 3) << 16 | (uint32_t)dst;
    r.b = 0;
    r.n = lit ? l1 + (take2 ? l2 : 0) + (take3 ? l3 : 0) : s_d + ld + dx;
    return r;
  }

  __device__ __forceinline__ void put(long long i, const Row& r) const { tape[i] = (int32_t)r.a; }
  __device__ __forceinline__ void zero(long long i) const { tape[i] = 0; }
  __device__ __forceinline__ void zero4(long long i) const {
    *reinterpret_cast<int4*>(tape + i) = make_int4(0, 0, 0, 0);
  }
};

// a walker's words (widx <= K - 1): the block's staged window, which holds
// words[clip(i, 0, last)] at i - sb for every i its walkers reach
struct Staged {
  const uint32_t* stage;  // from word sb of the body array
  int at;                 // wbase - sb

  __device__ __forceinline__ uint32_t fetch(int widx) const { return stage[at + widx]; }
};

// or the body array in place
struct InPlace {
  const uint32_t* words;
  long long wbase, last;

  __device__ __forceinline__ uint32_t fetch(int widx) const {
    long long i = wbase + widx;
    return __ldg(words + (i < 0 ? 0 : (i > last ? last : i)));
  }
};

struct Walked {
  int it, cons, remaining;  // rows [0, it) written
  bool bad;
};

// up to kRefills refills of the window, each only where bitcnt <=
// kRefillAt: the refills taken are a prefix, n of them, so the n words are
// read at once and placed at once, as one chunk at bit bitcnt (it ends
// below bit 124)
template <int kRefills, int kRefillAt, class Src>
__device__ __forceinline__ void refill(Window& win, int& widx, int kmax, const Src& src) {
  static_assert(kRefills <= 4, "a chunk of at most 128 bits");
  const int b = win.bitcnt;
  const int n = b > kRefillAt ? 0 : min(kRefills, ((kRefillAt - b) >> 5) + 1);
  uint64_t c[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < kRefills; ++i) {
    const uint64_t x = src.fetch(min(widx + i, kmax));
    c[i >> 1] |= (i < n ? x : 0) << (32 * (i & 1));
  }
  const int r = b & 63;
  const uint64_t sl = c[0] << r, sh = (c[1] << r) | ((c[0] >> 1) >> (63 - r));
  win.lo |= b < 64 ? sl : 0;
  win.hi |= b < 64 ? sh : sl;
  win.bitcnt = b + 32 * n;
  widx = min(widx + n, kmax);
}

template <class P, class Src>
__device__ __forceinline__ Walked walk(const Src& src, int K, const Tables& t, const P& out,
                                       int align, int sp, int cap, int W, int w) {
  Window win = {0, 0, 0};
  int widx = 0;
  const bool live0 = sp > 0;
  Walked r = {0, 0, live0 ? sp : 0, false};
  const int kmax = K - 1;
  if (live0) {
    refill<P::kStartRefills, P::kRefillAt>(win, widx, kmax, src);
    consume(win, align & 31);  // a seed's bit within its word
  }
  for (; r.it < cap && r.remaining > 0 && !r.bad; ++r.it) {
    refill<P::kRowRefills, P::kRefillAt>(win, widx, kmax, src);
    const Row row = P::decode(t, win, r.remaining);
    const long long at = (long long)r.it * W + w;
    if (row.bad) {
      out.zero(at);
      r.bad = true;
      continue;  // ++it: the row that ends the walker is written
    }
    out.put(at, row);
    consume(win, row.n);
    r.cons += row.n;
    r.remaining -= row.cover;
  }
  return r;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <class P>
__global__ void __launch_bounds__(kThreads)
vhuff_decode(const uint32_t* __restrict__ words, int B, int Lw,
             const int32_t* __restrict__ start_word, const int32_t* __restrict__ align,
             const int32_t* __restrict__ span, const int32_t* __restrict__ tables, int S,
             int K, int cap, int W, int stage_words, P out, int32_t* __restrict__ cons_out,
             int32_t* __restrict__ bad_out, int32_t* __restrict__ rem_out) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* tab = smem;
  int32_t* ll = tab + kTableWords;
  int32_t* dd = ll + (1 << P::kLlBits);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + tab_smem<P>());
  __shared__ int s_min[kThreads / 32], s_max[kThreads / 32], s_sorted[2][16];

  const int tid = threadIdx.x, lane = tid & 31;
  const int w = blockIdx.x * kThreads + tid;
  const int chunk = blockIdx.x * kThreads / S;
  for (int i = tid; i < kTableWords; i += kThreads)
    tab[i] = tables[(long long)chunk * kTableWords + i];
  const int sw = start_word[w];
  const int mn = __reduce_min_sync(0xFFFFFFFFu, sw), mx = __reduce_max_sync(0xFFFFFFFFu, sw);
  if (lane == 0) {
    s_min[tid >> 5] = mn;
    s_max[tid >> 5] = mx;
  }
  __syncthreads();

  // the block's window of body words, staged when it fits
  int bmin = s_min[0], bmax = s_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) {
    bmin = min(bmin, s_min[i]);
    bmax = max(bmax, s_max[i]);
  }
  const long long last = (long long)B * Lw - 1;
  const long long base = (long long)chunk * Lw;
  // every index a walker of the block reaches, before clipping to the array
  const long long lo = base + bmin, hi = base + bmax + K - 1;
  const bool staged = hi - lo + 1 <= stage_words;
  // staged from sb (lo, rounded down to 16 bytes where the array is aligned
  // and lo inside it): 16-byte copies of the groups inside the array, 4-byte
  // copies of the clipped word at the rest
  const bool vec = (reinterpret_cast<uintptr_t>(words) & 15) == 0 && lo >= 0;
  const long long sb = vec ? lo & ~3ll : lo;
  if (staged) {
    long long q0 = 0, q1 = 0;  // 16-byte groups [q0, q1)
    if (vec) {
      q0 = sb >> 2;
      q1 = max(q0, ((hi < last ? hi : last) + 1) >> 2);
    }
    for (long long q = q0 + tid; q < q1; q += kThreads)
      cp_async16(stage + (4 * q - sb), words + 4 * q);
    for (long long i = (vec ? 4 * q1 : sb) + tid; i <= hi; i += kThreads)
      cp_async4(stage + (i - sb), words + (i < 0 ? 0 : (i > last ? last : i)));
  }
  if (tid < 32)
    sort_limits(tab, kLlLim, s_sorted[0]);
  else if (tid < 64)
    sort_limits(tab, kDLim, s_sorted[1]);
  __syncthreads();
  build_direct<P::kLlBits>(tab, s_sorted[0], kLlPack, kLlWork, kLlMax, ll);
  build_direct<kDBits>(tab, s_sorted[1], kDPack, kDWork, kDMax, dd);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) atomicAdd(&g_blocks[staged ? 0 : 1], 1ull);

  const Tables t = {tab, ll, dd, (1u << P::kLlBits) - 1};
  const long long wbase = base + sw;
  Walked r;
  if (staged) {
    const Staged src = {stage, (int)(wbase - sb)};
    r = walk<P>(src, K, t, out, align[w], span[w], cap, W, w);
  } else {
    const InPlace src = {words, wbase, last};
    r = walk<P>(src, K, t, out, align[w], span[w], cap, W, w);
  }

  // zero rows: this walker's up to its warp's last row, then the warp's
  // 32 columns to cap as 16-byte stores, 8 lanes a row
  const int warp_end = __reduce_max_sync(0xFFFFFFFFu, r.it);
  for (int it = r.it; it < warp_end; ++it) out.zero((long long)it * W + w);
  const long long col = (long long)(w - lane) + 4 * (lane & 7);
  for (int it = warp_end + (lane >> 3); it < cap; it += 4) out.zero4((long long)it * W + col);
  cons_out[w] = r.cons;
  bad_out[w] = r.bad ? 1 : 0;
  rem_out[w] = r.remaining;
}

template <class P>
int launch(const void* words, int B, int Lw, const void* start_word, const void* align,
           const void* span, const void* tables, int S, int K, int cap, int W, P out,
           void* cons, void* bad, void* rem, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  if (S <= 0 || S % kThreads || W != B * S || K < 1 || K > (1 << 29) || cap < 1 || Lw < 1)
    return (int)cudaErrorInvalidValue;
  long long want = (long long)Lw + K;  // a clean window's bound
  const int stage_words = (int)(want < kMaxStageWords ? want : kMaxStageWords);
  static_assert(tab_smem<P>() % 4 == 0, "the staged window starts 16-byte aligned");
  const int bytes = (tab_smem<P>() + stage_words + 4) * (int)sizeof(int32_t);  // + 3 to round lo down
  cudaError_t e = cudaFuncSetAttribute(vhuff_decode<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  vhuff_decode<P><<<W / kThreads, kThreads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, Lw, (const int32_t*)start_word, (const int32_t*)align,
      (const int32_t*)span, (const int32_t*)tables, S, K, cap, W, stage_words, out,
      (int32_t*)cons, (int32_t*)bad, (int32_t*)rem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zrs_vhuff_decode(const void* words, int B, int Lw, const void* start_word,
                                const void* align, const void* span, const void* tables, int S,
                                int K, int cap, int W, void* tapeA, void* tapeB, void* cons,
                                void* bad, void* rem, void* stream) {
  const TwoPlane out = {(int32_t*)tapeA, (int32_t*)tapeB};
  return launch(words, B, Lw, start_word, align, span, tables, S, K, cap, W, out, cons, bad,
                rem, stream);
}

extern "C" int zrs_vhuff_decode1(const void* words, int B, int Lw, const void* start_word,
                                 const void* align, const void* span, const void* tables, int S,
                                 int K, int cap, int W, void* tape, void* cons, void* bad,
                                 void* rem, void* stream) {
  const OnePlane out = {(int32_t*)tape};
  return launch(words, B, Lw, start_word, align, span, tables, S, K, cap, W, out, cons, bad,
                rem, stream);
}

// the blocks that took the staged and the global branch, over every launch
// of either entry since the last call (synchronous); the counts restart at 0
extern "C" int zrs_vhuff_decode_blocks(void* host2) {
  cudaError_t e = cudaMemcpyFromSymbol(host2, g_blocks, sizeof(g_blocks));
  const unsigned long long z[2] = {0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_blocks, z, sizeof(z));
  return (int)e;
}
