// The body of a coded deflate block decoded by a whole thread block, shared
// by IS (istream.cu, bytes into a stream handle's output) and SP2
// (speculative.cu, u16 cells with markers into a row).
//
// A head warp (the includer's, Head below) runs native's control flow and
// hands the block a coded body at a known litlen-code start with more than
// kMargin + kMinBody bits of input left (Body's hand-off fields: bp, op,
// nbits, base, cap, reach, last, gen). body() decodes one window of up to
// 32 KiB of input:
// - build_lut: a compact table in shared memory (roots 10 and 8, a
//   canonical walk for longer codes; a hole of an incomplete code decodes
//   as bad) from the code lengths the head kept (litlen [0, 288), distance
//   [288, 320)), once a generation;
// - the window's words staged with cp.async, zero past the input;
// - the sync decode: sub-ranges of L bits, one a thread, each decoded from
//   its start as though a litlen code began there, marking every litlen
//   start it passes; in rounds, a sub-range whose entry changed decodes
//   again until it lands on a start its first pass marked (after
//   kMaxRounds thread 0 finishes alone), so the result is exact;
// - scan_counts and expand: each confirmed token's output position, the
//   literals, a pointer a match cell to its source, pointer jumping, the
//   cells. The first token that is bad, points past op + reach (the
//   far-back limit), does not fit cap or starts within kMargin bits of the
//   input's end ends the window before it (no_par: the head decodes on);
//   one that passes kPtrCap cells ends it too (the next window goes on).
// The cell type is the policy: bytes (IS, history before op in the output
// buffer) or u16 (SP2: a cell whose source lies before out[0] is the
// marker 256 + back - 1, and need_max takes the window's deepest reach).
// A head with kSpeculates parses the next block's header while the other
// warps expand a window that ends at its EOB (IS's Inflater).
//
// Without __CUDACC__ everything compiles as host C++, the threads of a
// block run in turn (tid 0 of 1), so the CPU tests run this code.
#pragma once

#include <climits>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#define IS_DEV __device__
#define IS_INL __device__ __forceinline__
#define IS_CONST __constant__
#define IS_UNROLL _Pragma("unroll")
#else
#define IS_DEV
#define IS_INL inline
#define IS_CONST static const
#define IS_UNROLL
#endif

namespace {

constexpr int M_HEAD = 0, M_STORED = 1, M_CODED = 2, M_DONE = 3, M_ERR = -1;
// table entry (native's): bits 0-15 payload, 16-21 bits, 22-27 aux, 28-31 kind
constexpr int K_LIT = 0, K_MATCH = 1, K_EOB = 2, K_SUB = 3, K_BAD = 4, K_LONG = 5;

// the block's launch
constexpr int kThreads = 1024;  // threads, and sub-ranges a window at most
constexpr int kMargin = 64;     // bits the tail keeps: 15 + 5 + 15 + 13 rounded up
// bits past the margin below which the head decodes alone: the block's
// body costs more than one warp's serial decode up to about 150 bytes of
// fresh input (stream_probe.py's small pumps, PERF.md §6)
constexpr int kMinBody = 1024;
constexpr int kStageWords = 8192;  // a window's input: 32 KiB
constexpr int kStagePad = 8;       // words past the window: a token's last bits
constexpr int kLmin = 128, kLmax = kStageWords * 32 / kThreads;  // the adaptive sub-range, bits
constexpr int kMaxRounds = 32;
constexpr int kPtrCap = 1 << 18;  // output bytes a window expands at most: the scratch, int32
constexpr int kLlBits = 10, kDBits = 8;  // the compact table's roots
constexpr int kBlockCopy = 256;  // stored bytes the whole block copies
constexpr int A_STOP = 0, A_BODY = 1, A_COPY = 2;
constexpr int X_NEXT = 0, X_EOB = 1, X_BAD = 2;  // a walk's end
constexpr int V_FAR = 1, V_ROOM = 2, V_WIN = 3, V_BAD = 4;  // why a window ends before a token
// stats, int64 a field
enum {
  S_WINDOWS, S_ROUNDS, S_MAX_ROUNDS, S_SERIAL, S_JUMPS, S_MAX_JUMPS, S_NS_HEAD, S_NS_SYNC,
  S_NS_EXPAND, S_COPIES, S_BODY_OUT, S_BODY_BITS, S_LUTS, S_NS_WRITE, S_NS_SPEC, S_SPECS,
  kStats = 16
};

IS_CONST int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                             31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
IS_CONST int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                              2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
IS_CONST int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                              33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                              1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
IS_CONST int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                               6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
IS_CONST int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

IS_INL uint32_t mk_entry(int kind, int aux, int nbits, int payload) {
  return ((uint32_t)kind << 28) | ((uint32_t)aux << 22) | ((uint32_t)nbits << 16) |
         (uint32_t)payload;
}
IS_INL uint32_t low_bits(uint32_t v, int n) { return n ? v & ((1u << n) - 1u) : 0u; }

IS_INL uint32_t sym_entry(int alphabet, int s, int nbits_) {
  if (alphabet == 0) {
    if (s < 256) return mk_entry(K_LIT, 0, nbits_, s);
    if (s == 256) return mk_entry(K_EOB, 0, nbits_, 0);
    const int c = s - 257;
    if (c >= 29) return mk_entry(K_BAD, 0, nbits_, 0);
    return mk_entry(K_MATCH, kLenExtra[c], nbits_, kLenBase[c]);
  }
  if (alphabet == 1) {
    if (s >= 30) return mk_entry(K_BAD, 0, nbits_, 0);
    return mk_entry(K_MATCH, kDistExtra[s], nbits_, kDistBase[s]);
  }
  return mk_entry(K_LIT, 0, nbits_, s);
}

IS_INL void warp_sync() {
#ifdef __CUDACC__
  __syncwarp();
#endif
}

IS_INL void block_sync() {
#ifdef __CUDACC__
  __syncthreads();
#endif
}

// a barrier of the `count` threads that expand a window (all of them, or
// all but the head warp while it parses the next header)
IS_INL void part_sync(int count) {
#ifdef __CUDACC__
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
#else
  (void)count;
#endif
}

IS_INL int warp_max(int v) {
#ifdef __CUDACC__
  for (int o = 16; o; o >>= 1) {
    const int y = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = v > y ? v : y;
  }
#endif
  return v;
}

IS_INL uint32_t bit_reverse(uint32_t v, int n) {
#ifdef __CUDACC__
  return __brev(v) >> (32 - n);
#else
  uint32_t r = 0;
  for (int i = 0; i < n; i++) {
    r = (r << 1) | (v & 1u);
    v >>= 1;
  }
  return r;
#endif
}

IS_INL long long now_ns() {
#ifdef __CUDACC__
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
#else
  return 0;
#endif
}

// the block's body state (dynamic shared memory on the card)
struct Body {
  uint32_t stage[kStageWords + kStagePad];  // the window's input words
  uint32_t marks[kStageWords + kStagePad];  // litlen starts of the first passes
  uint32_t ll[1 << kLlBits];                // compact litlen table
  uint32_t d[1 << kDBits];                  // compact distance table
  int32_t first[kThreads];  // a sub-range's first-pass exit; later its refused token
  int32_t cur[kThreads];    // its exit from its current entry
  int32_t used[kThreads];   // the entry it was computed from
  int32_t inb[kThreads];    // a round's entries; later the refused token's output
  int32_t cnt[kThreads];    // its tokens' output, then their exclusive offsets
  int32_t need[kThreads];   // u16 cells: its confirmed tokens' deepest reach before the output
  int32_t wsum[32];
  uint16_t sorted[320];  // symbols in canonical order: litlen [0, 288), distance [288, 320)
  uint16_t lens[320];
  int32_t cnt_ll[16], cnt_d[16];
  // the hand-off between the head and the body
  long long bp, op, nbits, base, cap, copy_src, copy_dst, copy_len;
  long long reach;  // history before out[0] a reference may reach past op
  int action, mode, last, no_par, gen, lut_gen, go, need_max, row;
  int flag[3], endi[3];  // a round's change and first block end, three in turn
  int vmin, total, L, r0, last_sub;
};

// ---------------------------------------------------------------------------
// the body: a coded block's symbols decoded by the whole block
// ---------------------------------------------------------------------------

IS_INL void s_or(uint32_t* a, uint32_t v) {
#ifdef __CUDACC__
  atomicOr(a, v);
#else
  *a |= v;
#endif
}

IS_INL void s_min(int* a, int v) {
#ifdef __CUDACC__
  atomicMin(a, v);
#else
  if (v < *a) *a = v;
#endif
}

IS_INL void s_add(int* a, int v) {
#ifdef __CUDACC__
  atomicAdd(a, v);
#else
  *a += v;
#endif
}

IS_INL void s_max(int* a, int v) {
#ifdef __CUDACC__
  atomicMax(a, v);
#else
  if (v > *a) *a = v;
#endif
}

IS_INL int pack(int pos, int kind) { return pos * 4 + kind; }
IS_INL int pos_of(int x) { return x >> 2; }
IS_INL int kind_of(int x) { return x & 3; }

// 64 bits of the window from relative bit p
IS_INL uint64_t peek64(const uint32_t* w, int p) {
  const int i = p >> 5, s = p & 31;
  uint64_t v = (uint64_t)w[i] | ((uint64_t)w[i + 1] << 32);
  if (s) v = (v >> s) | ((uint64_t)w[i + 2] << (64 - s));
  return v;
}

// the canonical decode of `w` (LSB first) over codes of at most `maxbits`
// bits: the symbol, or -1; its length in *len
IS_INL int canon(uint32_t w, int maxbits, const int32_t* cnt, const uint16_t* sorted, int* len) {
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= maxbits; l++) {
    code |= (int)((w >> (l - 1)) & 1u);
    const int count = cnt[l];
    if (code < first + count) {
      *len = l;
      return sorted[index + code - first];
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -1;
}

// the compact entry for a root index, or for the bits of a long code
IS_INL uint32_t canon_entry(uint32_t w, int maxbits, int alphabet, const int32_t* cnt,
                            const uint16_t* sorted) {
  int len = 0;
  const int s = canon(w, maxbits, cnt, sorted, &len);
  if (s >= 0) return sym_entry(alphabet, s, len);
  return maxbits < 15 ? mk_entry(K_LONG, 0, 0, 0) : mk_entry(K_BAD, 0, 0, 0);
}

struct Tok {
  int kind, bits, len, dist, lit;
};

// the token whose litlen code starts at window bit p
IS_INL void decode_tok(const Body* b, int p, Tok& t) {
  const uint64_t w = peek64(b->stage, p);
  uint32_t e = b->ll[w & ((1u << kLlBits) - 1u)];
  if ((int)(e >> 28) == K_LONG) e = canon_entry((uint32_t)w, 15, 0, b->cnt_ll, b->sorted);
  t.kind = (int)(e >> 28);
  const int nb = (e >> 16) & 0x3f;
  t.bits = nb;
  if (t.kind == K_LIT) {
    t.len = 1;
    t.lit = e & 0xff;
    return;
  }
  if (t.kind != K_MATCH) return;
  const int aux = (e >> 22) & 0x3f;
  t.len = (int)(e & 0xffff) + (int)low_bits((uint32_t)(w >> nb), aux);
  const uint64_t w2 = w >> (nb + aux);
  uint32_t de = b->d[w2 & ((1u << kDBits) - 1u)];
  if ((int)(de >> 28) == K_LONG) de = canon_entry((uint32_t)w2, 15, 1, b->cnt_d, b->sorted + 288);
  if ((int)(de >> 28) == K_BAD) {
    t.kind = K_BAD;
    return;
  }
  const int dnb = (de >> 16) & 0x3f, daux = (de >> 22) & 0x3f;
  t.dist = (int)(de & 0xffff) + (int)low_bits((uint32_t)(w2 >> dnb), daux);
  t.bits = nb + aux + dnb + daux;
}

// a walk from litlen start p to the first litlen start at or past `end`,
// an EOB or a bad symbol. The first pass marks every litlen start it
// passes; a later walk stops at a marked one with the first pass's exit.
IS_INL int walk(Body* b, int p, int end, bool mark, int synced) {
  for (;;) {
    if (p >= end) return pack(p, X_NEXT);
    if (mark)
      s_or(&b->marks[p >> 5], 1u << (p & 31));
    else if ((b->marks[p >> 5] >> (p & 31)) & 1u)
      return synced;
    Tok t;
    decode_tok(b, p, t);
    if (t.kind == K_BAD) return pack(p, X_BAD);
    if (t.kind == K_EOB) return pack(p + t.bits, X_EOB);
    p += t.bits;
  }
}

IS_INL int sub_end(const Body* b, int i, int wlim) {
  const int e = b->r0 + (i + 1) * b->L;
  return e < wlim ? e : wlim;
}

// the compact table from the code lengths the head kept
IS_DEV void build_lut(Body* b, const uint16_t* lens_in, int tid, int nthr) {
  for (int i = tid; i < 16; i += nthr) b->cnt_ll[i] = b->cnt_d[i] = 0;
  for (int s = tid; s < 320; s += nthr) b->lens[s] = lens_in[s];
  block_sync();
  for (int s = tid; s < 320; s += nthr)
    if (b->lens[s]) s_add(s < 288 ? &b->cnt_ll[b->lens[s]] : &b->cnt_d[b->lens[s]], 1);
  block_sync();
  for (int s = tid; s < 320; s += nthr) {
    const int l = b->lens[s];
    if (!l) continue;
    const int lo = s < 288 ? 0 : 288;
    const int32_t* cnt = s < 288 ? b->cnt_ll : b->cnt_d;
    int at = lo;
    for (int k = 1; k < l; k++) at += cnt[k];
    for (int q = lo; q < s; q++) at += b->lens[q] == l;
    b->sorted[at] = (uint16_t)(s - lo);
  }
  block_sync();
  for (int i = tid; i < (1 << kLlBits); i += nthr)
    b->ll[i] = canon_entry((uint32_t)i, kLlBits, 0, b->cnt_ll, b->sorted);
  for (int i = tid; i < (1 << kDBits); i += nthr)
    b->d[i] = canon_entry((uint32_t)i, kDBits, 1, b->cnt_d, b->sorted + 288);
  block_sync();
}

// the exclusive scan of a[0, n) in place (a sub-range's count each); the
// total in *total
IS_DEV void scan_counts(Body* b, int32_t* a, int n, int* total, int tid, int nthr) {
#ifdef __CUDACC__
  const int lane = tid & 31, wid = tid >> 5;
  const int v = tid < n ? a[tid] : 0;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) b->wsum[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int nw = (nthr + 31) >> 5;
    int s = lane < nw ? b->wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    b->wsum[lane] = s;  // inclusive over warps
    if (lane == 31) *total = s;
  }
  __syncthreads();
  if (tid < n) a[tid] = incl - v + (wid ? b->wsum[wid - 1] : 0);
  __syncthreads();
#else
  (void)b;
  (void)tid;
  (void)nthr;
  int run_ = 0;
  for (int i = 0; i < n; i++) {
    const int v = a[i];
    a[i] = run_;
    run_ += v;
  }
  *total = run_;
#endif
}

// the expansion of a window whose sync decode is done: literals and
// pointers (and the first token the expansion refuses), pointer jumping,
// the cells, and the state after the window in b; run by `nthr` threads
// (tid counts from 0 among them). A cell is a byte (IS: out holds the
// history before op) or a u16 (SP2: out[0] is the row's start, and a
// byte whose source lies before it becomes the marker 256 + back - 1;
// b->need_max takes the deepest such reach of the window's tokens).
template <typename Cell>
IS_DEV void expand(Body* b, Cell* out, int32_t* ptrs, long long* stats, long long w0,
                   long long wq0, int wlim, int last_sub, int tid, int nthr) {
  constexpr bool kMarkers = sizeof(Cell) == sizeof(uint16_t);
  const long long t1 = stats && tid == 0 ? now_ns() : 0;
  const long long op0 = b->op;
  const long long q0 = op0 - b->base;  // the window's first cell in out
  const long long room_left = b->cap - q0;
  const long long lim = room_left < kPtrCap ? room_left : kPtrCap;
  const long long far = op0 + b->reach;
  Cell* wout = out + q0;
  for (int i = tid; i <= last_sub; i += nthr) {
    int p = pos_of(b->used[i]);
    int q = b->cnt[i];
    int need = 0;
    const int end = sub_end(b, i, wlim);
    while (p < end) {
      Tok t;
      decode_tok(b, p, t);
      if (t.kind == K_BAD || t.kind == K_EOB) break;
      int v = 0;
      if (t.kind == K_MATCH && (long long)t.dist > far + q)
        v = V_FAR;
      else if (q + t.len > lim)
        v = q + t.len > room_left ? V_ROOM : V_WIN;
      if (v) {
        b->first[i] = pack(p, v);
        b->inb[i] = q;
        s_min(&b->vmin, i);
        break;
      }
      // a literal is a byte now and points at itself; a match byte points
      // at its source (into the period of a match shorter than its
      // length), below 0 where that lies before the window: a byte too
      if (t.kind == K_LIT) {
        wout[q] = (Cell)t.lit;
        ptrs[q] = q;
      } else {
        if (kMarkers && (long long)t.dist > q0 + q && t.dist - (int)(q0 + q) > need)
          need = t.dist - (int)(q0 + q);
        int r = 0;
        for (int k = 0; k < t.len; k++) {
          ptrs[q + k] = q + r - t.dist;
          if (++r == t.dist) r = 0;
        }
      }
      q += t.len;
      p += t.bits;
    }
    if (kMarkers) b->need[i] = need;
  }
  part_sync(nthr);
  if (stats && tid == 0) stats[S_NS_WRITE] += now_ns() - t1;
  // where the window ends
  int stop, c_stop, why;
  if (b->vmin != INT_MAX) {
    const int i = b->vmin;
    stop = pos_of(b->first[i]);
    why = kind_of(b->first[i]);
    c_stop = b->inb[i];
  } else {
    const int x = b->cur[last_sub];
    stop = pos_of(x);
    why = kind_of(x) == X_EOB ? -1 : kind_of(x) == X_BAD ? V_BAD : 0;
    c_stop = b->total;
  }
  // the reach of the tokens before the stop (the jumping's first barrier
  // publishes it)
  if (kMarkers) {
    const int si = b->vmin != INT_MAX ? b->vmin : last_sub;
    for (int i = tid; i <= si; i += nthr) s_max(&b->need_max, b->need[i]);
  }
  // pointer jumping over the window's output, eight pointers a thread in
  // flight (the scratch lives in L2)
  constexpr int U = 8;
  int jumps = 0;
  for (;;) {
    if (tid == 0) b->flag[(jumps + 1) % 3] = 0;
    int changed = 0;
    for (int q0_ = tid; q0_ < c_stop; q0_ += U * nthr) {
      int p[U], pp[U];
IS_UNROLL
      for (int u = 0; u < U; u++) {
        const int q = q0_ + u * nthr;
        p[u] = q < c_stop ? ptrs[q] : q;
      }
IS_UNROLL
      for (int u = 0; u < U; u++) {
        const int q = q0_ + u * nthr;
        pp[u] = p[u] >= 0 && p[u] != q ? ptrs[p[u]] : p[u];
      }
IS_UNROLL
      for (int u = 0; u < U; u++) {
        const int q = q0_ + u * nthr;
        if (pp[u] != p[u]) {
          ptrs[q] = pp[u];
          changed = 1;
        }
      }
    }
    if (changed) b->flag[jumps % 3] = 1;
    part_sync(nthr);
    const int any = b->flag[jumps % 3];
    if (!any) break;
    jumps++;
  }
  for (int q0_ = tid; q0_ < c_stop; q0_ += U * nthr) {
    int p[U];
IS_UNROLL
    for (int u = 0; u < U; u++) {
      const int q = q0_ + u * nthr;
      p[u] = q < c_stop ? ptrs[q] : q;
    }
IS_UNROLL
    for (int u = 0; u < U; u++) {
      const int q = q0_ + u * nthr;
      if (p[u] == q) continue;
      if (kMarkers && q0 + p[u] < 0)
        wout[q] = (Cell)(255 - (q0 + p[u]));
      else
        wout[q] = wout[p[u]];
    }
  }
  part_sync(nthr);
  if (tid == 0) {
    b->bp = wq0 * 32 + stop;
    b->op = op0 + c_stop;
    if (why == -1) b->mode = b->last ? M_DONE : M_HEAD;
    if (why == V_FAR || why == V_ROOM || why == V_BAD) b->no_par = 1;  // the head decodes it
    if (stats) {
      stats[S_NS_EXPAND] += now_ns() - t1;
      stats[S_JUMPS] += jumps;
      if (jumps > stats[S_MAX_JUMPS]) stats[S_MAX_JUMPS] = jumps;
      stats[S_BODY_OUT] += c_stop;
      stats[S_BODY_BITS] += b->bp - w0;
    }
  }
}

// one window of a coded body, from the litlen start b->bp: decode it,
// expand it into out and ptrs, and leave the state after it in b. The
// head (Head::kSpeculates) may parse the next block's header meanwhile;
// true where that parse was taken.
template <class Head, typename Cell>
IS_DEV bool body(Body* b, Head* hs, const uint32_t* inw, long long in_words,
                 const uint16_t* lens_in, Cell* out, int32_t* ptrs, long long* stats, int Larg,
                 int T, int tid, int nthr) {
  long long t0 = 0;
  if (stats && tid == 0) t0 = now_ns();
  if (b->lut_gen != b->gen) {
    build_lut(b, lens_in, tid, nthr);
    if (tid == 0) {
      b->lut_gen = b->gen;
      if (stats) stats[S_LUTS]++;
    }
  }
  // the window: word-aligned to 16 bytes, its bits relative to word wq0
  const long long w0 = b->bp;
  const long long wq0 = (w0 >> 5) & ~3LL;
  const int r0 = (int)(w0 - wq0 * 32);
  long long range = b->nbits - kMargin - w0;
  const long long room_bits = (long long)kStageWords * 32 - r0;
  if (range > room_bits) range = room_bits;
  int L = Larg;
  if (L <= 0) {
    const long long want = (range + T - 1) / T;
    L = want < kLmin ? kLmin : want > kLmax ? kLmax : (int)want;
  }
  long long nsub = (range + L - 1) / L;
  if (nsub > T) nsub = T;
  const int wlim = r0 + (int)(range < nsub * L ? range : nsub * L);
  if (tid == 0) {
    b->L = L;
    b->r0 = r0;
  }
  // stage the window's words (a token from below wlim reads up to 48
  // bits past it, a peek three words), zero past the buffer
  const int nstage = ((((wlim + 48) >> 5) + 3) + 3) & ~3;
#ifdef __CUDACC__
  for (int j = tid * 4; j < nstage; j += nthr * 4) {
    if (wq0 + j + 4 <= in_words) {
      __pipeline_memcpy_async(&b->stage[j], &inw[wq0 + j], 16);
    } else {
      for (int k = 0; k < 4; k++) b->stage[j + k] = wq0 + j + k < in_words ? inw[wq0 + j + k] : 0u;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
#else
  for (int j = 0; j < nstage; j++) b->stage[j] = wq0 + j < in_words ? inw[wq0 + j] : 0u;
#endif
  for (int j = tid; j < nstage; j += nthr) b->marks[j] = 0;
  if (tid == 0) {
    b->flag[0] = 0;
    b->endi[0] = INT_MAX;
  }
  block_sync();
  const int n = (int)nsub;
  // the first pass
  for (int i = tid; i < n; i += nthr) {
    const int s = r0 + i * L;
    const int x = walk(b, s, sub_end(b, i, wlim), true, 0);
    b->first[i] = b->cur[i] = x;
    b->used[i] = pack(s, X_NEXT);
  }
  block_sync();
  // rounds: an entry that changed decodes again until it meets its first
  // pass. Sub-ranges past the first that ends the block (an EOB or a bad
  // symbol) wait: their entries come after the block's end.
  int rounds = 0;
  for (;;) {
    if (rounds == kMaxRounds) {
      if (tid == 0) {  // the lone serial finish
        int e = n - 1;
        for (int i = 0; i < n; i++) {
          const int in_ = i ? b->cur[i - 1] : pack(r0, X_NEXT);
          if (in_ != b->used[i]) {
            b->used[i] = in_;
            b->cur[i] = walk(b, pos_of(in_), sub_end(b, i, wlim), false, b->first[i]);
          }
          if (kind_of(b->cur[i]) != X_NEXT) {
            e = i;
            break;
          }
        }
        b->last_sub = e;
        if (stats) stats[S_SERIAL]++;
      }
      block_sync();
      break;
    }
    if (tid == 0) {
      b->flag[(rounds + 1) % 3] = 0;
      b->endi[(rounds + 1) % 3] = INT_MAX;
    }
    for (int i = tid; i < n; i += nthr) {
      b->inb[i] = i ? b->cur[i - 1] : pack(r0, X_NEXT);
      if (kind_of(b->cur[i]) != X_NEXT) s_min(&b->endi[rounds % 3], i);
    }
    block_sync();
    const int e = b->endi[rounds % 3];
    for (int i = tid; i < n && i <= e; i += nthr) {
      const int in_ = b->inb[i];
      if (in_ == b->used[i]) continue;
      b->used[i] = in_;
      b->cur[i] = walk(b, pos_of(in_), sub_end(b, i, wlim), false, b->first[i]);
      b->flag[rounds % 3] = 1;
    }
    block_sync();
    const int changed = b->flag[rounds % 3];
    if (!changed) {
      if (tid == 0) b->last_sub = e < n ? e : n - 1;
      block_sync();
      break;
    }
    rounds++;
  }
  const int last_sub = b->last_sub;  // the sub-ranges [0, last_sub] hold the window's tokens
  // each sub-range's confirmed tokens: their output
  for (int i = tid; i < n; i += nthr) {
    int c = 0;
    if (i <= last_sub) {
      int p = pos_of(b->used[i]);
      const int end = sub_end(b, i, wlim);
      while (p < end) {
        Tok t;
        decode_tok(b, p, t);
        if (t.kind == K_BAD || t.kind == K_EOB) break;
        c += t.len;
        p += t.bits;
      }
    }
    b->cnt[i] = c;
  }
  if (tid == 0) {
    b->vmin = INT_MAX;
    b->need_max = 0;
    b->flag[0] = 0;
  }
  block_sync();
  scan_counts(b, b->cnt, n, &b->total, tid, nthr);
  if (stats && tid == 0) {  // the sync decode, its count and scan
    stats[S_NS_SYNC] += now_ns() - t0;
    stats[S_WINDOWS]++;
    stats[S_ROUNDS] += rounds;
    if (rounds > stats[S_MAX_ROUNDS]) stats[S_MAX_ROUNDS] = rounds;
  }
  // The window ends at an EOB unless the expansion refuses a token before
  // it: the head warp parses the next header meanwhile (taken if the
  // window does end there), and the other warps expand.
  const int xe = b->cur[last_sub];
  bool spec = false;
  if constexpr (Head::kSpeculates) spec = kind_of(xe) == X_EOB && !b->last;
  int etid = tid, enthr = nthr;
#ifdef __CUDACC__
  if (spec) {
    etid = tid - 32;
    enthr = nthr - 32;
  }
#endif
  typename Head::Saved saved = {};
  if constexpr (Head::kSpeculates) {
    if (spec && tid < 32) {
      const long long ts = stats && tid == 0 ? now_ns() : 0;
      hs->speculate(wq0 * 32 + pos_of(xe), saved);
      if (stats && tid == 0) {
        stats[S_NS_SPEC] += now_ns() - ts;
        stats[S_SPECS]++;
      }
    }
  }
  if (etid >= 0) expand(b, out, ptrs, stats, w0, wq0, wlim, last_sub, etid, enthr);
  block_sync();
  bool taken = false;
  if constexpr (Head::kSpeculates) {
    if (spec && tid < 32) {
      taken = b->mode == M_HEAD;
      hs->settle(taken, saved, b);
    }
  }
  return taken;
}

}  // namespace
