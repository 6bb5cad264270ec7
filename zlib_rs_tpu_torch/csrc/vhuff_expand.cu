// K5 and K11b: the two-plane and single-plane token expansions, one block
// per chunk, one body over two tape readers.
//
// K5 (`zrs_vhuff_expand`) replaces
// zlib_rs_tpu/ops/pallas/vhuff_kernel.py:expand_tokens_pallas2 (body
// _make_expand_kernel2), K11b (`zrs_vhuff_expand1`) expand_tokens_pallas
// (body _make_expand_kernel). Walker s of a chunk covers output bytes
// [offs[s], offs[s + 1]). A two-plane tape row is up to four literal bytes,
// then, if the row has a match, the match; an all-zero row ends the
// walker. A single-plane row is one token: 1-3 literal bytes (LIT), one
// match (MATCH), or anything else, which ends the walker. The references
// run the walkers in order and store whole words (a literal funnel store,
// a byte head for dist < 4, then word copies), so a row leaves don't-care
// bytes past its end that the next row or walker overwrites. The
// single-plane reference also runs each literal sprint on past its
// walker's end, up to the next token that is no LIT, and then copies that
// token's match (or, for an end token, a cover-0 copy: a byte head for
// dist < 4 and one word): don't-care bytes past the walker's end too.
//
// Why the order of the walkers does not matter. When the walkers tile
// their ranges (each ends exactly at the next one's offset, every row has
// at most 4 literals, and every match has 1 <= dist <= its position), each
// byte in [offs[0], offs[S]) is defined by exactly one token: a literal
// byte, or byte q of a match, which equals byte q - dist. A later store
// starts at or past the end of the token that defines a byte, so the
// serial order leaves that byte as the token defines it, and bytes before
// offs[0] stay zero. What a walker writes past its end (the single-plane
// sprint and its copy) walker s + 1 overwrites, since it runs later and
// tiles its own range; past offs[S] nothing is defined. The single-plane
// sprint ORs each LIT into a word register that holds the bytes above the
// last one, so a LIT whose bits above its count are not zero is no row the
// resolve takes: the chunk takes the serial body. So the chunk is built in
// parallel, in shared memory, as one 16-bit cell a byte: 0x8000 | the byte
// once it is known, else a pointer to an earlier byte with the same value
// (0xFFFF while open).
//   1. Resolve, kGroup lanes a walker (the reader's: 4 for two-plane rows,
//      8 for the shorter single-plane ones). Its own rows give its
//      positions (p += cnt + length) without the bytes of any other
//      walker. Each lane takes one row of a window of kGroup rows, and an
//      exclusive scan of the rows' lengths in the group places them. It
//      writes each literal byte, known, and at each match's first byte the
//      pointer p - dist; the match's other bytes stay open. A row costs
//      the same whatever its match length, so the lanes of a warp stay in
//      step. It checks the tiling as it goes, before a match writes a
//      cell, so a corrupt length (14 bits on the single plane) never
//      indexes past the cells.
//   2. Fill, one segment of bytes a thread. An open byte lies inside the
//      match of the last head before it; a block max scan of each
//      segment's last token gives a segment the head it starts in. Byte j
//      of a match at s takes s + j - dist, or, where that lies inside the
//      match itself (dist <= j, an overlapping copy), the byte one period
//      earlier before s, s - dist + j % dist. A pointer into the thread's
//      own segment is replaced by its target's cell, final there, so a
//      chain hops only between segments.
//   3. Chase, all threads. Pointer jumping: a cell that holds a pointer
//      takes its target's cell (a pointer further back, or the byte), in
//      rounds until no cell changes (__syncthreads_or). A cell only ever
//      moves along its own chain, so a store racing a load gives an old or
//      a newer cell of that chain, and each round at least halves every
//      chain. A thread takes two cells (one word) a step.
// Then every cell holds its byte, and the row is copied out coalesced as
// words. Pointers take 15 bits, so the chase takes a chunk of at most
// kChaseBytes output bytes: the port's 32 KiB chunks, whose cells, with one
// pad pair after every kSeg (so that the lanes of a warp, each on its own
// segment, read 32 banks), take 66 KiB: two blocks an SM, all 256 chunks
// of the main path in one wave.
//
// Two kinds of chunk keep their reference's serial body (one thread
// expands the walkers in order, reads clamped to the row, stray stores
// dropped):
// a chunk whose walkers do not tile their ranges (a corrupt tape or a
// damaged index; such a chunk fails the decode's checks), whose whole row
// then equals the plain version's, and a chunk of more than kChaseBytes
// (the JAX package's 128 KiB chunks), built in shared memory where its row
// fits and in device memory otherwise. The optional `branch` output gives
// each chunk's: 0 the chase, 1 serial because the walkers do not tile, 2
// serial because the chunk is too large.
//
// The tape reader is a policy (`TwoPlane`, `SinglePlane`): a row as
// (literal bytes, count, match length, dist, end), its window (kGroup) and
// its serial body. The resolve, the fill and the chase take either.
//
// Bound on the H100: bytes (the tape rows read once, the output written
// once); the resolve is a walk of dependent windows a walker, its rows
// loaded two windows ahead, and the fill and the chase a few passes over
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSegShift = 6;
constexpr int kSeg = 1 << kSegShift;  // the fill's segment unit, bytes
constexpr int kChaseBytes = 32768;    // a chunk's bytes the chase takes: 15-bit pointers
constexpr int kChaseRow = 65536;      // row bytes a launch may have for the chase
constexpr uint16_t kKnown = 0x8000;   // | the byte
constexpr uint16_t kOpen = 0xFFFF;
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may use

enum Branch { kChase = 0, kUntiled = 1, kTooLarge = 2 };
enum Mode { kModeChase = 0, kModeSerialSmem = 1, kModeSerialDevice = 2 };

struct Row {
  uint32_t lits;  // literal bytes, LSB first
  int cnt;        // literals
  int len;        // match length, 0 for none
  int dist;
  bool end;       // the row ends the walker, or is no row the resolve takes
};

// The two-plane tape: row t of walker column c at t * W + c of each plane;
// tapeB = cnt:3 | has:1 | len-3:8 | dist:16, tapeA the literal bytes.
struct TwoPlane {
  static constexpr int kGroup = 4;  // lanes a resolving walker: a window of 4 rows
  const int32_t* a;
  const int32_t* b;
  long long W;
  struct Raw {
    uint32_t a, b;
  };
  __device__ __forceinline__ Raw load(long long col, int t) const {
    const long long i = (long long)t * W + col;
    return {(uint32_t)__ldg(a + i), (uint32_t)__ldg(b + i)};
  }
  static __device__ __forceinline__ Raw zero() { return {0u, 0u}; }
  static __device__ __forceinline__ Row decode(Raw r) {
    const bool has = (r.b & 8u) != 0;
    return {r.a, (int)(r.b & 7u), has ? (int)((r.b >> 4) & 0xFFu) + 3 : 0,
            (int)((r.b >> 12) & 0xFFFFu), r.b == 0};
  }
};

constexpr uint32_t kKindLit = 1, kKindMatch = 2;

// The single-plane tape: row t of walker column c at t * W + c, one token
// a row: LIT (kind 1) = (cnt - 1):2 at bit 24 | up to 3 literal bytes,
// MATCH (kind 2) = (len - 3):14 at bit 16 | dist:16; any other kind ends
// the walker. A LIT with bits above its count (the serial sprint would OR
// them into the next bytes) is no row the resolve takes.
struct SinglePlane {
  static constexpr int kGroup = 8;  // lanes a resolving walker: a window of 8 rows
  const int32_t* t;
  long long W;
  using Raw = uint32_t;
  __device__ __forceinline__ Raw load(long long col, int row) const {
    return (uint32_t)__ldg(t + (long long)row * W + col);
  }
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ Row decode(Raw r) {
    const uint32_t kind = r >> 30;
    if (kind == kKindLit) {
      const int cnt = (int)((r >> 24) & 3u) + 1;
      const uint32_t lits = r & 0xFFFFFFu;
      return {lits, cnt, 0, 0, cnt < 3 && (lits >> (8 * cnt)) != 0};
    }
    if (kind == kKindMatch)
      return {0u, 0, (int)((r >> 16) & 0x3FFFu) + 3, (int)(r & 0xFFFFu), false};
    return {0u, 0, 0, 0, true};
  }
};

// where byte q keeps its cell: one pad pair after every kSeg
__host__ __device__ constexpr int slot(int q) { return q + ((q >> kSegShift) << 1); }

// One walker's tokens in [p, p1), Tape::kGroup lanes a walker (`act` false
// for a lane with no walker): literal bytes, known, and each match's first
// pointer. Each lane takes one row of a window of kGroup rows, loaded two
// windows ahead; an exclusive scan of the rows' lengths in the group
// gives each row its place, and the rows that start before p1 (a prefix
// of the window) are taken, as the serial loop would take them. Returns
// false when the walker does not tile its range (the chunk then takes the
// serial body), the same in every lane of its group.
template <class Tape>
__device__ bool resolve(const Tape& tape, bool act, long long col, int cap, int p, int p1,
                        int end, uint16_t* cell) {
  constexpr int kGroup = Tape::kGroup;
  const int lane = threadIdx.x & 31, g = lane & (kGroup - 1);
  const unsigned gmask = ((1u << kGroup) - 1u) << (lane - g);
  bool ok = !act || (p >= 0 && p <= p1 && p1 <= end);
  bool live = act && ok && p < p1;
  typename Tape::Raw cur = Tape::zero(), nxt = Tape::zero();
  if (live && g < cap) cur = tape.load(col, g);
  if (live && kGroup + g < cap) nxt = tape.load(col, kGroup + g);
  for (int t0 = 0; __any_sync(0xFFFFFFFFu, live); t0 += kGroup) {
    const int t = t0 + g;
    typename Tape::Raw fut = Tape::zero();
    if (live && t + 2 * kGroup < cap) fut = tape.load(col, t + 2 * kGroup);
    const Row r = Tape::decode(cur);
    const int adv = live && t < cap ? r.cnt + r.len : 0;
    int incl = adv;
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d, kGroup);
      if (g >= d) incl += y;
    }
    const int pos = p + incl - adv, lit_end = pos + r.cnt;
    const bool take = live && t < cap && pos < p1;
    const bool bad = take && (r.end || r.cnt > 4 || lit_end > p1 ||
                              (r.len && (r.dist == 0 || r.dist > lit_end || lit_end + r.len > p1)));
    if (take && !bad) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < r.cnt) cell[slot(pos + i)] = (uint16_t)(kKnown | ((r.lits >> (8 * i)) & 0xFFu));
      if (r.len) cell[slot(lit_end)] = (uint16_t)(lit_end - r.dist);
    }
    const unsigned takem = __ballot_sync(0xFFFFFFFFu, take) & gmask;
    const unsigned badm = __ballot_sync(0xFFFFFFFFu, bad) & gmask;
    const int ntake = __popc(takem);
    const int np = __shfl_sync(0xFFFFFFFFu, pos + adv, ntake ? ntake - 1 : 0, kGroup);
    if (live) {
      ok = !badm;
      p = ntake ? np : p;
      live = ok && ntake == kGroup && p < p1;  // a full window: the walker goes on
    }
    cur = nxt;
    nxt = fut;
  }
  return !act || (ok && p == p1);
}

// Exclusive max scan of one int a thread (values at least -1, the
// identity), in thread order. Every thread of the block calls it.
__device__ int block_max_scan(int v, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x = max(x, y);
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int z = lane < kWarps ? tmp[lane] : -1;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, z, d);
      if (lane >= d) z = max(z, y);
    }
    if (lane < kWarps) tmp[lane] = z;
  }
  __syncthreads();
  int ex = __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (lane == 0) ex = -1;
  const int r = max(ex, warp ? tmp[warp - 1] : -1);
  __syncthreads();
  return r;
}

// Fills the open bytes of [q0, q1), given the last token before q0 (-1
// for none) and its cell as the resolve left it: each open byte lies
// inside the match of the last head before it. A pointer into [q0, q) is
// replaced by its target's cell, already final here, so on exit each
// cell of the segment is known or points before q0. An open byte with no
// head before it lies before the first walker: a known zero.
__device__ void fill(uint16_t* cell, int q0, int q1, int last, int last_cell) {
  int s = -1, d = 1, j = 0, r = 0;  // the match being filled: head, dist, q - s, j % d
  if (last >= 0 && last_cell < last) {
    s = last;
    d = last - last_cell;
    j = q0 - s;
    r = j % d;
  }
  for (int q = q0; q < q1; ++q, ++j, r = r + 1 == d ? 0 : r + 1) {
    int v = cell[slot(q)];
    if (v == kOpen) {
      // byte j of the match copies q - d, or, inside the match itself, the
      // byte one period earlier before s
      v = s < 0 ? kKnown : (j < d ? q - d : s - d + r);
    } else if (v < q) {
      s = q;
      d = q - v;
      j = 0;
      r = 0;
    } else {
      s = -1;
      continue;  // a literal, known
    }
    if (v >= q0 && v < q) v = cell[slot(v)];
    cell[slot(q)] = (uint16_t)v;
  }
}

// -- the reference's serial body --------------------------------------------

struct Out {
  uint32_t* o;
  long long n;  // out_words

  __device__ __forceinline__ uint32_t rd(long long i) const {
    return o[i < 0 ? 0 : (i >= n ? n - 1 : i)];
  }
  __device__ __forceinline__ void wr(long long i, uint32_t v) const {
    if (i >= 0 && i < n) o[i] = v;
  }
  // the four bytes from byte position sp
  __device__ __forceinline__ uint32_t src4(long long sp) const {
    const int sh = (int)(sp & 3) << 3;
    const uint32_t w0 = rd(sp >> 2);
    return sh ? (w0 >> sh) | (rd((sp >> 2) + 1) << (32 - sh)) : w0;
  }
};

__device__ void copy_match(const Out& out, long long p, int length, int dist) {
  const int d4 = dist >= 4 ? dist : (dist == 3 ? 6 : 4);
  const int base = dist >= 4 ? 0 : d4 - dist;
  for (int i = 0; i < base; ++i) {  // byte head of a dist < 4 match
    const long long q = p + i;
    long long src = q - dist;
    src = src < 0 ? 0 : src;
    const uint32_t b = (out.rd(src >> 2) >> ((src & 3) << 3)) & 0xFFu;
    const int qs = (int)(q & 3) << 3;
    out.wr(q >> 2, (out.rd(q >> 2) & ~(0xFFu << qs)) | (b << qs));
  }
  const long long pw = p + base;
  const long long wi = pw >> 2;
  const int sh = (int)(pw & 3) << 3;
  const long long sp = pw - d4;
  const int ssh = (int)(sp & 3) << 3;
  const uint32_t s0 = out.rd(sp >> 2);
  const uint32_t src4 = ssh ? (s0 >> ssh) | (out.rd((sp >> 2) + 1) << (32 - ssh)) : s0;
  out.wr(wi, (out.rd(wi) & ((1u << sh) - 1u)) | (src4 << sh));
  const long long nw = ((p + length - 1) >> 2) - wi;
  const long long sp0 = ((wi + 1) << 2) - d4;
  const long long swi0 = sp0 >> 2;
  const int sh_s = (int)(sp0 & 3) << 3;
  const bool rep4 = swi0 == wi;  // d4 == 4: repeat the word just stored
  uint32_t w0 = out.rd(swi0);
  for (long long k = 0; k < nw; ++k) {
    const uint32_t w1 = out.rd(swi0 + k + 1);
    const uint32_t val = sh_s ? (w0 >> sh_s) | (w1 << (32 - sh_s)) : w0;
    out.wr(wi + 1 + k, val);
    w0 = rep4 ? val : w1;
  }
}

__device__ void expand_walker(const Out& out, const TwoPlane& tape, long long col, int cap,
                              long long p, long long p1) {
  int t = 0;
  while (t < cap && p < p1) {
    const TwoPlane::Raw r = tape.load(col, t);
    const uint32_t ta = r.a, tb = r.b;
    const int cnt = (int)(tb & 7u);
    // literal funnel: up to 4 bytes, at most one word boundary
    const long long wi = p >> 2;
    const int sh = (int)(p & 3) << 3;
    const long long p2 = p + cnt;
    out.wr(wi, (out.rd(wi) & ((1u << sh) - 1u)) | (ta << sh));
    if ((p2 >> 2) > wi) out.wr(p2 >> 2, sh ? ta >> (32 - sh) : 0u);
    int length = 0;
    if (tb & 8u) {
      length = (int)((tb >> 4) & 0xFFu) + 3;
      copy_match(out, p2, length, (int)((tb >> 12) & 0xFFFFu));
    }
    t = tb ? t + 1 : cap;
    p = p2 + length;
  }
}

// The single-plane reference's copy: a byte head for dist < 4 (which turns
// the copy distance d4 into a multiple of the period of at least 4), a word
// store at the head's end, then whole words, each read from d4 back.
__device__ void copy_match1(const Out& out, long long p, int length, int dist) {
  const int d4 = dist >= 4 ? dist : (dist == 3 ? 6 : 4);
  const int base = dist >= 4 ? 0 : d4 - dist;
  for (int i = 0; i < base; ++i) {  // byte head of a dist < 4 match
    const long long q = p + i;
    long long src = q - dist;
    src = src < 0 ? 0 : src;
    const uint32_t b = (out.rd(src >> 2) >> ((src & 3) << 3)) & 0xFFu;
    const int qs = (int)(q & 3) << 3;
    out.wr(q >> 2, (out.rd(q >> 2) & ~(0xFFu << qs)) | (b << qs));
  }
  const long long pw = p + base;
  const long long wi = pw >> 2;
  const int sh = (int)(pw & 3) << 3;
  const uint32_t keep = out.rd(wi) & ((1u << sh) - 1u);
  out.wr(wi, keep | (out.src4(pw - d4) << sh));
  const long long nw = ((p + length - 1) >> 2) - wi;
  for (long long k = 0; k < nw; ++k) {
    const long long q = (wi + 1 + k) << 2;
    out.wr(wi + 1 + k, out.src4(q - d4));
  }
}

// One single-plane walker as its reference runs it: a literal sprint, then
// one match copy, while the walker is short of p1. The sprint funnels the
// bytes of each LIT token through a word register that starts as the bytes
// below the write position, storing the word whenever a token crosses a
// word boundary, and the register once it meets a token that is no LIT.
// That token is a match (copied, and the walker goes on) or anything else
// (a cover-0 copy, and the walker ends).
__device__ void expand_walker(const Out& out, const SinglePlane& tape, long long col, int cap,
                              long long p, long long p1) {
  auto at = [&](int t) { return t < cap ? tape.load(col, t) : 0u; };
  int t = 0;
  while (t < cap && p < p1) {
    uint32_t reg = out.rd(p >> 2) & ((1u << ((int)(p & 3) << 3)) - 1u);
    uint32_t tok = at(t);
    while ((tok >> 30) == kKindLit) {
      const int cnt = (int)((tok >> 24) & 3u) + 1;
      const uint32_t w = tok & 0x00FFFFFFu;
      const int sh = (int)(p & 3) << 3;
      const uint32_t full = reg | (w << sh);
      const long long p2 = p + cnt;
      out.wr(p >> 2, full);
      // bytes past the word go to the next one (sh == 0 spills nothing)
      reg = (p2 >> 2) > (p >> 2) ? (sh ? w >> (32 - sh) : 0u) : full;
      p = p2;
      tok = at(++t);
    }
    out.wr(p >> 2, reg);  // flush the partial word
    const bool is_match = (tok >> 30) == kKindMatch;
    const int cover = is_match ? (int)((tok >> 16) & 0x3FFFu) + 3 : 0;
    copy_match1(out, p, cover, (int)(tok & 0xFFFFu));
    p += cover;
    t = is_match ? t + 1 : cap;
  }
}

// -- the kernel --------------------------------------------------------------

template <class Tape>
__global__ void __launch_bounds__(kThreads, 2)
vhuff_expand(const Tape tape, const int32_t* __restrict__ offs, int cap, int S, int out_words,
             int mode, int32_t* __restrict__ out_g, int32_t* __restrict__ branch) {
  extern __shared__ uint32_t smem[];
  const int chunk = blockIdx.x, tid = threadIdx.x;
  const long long col = (long long)chunk * S;
  const int32_t* of = offs + (long long)chunk * (S + 1);
  uint32_t* row = (uint32_t*)out_g + (long long)chunk * out_words;
  const int nbytes = 4 * out_words;
  // the walkers tile [of[0], end) if they tile at all; past end, zeros
  const int end = min(max(of[S], 0), nbytes);
  const bool fits = of[S] <= kChaseBytes;

  if (mode == kModeChase && fits) {
    __shared__ int tmp[kWarps];
    uint16_t* cell = (uint16_t*)smem;
    uint32_t* pair = smem;
    for (int m = tid; 2 * m < nbytes; m += kThreads) {  // one pair of cells a step
      const int q = 2 * m;
      pair[slot(q) >> 1] = (q < end ? kOpen : kKnown) | (uint32_t)(q + 1 < end ? kOpen : kKnown) << 16;
    }
    __syncthreads();
    bool ok = true;
    for (int s0 = 0; s0 < S; s0 += kThreads / Tape::kGroup) {
      const int s = s0 + tid / Tape::kGroup;
      const bool act = s < S;
      ok &= resolve(tape, act, col + s, cap, act ? of[s] : 0, act ? of[s + 1] : 0, end, cell);
    }
    if (!__syncthreads_or(!ok)) {
      // fill: one segment a thread, each told the last token before it
      const int seg = kSeg * ((end + kSeg * kThreads - 1) / (kSeg * kThreads));
      const int q0 = min(tid * seg, end), q1 = min(q0 + seg, end);
      int last = -1;
      for (int q = q1 - 1; q >= q0; --q)
        if (cell[slot(q)] != kOpen) {
          last = q;
          break;
        }
      last = block_max_scan(last, tmp);
      // the head's cell before its own segment's fill replaces it
      const int last_cell = last >= 0 ? cell[slot(last)] : 0;
      __syncthreads();
      fill(cell, q0, q1, last, last_cell);
      __syncthreads();
      // chase, a pair of cells (one word) a step
      const int npairs = (end + 1) >> 1;
      for (;;) {
        int moved = 0;
        for (int m = tid; m < npairs; m += kThreads) {
          const uint32_t a = pair[slot(2 * m) >> 1], lo = a & 0xFFFFu, hi = a >> 16;
          const uint32_t b = (lo < kKnown ? cell[slot((int)lo)] : lo) |
                             (uint32_t)(hi < kKnown ? cell[slot((int)hi)] : hi) << 16;
          if (b != a) {
            pair[slot(2 * m) >> 1] = b;
            moved = 1;
          }
        }
        if (!__syncthreads_or(moved)) break;
      }
      for (int i = tid; i < out_words; i += kThreads) {
        const uint32_t c01 = pair[slot(4 * i) >> 1], c23 = pair[slot(4 * i + 2) >> 1];
        row[i] = (c01 & 0xFFu) | (c01 >> 8 & 0xFF00u) | (c23 & 0xFFu) << 16 | (c23 & 0xFF0000u) << 8;
      }
      if (branch && tid == 0) branch[chunk] = kChase;
      return;
    }
    // the walkers do not tile: the serial body, on the row in shared memory
  }
  const bool in_smem = mode != kModeSerialDevice;
  const Out out = {in_smem ? smem : row, out_words};
  for (int i = tid; i < out_words; i += kThreads) out.o[i] = 0;
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) expand_walker(out, tape, col + s, cap, of[s], of[s + 1]);
    if (branch) branch[chunk] = mode == kModeChase && fits ? kUntiled : kTooLarge;
  }
  __syncthreads();
  if (in_smem)
    for (int i = tid; i < out_words; i += kThreads) row[i] = out.o[i];
}

template <class Tape>
int launch(const Tape& tape, const void* offs, int cap, int W, int S, int out_words, void* out,
           void* branch, void* stream) {
  if (W <= 0 || S <= 0 || W % S || out_words <= 0) return (int)cudaErrorInvalidValue;
  const int B = W / S;
  const long long nbytes = 4LL * out_words;
  int mode;
  size_t smem;
  if (nbytes <= kChaseRow) {
    mode = kModeChase;
    smem = (size_t)(2 * slot((int)nbytes + 1) + 4);  // the cells, padded, and the last pair
  } else if (nbytes <= kSmemMax) {
    mode = kModeSerialSmem;
    smem = (size_t)nbytes;
  } else {
    mode = kModeSerialDevice;
    smem = 0;
  }
  cudaError_t err = cudaFuncSetAttribute(vhuff_expand<Tape>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  vhuff_expand<Tape><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      tape, (const int32_t*)offs, cap, S, out_words, mode, (int32_t*)out, (int32_t*)branch);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: tapes int32 [cap, W] (A the literal bytes, B the rest of each row)
extern "C" int zrs_vhuff_expand(const void* tape_a, const void* tape_b, const void* offs,
                                int cap, int W, int S, int out_words, void* out, void* branch,
                                void* stream) {
  return launch(TwoPlane{(const int32_t*)tape_a, (const int32_t*)tape_b, W}, offs, cap, W, S,
                out_words, out, branch, stream);
}

// K11b: one tape int32 [cap, W] of tokens
extern "C" int zrs_vhuff_expand1(const void* tape, const void* offs, int cap, int W, int S,
                                 int out_words, void* out, void* branch, void* stream) {
  return launch(SinglePlane{(const int32_t*)tape, W}, offs, cap, W, S, out_words, out, branch,
                stream);
}
