// SP1-SP3: the speculative decode of one raw-deflate stream with no index.
//
// Replaces no pallas_call site. It is the card's counterpart of the decode
// half of the reference's native engine (zlib_rs_tpu/native.py
// inflate_speculative and zran_index over native/zrs_native.cpp):
//   zrs_block_find   SP1, validate_header_at / find_candidate (depth 6): a
//                    tile's pre-filter, then a block a segment checks its
//                    survivors in order (zrs_block_find_thread, the first
//                    design, stays to be timed against it)
//   zrs_spec_decode  SP2, spec_decode with inflate_raw_impl's error codes
//                    and its stop and point hooks (a thread block a row;
//                    zrs_spec_decode_warp, the one-warp launch it
//                    replaced, stays to be timed against it)
//   zrs_spec_resolve SP3, the stitch: markers resolved, cells to bytes, a
//                    chase a cell (zrs_spec_resolve_jump, the first
//                    design's pointer jumping, stays to be timed)
// ops/kernels/speculative_kernel.py holds each one's plain version, whose
// control flow these kernels follow step for step, and the wrappers.
//
// Bounds on the H100. SP1 reads the compressed stream and writes a few
// ints a segment: its byte bound is microseconds for megabytes, and its
// work is a test at every bit offset of the searched ranges, most of which
// fail within 17 bits. SP2 moves the stream in and 2 bytes a cell out; a
// row is one serial chain (a code's length decides where the next
// starts), which its design breaks inside each coded block. SP3 moves
// bytes: cells in, bytes out, and a chain's hops read cells within 32 KiB
// before each segment, which the 50 MB L2 holds.
//
// Design.
// - Stream bit positions are 64-bit everywhere: SP1's ranges, survivors and
//   best offsets, SP2's start, stop and end bits and its block-start
//   records, int64 from the host's chain walk on (a stream of 2^28 bytes
//   or more has bit positions past int32). Cell counts stay int32, a
//   segment's room being under 2^31 cells.
// - SP1 (zrs_block_find) runs two kernels. find_tiles is a block a tile of
//   8,192 bit offsets of one segment's range, its words staged in shared
//   memory, a thread a word's 32 offsets: the offsets whose chain could
//   start there (stored or dynamic type) come from two shifts of the word,
//   and each reads its fields by funnel shifts: a stored LEN/NLEN, or a
//   dynamic header's counts and its code-length code's Kraft sum (PRMT
//   lookups, no local array). The survivors (under 1% of offsets on
//   compressed data) go in offset order into the tile's room of u16
//   offsets (a block scan), the exact count beside it. find_first is a
//   block a segment: its survivors in offset order, 256 at a time, a thread
//   each, through the native chain of up to 6 headers (stored links over
//   their payloads, static followers sanity-decoded for up to 192 symbols
//   by arithmetic on the fixed code, a dynamic link's code lengths through
//   the thread's 128-entry table of the code-length code in shared memory
//   with both codes' Kraft sums kept as integers, which is all that
//   building native's tables can refuse), up to the first group in which
//   one passes, the smallest winning. No survivor past a segment's first
//   pass is checked but the rest of its group. The first design
//   (find_prefilter, a thread an offset, then find_check, a thread a
//   survivor of an unordered list, an atomicMin a segment) stays as
//   zrs_block_find_thread, to be timed against it.
// - SP2 is a thread block of 1,024 a row (spec_sync), over the body that
//   IS decodes its coded blocks with (sync_body.cuh): a persistent grid of
//   as many blocks as are resident, each taking the next row from an
//   atomic counter, the longest first (a row's bit span), each with a
//   pointer scratch of kPtrCap int32 in device memory. Warp 0 is the head
//   (SpecHead): native spec_decode's control flow, all lanes on the same
//   values, for the row's start, every block header (the stop rule, the
//   record or the overflow flag, fixed code lengths, the dynamic header
//   with native's acceptance), stored blocks (copied by the whole block
//   from 256 bytes) and every symbol within kMargin + kMinBody bits of the
//   stream's end. Each coded body with more bits left goes to the block:
//   windows of up to 32 KiB of the stream's words staged with cp.async,
//   sub-ranges that resynchronise on litlen-code starts, a scan of each
//   token's output position, and pointer jumping into u16 cells; a cell
//   whose pointer lands before the row's start becomes its marker
//   256 + back - 1 (so a copy of a marker copies it), and the window's
//   deepest such reach is `need`. The window stops before a token that is
//   bad, points past n + hist, does not fit `cap` or starts within the
//   margin of the stream's end, and the head decodes on from that litlen
//   start with native's checks (a canonical decode over the code lengths'
//   counts; a slot no code reaches carries native's root, the lone code's
//   length), so every status, error and end bit is native's. Every block
//   start is recorded as (bit, cell offset) below a capacity the host
//   sizes at one record per 10 bits (the shortest block).
// - The one-warp launch (spec_decode): a warp a row on native's serial
//   code, K6's warp-built two-level tables in shared memory, every literal
//   a store to device memory; 4.4 MB/s of output a warp.
// - SP3 (zrs_spec_resolve) is a chase a cell over a copy of the cells:
//   resolve_chase runs a warp 32 consecutive cells, each marker's chain
//   followed (a hop lands in an earlier segment; seg_ofs in shared memory,
//   the target's segment tried one back before a binary search) until a
//   literal, a cell that is its own target, or the plain version's
//   2^rounds hops. Where seg_ofs starts at 0 (every chain then ends within
//   its segments' count of hops) a resolved marker's byte is written back
//   into the copy as a literal, so that a later chain through it ends
//   there: a racing read sees the marker or its byte, which end the chain
//   alike. A chain still going after kHopBudget hops stays a marker, and
//   resolve_tail follows those to their ends.
//   The first design (resolve_init, rounds of resolve_jump over two int32
//   pointer arrays of every cell, resolve_narrow) stays as
//   zrs_spec_resolve_jump, to be timed against it.
//
// Without __CUDACC__ the file compiles as host C++ with SP2's block launch
// (zrs_spec_decode_host: the rows in turn, the block's threads in turn, L
// an argument) and SP1's and SP3's second designs (zrs_block_find_host: one
// thread runs each tile, then each segment, so its block scans and group
// picks see one thread; zrs_spec_resolve_host: the cells in turn), so that
// the CPU tests run this file's SP1-SP3 against their plain versions and
// native.

#include "sync_body.cuh"

namespace {

constexpr uint32_t kLit = 0, kMatch = 1, kEob = 2, kSub = 3, kInvalid = 7;
constexpr int kLlRoot = 9, kDRoot = 6, kClRoot = 7;
constexpr int kLlCap = 852, kDCap = 592, kClCap = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMeta = 8, kStatus = 8;
constexpr int kOk = 0, kInvalidData = -1, kCap = -2, kTruncated = -3, kNoStart = -4;
constexpr int kDepth = 6, kStaticSyms = 192;
constexpr int kFindThreads = 256, kCheckThreads = 128, kResolveThreads = 256;

// ---------------------------------------------------------------------------
// bits: word reads clamped to [0, W - 1]; the words end in two zero words,
// so every bit past the stream reads 0
// ---------------------------------------------------------------------------

IS_INL uint32_t word_at(const uint32_t* w, int top, long long i) {
  i = i < 0 ? 0 : (i > top ? top : i);
#ifdef __CUDACC__
  return __ldg(w + i);
#else
  return w[i];
#endif
}
// 32 bits from bit `bp`
IS_INL uint32_t peek32(const uint32_t* w, int top, long long bp) {
  const long long wi = bp >> 5;
  const int sh = (int)(bp & 31);
  const uint32_t lo = word_at(w, top, wi);
  if (!sh) return lo;
  return (lo >> sh) | (word_at(w, top, wi + 1) << (32 - sh));
}
IS_INL uint32_t bits_at(const uint32_t* w, int top, long long bp, int k) {
  return peek32(w, top, bp) & ((1u << k) - 1u);
}

#ifdef __CUDACC__

// ---------------------------------------------------------------------------
// SP1: the block finder
// ---------------------------------------------------------------------------

// the chain's first header without tables: a stored LEN/NLEN, or a dynamic
// header's counts and a complete code-length code
__device__ bool prefilter(const uint32_t* w, int top, long long N, long long b) {
  if (b + 3 > N) return false;
  const int typ = (int)bits_at(w, top, b + 1, 2);
  if (typ == 0) {
    const long long q = (b + 10) & ~7LL;
    if (q + 32 > N) return false;
    const uint32_t v = peek32(w, top, q);
    const uint32_t ln = v & 0xFFFFu, nln = v >> 16;
    return (ln ^ nln) == 0xFFFFu && ln != 0;
  }
  if (typ != 2) return false;
  const uint32_t h = bits_at(w, top, b + 3, 14);
  const int ncode = (int)((h >> 10) & 15u) + 4;
  if ((h & 31u) > 29 || ((h >> 5) & 31u) > 29 || b + 17 + 3 * ncode > N) return false;
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < ncode; i++) cnt[bits_at(w, top, b + 17 + 3 * i, 3)]++;
  int left = 1;
  for (int l = 1; l < 8; l++) {
    left = 2 * left - cnt[l];
    if (left < 0) return false;
  }
  return left == 0;
}

// native build_table's refusal from the counts: kind 1 litlen, 2 distance
__device__ bool kraft_bad(const int* cnt, int kind) {
  int left = 1, ncodes = 0;
  for (int l = 1; l < 16; l++) {
    left = 2 * left - cnt[l];
    ncodes += cnt[l];
    if (left < 0) return true;
  }
  if (kind == 1) return left > 0 && ncodes != 1;
  return left > 0 && ncodes > 1;
}

// native parse_dynamic_tables at `pos` (after the block's 3 header bits),
// without building the tables: 0 when it would accept the header
__device__ int dynamic_ok(const uint32_t* w, int top, long long N, long long pos) {
  if (N - pos < 14) return kTruncated;
  const uint32_t h = bits_at(w, top, pos, 14);
  const int nlen = (int)(h & 31u) + 257, ndist = (int)((h >> 5) & 31u) + 1;
  const int ncode = (int)((h >> 10) & 15u) + 4;
  pos += 14;
  if (nlen > 286 || ndist > 30) return kInvalidData;
  int cl[19];
  for (int i = 0; i < 19; i++) cl[i] = 0;
  for (int i = 0; i < ncode; i++) {
    if (N - pos < 3) return kTruncated;
    cl[kClOrder[i]] = (int)bits_at(w, top, pos, 3);
    pos += 3;
  }
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 19; i++) cnt[cl[i]]++;
  int left = 1;
  for (int l = 1; l < 8; l++) {
    left = 2 * left - cnt[l];
    if (left < 0) return kInvalidData;
  }
  if (left != 0) return kInvalidData;
  // the canonical order: symbols by (length, symbol)
  int sorted[19], first_idx[8];
  int k = 0;
  for (int l = 1; l < 8; l++) {
    first_idx[l] = k;
    for (int s = 0; s < 19; s++)
      if (cl[s] == l) sorted[k++] = s;
  }
  int lcnt[16], dcnt[16];
  for (int l = 0; l < 16; l++) lcnt[l] = dcnt[l] = 0;
  const int total = nlen + ndist;
  int have = 0, prev = 0, len256 = 0;
  while (have < total) {
    if (N - pos < 7) return kTruncated;
    // canonical decode, a bit at a time (puff's): the code is complete, so
    // a symbol is found within its 7 bits
    uint32_t bb = bits_at(w, top, pos, 7);
    int code = 0, firstc = 0, sym = 0, nb = 0;
    for (int l = 1; l < 8; l++) {
      code |= (int)(bb & 1u);
      bb >>= 1;
      if (code - cnt[l] < firstc) {
        sym = sorted[first_idx[l] + code - firstc];
        nb = l;
        break;
      }
      firstc = (firstc + cnt[l]) << 1;
      code <<= 1;
    }
    int rep, fill;
    if (sym < 16) {
      pos += nb;
      rep = 1;
      fill = sym;
    } else {
      const int extra = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (N - pos < nb + extra) return kTruncated;
      pos += nb;
      if (sym == 16) {
        if (have == 0) return kInvalidData;
        rep = 3 + (int)bits_at(w, top, pos, 2);
        fill = prev;
      } else if (sym == 17) {
        rep = 3 + (int)bits_at(w, top, pos, 3);
        fill = 0;
      } else {
        rep = 11 + (int)bits_at(w, top, pos, 7);
        fill = 0;
      }
      pos += extra;
      if (have + rep > total) return kInvalidData;
    }
    const int in_lit = max(0, min(have + rep, nlen) - have);
    lcnt[fill] += in_lit;
    dcnt[fill] += rep - in_lit;
    if (have <= 256 && 256 < have + rep) len256 = fill;
    have += rep;
    prev = fill;
  }
  lcnt[0] = dcnt[0] = 0;
  if (len256 == 0 || kraft_bad(lcnt, 1) || kraft_bad(dcnt, 2)) return kInvalidData;
  return kOk;
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int n) { return __brev(v) >> (32 - n); }

// native validate_header_at(b, depth 6)
__device__ bool validate(const uint32_t* w, int top, long long N, long long b) {
  long long pos = b;
  int stored = 0;
  for (int d = 0; d < kDepth; d++) {
    if (N - pos < 3) return false;
    const int typ = (int)bits_at(w, top, pos + 1, 2);
    pos += 3;
    if (typ == 3 || (typ == 1 && d == 0)) return false;
    if (typ == 0) {
      pos = (pos + 7) & ~7LL;
      if (N - pos < 32) return false;
      const uint32_t v = peek32(w, top, pos);
      const int ln = (int)(v & 0xFFFFu), nln = (int)(v >> 16);
      pos += 32;
      if ((ln ^ nln) != 0xFFFF || ln == 0 || N - pos < 8 * ln) return false;
      pos += 8 * ln;
      stored++;
      continue;
    }
    if (typ == 2) return dynamic_ok(w, top, N, pos) == kOk;
    // a static follower: the fixed code by arithmetic
    int syms = 0;
    bool eob = false;
    while (syms < kStaticSyms) {
      if (N - pos == 0) return false;
      const uint32_t p = bits_at(w, top, pos, 9);
      int sym, nb;
      const uint32_t r7 = rev_bits(p & 0x7Fu, 7);
      if (r7 < 24) {
        sym = 256 + (int)r7;
        nb = 7;
      } else {
        const uint32_t r8 = rev_bits(p & 0xFFu, 8);
        if (r8 < 192) {
          sym = (int)r8 - 48;
          nb = 8;
        } else if (r8 < 200) {
          sym = 280 + (int)r8 - 192;
          nb = 8;
        } else {
          sym = 144 + (int)rev_bits(p, 9) - 400;
          nb = 9;
        }
      }
      if (N - pos < nb || sym >= 286) return false;
      if (sym == 256) {
        pos += nb;
        eob = true;
        break;
      }
      if (sym < 256) {
        pos += nb;
        syms++;
        continue;
      }
      const int extra = kLenExtra[sym - 257];
      if (N - pos < nb + extra) return false;
      pos += nb + extra;
      const int dsym = (int)rev_bits(bits_at(w, top, pos, 5), 5);
      if (dsym >= 30) return false;
      if (N - pos < 5 + kDistExtra[dsym]) return false;
      pos += 5 + kDistExtra[dsym];
      syms++;
    }
    if (!eob) return true;
  }
  return stored >= 2;
}

__global__ void __launch_bounds__(kFindThreads)
find_prefilter(const uint32_t* __restrict__ w, int top, long long N, const long long* __restrict__ lo,
               const long long* __restrict__ hi, int tiles, longlong2* __restrict__ surv, int cap,
               int* __restrict__ count) {
  const int k = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const long long b = lo[k] + (long long)t * kFindThreads + threadIdx.x;
  const bool pass = b < hi[k] && b < N && b >= 0 && prefilter(w, top, N, b);
  const unsigned m = __ballot_sync(kFull, pass);
  if (!m) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (pass) {
    const int idx = base + __popc(m & ((1u << lane) - 1u));
    if (idx < cap) surv[idx] = make_longlong2(b, k);
  }
}

__global__ void __launch_bounds__(kCheckThreads)
find_check(const uint32_t* __restrict__ w, int top, long long N, const longlong2* __restrict__ surv,
           int cap, const int* __restrict__ count, unsigned long long* best) {
  const long long i = (long long)blockIdx.x * kCheckThreads + threadIdx.x;
  if (i >= min(*count, cap)) return;
  const longlong2 s = surv[i];
  // a smaller offset already passed
  if ((unsigned long long)s.x >= *(volatile unsigned long long*)(best + s.y)) return;
  if (validate(w, top, N, s.x)) atomicMin(best + s.y, (unsigned long long)s.x);
}

// ---------------------------------------------------------------------------
// SP2: the marker decode, one warp a segment
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t entry(uint32_t kind, uint32_t extra, uint32_t nbits,
                                          uint32_t val) {
  return (kind << 28) | (extra << 22) | (nbits << 16) | val;
}
__device__ __forceinline__ uint32_t e_kind(uint32_t e) { return e >> 28; }
__device__ __forceinline__ int e_extra(uint32_t e) { return (e >> 22) & 0x3F; }
__device__ __forceinline__ int e_nbits(uint32_t e) { return (e >> 16) & 0x3F; }
__device__ __forceinline__ int e_val(uint32_t e) { return e & 0xFFFF; }

// (kind, extra, val) of symbol `sym`: kind_of 0 = code lengths, 1 =
// litlen, 2 = distance (K6's)
__device__ uint32_t k6_entry(int kind_of, int sym, int nbits) {
  if (kind_of == 0) return entry(kLit, 0, nbits, sym);
  if (kind_of == 1) {
    if (sym < 256) return entry(kLit, 0, nbits, sym);
    if (sym == 256) return entry(kEob, 0, nbits, 0);
    const int c = sym - 257;
    const int e = max(0, (c - 4) >> 2);
    const int base = c < 4 ? c + 3 : 3 + ((4 + (c & 3)) << e);
    if (c == 28) return entry(kMatch, 0, nbits, 258);
    return entry(c < 29 ? kMatch : kInvalid, e, nbits, base);
  }
  const int e = max(0, (sym >> 1) - 1);
  const int base = sym < 2 ? sym + 1 : 1 + ((2 + (sym & 1)) << e);
  if (sym < 30) return entry(kMatch, e, nbits, base);
  return entry(kInvalid, e, nbits, 0);
}

struct Tables {
  uint32_t ll[kLlCap];
  uint32_t d[kDCap];
  uint32_t cl[kClCap];
  int lens[320];
  uint16_t work[320];  // symbols in sorted order
  int cnt[16], offs[16], run[16], next[16], rem[16];
};
__shared__ Tables t;

__device__ __forceinline__ uint32_t huff_of(int k, int l) {
  return __brev((uint32_t)(t.next[l] + k - t.offs[l])) >> (32 - l);
}

// K6's warp-built two-level table, with native build_table's acceptance:
// code lengths must be complete; a litlen code may be incomplete with one
// symbol; a distance code with one symbol or none. The root is clamped to
// 9 (7 for code lengths) so that a long lone code takes a subtable and no
// lookup leaves the table, and a slot no code reaches carries native's
// root, min(max(R, minlen), maxlen) (R = 7, 10, 9), as its bit count.
__device__ int build_table(uint32_t* tab, int cap, int nsyms, const int* lens, int root_in,
                           int kind_of, bool* bad_out, int lane) {
  if (lane < 16) t.cnt[lane] = 0;
  __syncwarp();
  for (int i = lane; i < nsyms; i += 32) {
    const int l = lens[i];
    if (l > 0) atomicAdd(&t.cnt[l], 1);
  }
  __syncwarp();
  const int c = lane < 16 ? t.cnt[lane] : 0;
  const unsigned nz = __ballot_sync(kFull, lane >= 1 && c > 0);
  const int maxlen = nz ? 31 - __clz(nz) : 0;
  const int minlen = nz ? __ffs(nz) - 1 : 15;
  const int root = min(min(max(root_in, minlen), max(maxlen, 1)), kind_of == 0 ? 7 : 9);
  const int native_root =
      maxlen == 0 ? 1 : min(max(kind_of == 0 ? 7 : kind_of == 1 ? 10 : 9, minlen), maxlen);
  int incl = c;
  for (int dd = 1; dd < 16; dd <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, dd);
    if (lane >= dd) incl += y;
  }
  const int ncodes = __shfl_sync(kFull, incl, 15);
  int left = 1, code = 0, next_l = 0;
  for (int i = 1; i < 16; i++) {
    const int ci = __shfl_sync(kFull, c, i);
    const int cp = __shfl_sync(kFull, c, i - 1);
    left = left * 2 - ci;
    code = (code + cp) << 1;
    if (lane == i) next_l = code;
  }
  bool bad;
  if (kind_of == 0)
    bad = left != 0;
  else if (kind_of == 1)
    bad = left < 0 || (left > 0 && ncodes != 1);
  else
    bad = left < 0 || (left > 0 && ncodes > 1);
  if (lane < 16) {
    t.offs[lane] = incl - c;
    t.run[lane] = incl - c;
    t.next[lane] = next_l;
    t.rem[lane] = c;
  }
  const uint32_t inv = entry(kInvalid, 0, native_root, 0);
  for (int i = lane; i < cap; i += 32) tab[i] = inv;
  __syncwarp();

  const unsigned lt = (1u << lane) - 1u;
  bool sbad = false;
  for (int base = 0; base < nsyms; base += 32) {
    const int i = base + lane;
    const int l = i < nsyms ? lens[i] : 0;
    const unsigned grp = __match_any_sync(kFull, l);
    if (l > 0) {
      const int k = t.run[l] + __popc(grp & lt);
      t.work[k] = (uint16_t)i;
      if (l <= root && !bad) {
        const int huff = (int)huff_of(k, l);
        const uint32_t ent = k6_entry(kind_of, i, l);
        for (int f = (1 << root) - (1 << l); f >= 0; f -= 1 << l) {
          if (huff + f >= cap) {
            sbad = true;
            break;
          }
          tab[huff + f] = ent;
        }
      }
    }
    __syncwarp();
    if (l > 0 && (grp & lt) == 0) t.run[l] += __popc(grp);
    __syncwarp();
  }
  bad = bad || __any_sync(kFull, sbad);

  const int nshort = __shfl_sync(kFull, incl, root);
  const uint32_t rmask = (1u << root) - 1u;
  if (!bad && nshort < ncodes) {
    int used = 1 << root, low = -1;
    for (int k = nshort; k < ncodes; k++) {
      const int l = lens[t.work[k]];
      const uint32_t huff = huff_of(k, l);
      if ((int)(huff & rmask) != low) {
        int cc = l - root;
        int lft = 1 << cc;
        while (lft > 0 && cc + root < maxlen) {
          lft -= t.rem[cc + root];
          if (lft > 0 && cc + root < maxlen) {
            cc++;
            lft *= 2;
          }
        }
        const int sub_off = used;
        used += 1 << cc;
        low = (int)(huff & rmask);
        if (used > cap) {
          bad = true;
          break;
        }
        if (lane == 0) tab[low] = entry(kSub, cc, root, sub_off);
      }
      __syncwarp();
      if (lane == 0) t.rem[l]--;
      __syncwarp();
    }
  }
  if (!bad) {
    bool lbad = false;
    for (int k = nshort + lane; k < ncodes; k += 32) {
      const int sym = t.work[k];
      const int l = lens[sym];
      const uint32_t huff = huff_of(k, l);
      const uint32_t hdr = tab[huff & rmask];
      const int at = e_val(hdr) + (int)(huff >> root);
      const int step = 1 << (l - root);
      const uint32_t ent = k6_entry(kind_of, sym, l);
      for (int f = (1 << e_extra(hdr)) - step;; f -= step) {
        if (at + f >= cap || at + f < 0) {
          lbad = true;
          break;
        }
        tab[at + f] = ent;
        if (f <= 0) break;
      }
    }
    bad = __any_sync(kFull, lbad);
  }
  __syncwarp();
  *bad_out = bad;
  return root;
}

__device__ __forceinline__ uint32_t lookup(const uint32_t* tab, uint32_t w, uint32_t mask,
                                           int root) {
  const uint32_t e0 = tab[w & mask];
  if (__builtin_expect(e_kind(e0) == kSub, 0))
    return tab[e_val(e0) + (int)((w >> root) & ~(0xFFFFFFFFu << e_extra(e0)))];
  return e0;
}

// the compressed stream as a bit reservoir over clamped word reads (K6's)
struct Bits {
  const uint32_t* words;
  int top;
  uint64_t res;
  int nbits;
  long long nxt_i;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t word(long long i) const {
    i = i < 0 ? 0 : (i > top ? top : i);
    return __ldg(words + i);
  }
  __device__ void seek(long long bp) {
    const long long wi = bp >> 5;
    const int sh = (int)(bp & 31);
    res = ((uint64_t)word(wi) | ((uint64_t)word(wi + 1) << 32)) >> sh;
    nbits = 64 - sh;
    nxt_i = wi + 2;
    nxt = word(nxt_i);
  }
  __device__ __forceinline__ void refill() {
    if (__builtin_expect(nbits <= 32, 0)) {
      res |= (uint64_t)nxt << nbits;
      nbits += 32;
      nxt = word(++nxt_i);
    }
  }
  __device__ __forceinline__ uint32_t peek() const { return (uint32_t)res; }
  __device__ __forceinline__ void skip(int n) {
    res >>= n;
    nbits -= n;
  }
};

struct Spec {
  Bits rd;
  int lane;
  long long N, bp;
  int n, cap, need;
  long long hist;
  uint16_t* cells;

  __device__ void adv(int k) {
    rd.skip(k);
    bp += k;
  }
  __device__ uint32_t peek() {
    rd.refill();
    return rd.peek();
  }

  // native's stored block, after its 3 header bits
  __device__ int stored_block() {
    adv((int)(((bp + 7) & ~7LL) - bp));
    if (N - bp < 32) return kTruncated;
    const uint32_t w = peek();
    const int ln = (int)(w & 0xFFFFu), nln = (int)(w >> 16);
    adv(32);
    if ((ln ^ nln) != 0xFFFF) return kInvalidData;
    if ((long long)n + ln > cap) return kCap;
    if (N - bp < 8 * ln) return kTruncated;
    const long long off = bp >> 3;
    for (int j = lane; j < ln; j += 32) {
      const long long q = off + j;
      cells[n + j] = (uint16_t)((rd.word(q >> 2) >> ((q & 3) << 3)) & 0xFFu);
    }
    __syncwarp();
    n += ln;
    bp += (long long)ln << 3;
    rd.seek(bp);
    return kOk;
  }

  __device__ void fixed_lens() {
    for (int i = lane; i < 320; i += 32)
      t.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
    __syncwarp();
  }

  // native parse_dynamic_tables up to the two code-length sets, which it
  // leaves in t.lens[0, nlen) and t.lens[288, 288 + ndist)
  __device__ int dynamic_header(int* nlen_out, int* ndist_out) {
    if (N - bp < 14) return kTruncated;
    const uint32_t w = peek();
    const int nlen = (int)(w & 31u) + 257;
    const int ndist = (int)((w >> 5) & 31u) + 1;
    const int hclen = (int)((w >> 10) & 15u) + 4;
    adv(14);
    if (nlen > 286 || ndist > 30) return kInvalidData;
    if (lane < 19) t.lens[lane] = 0;
    __syncwarp();
    for (int i = 0; i < hclen; i++) {
      if (N - bp < 3) return kTruncated;
      const int v = (int)(peek() & 7u);
      if (lane == 0) t.lens[kClOrder[i]] = v;
      adv(3);
    }
    __syncwarp();
    bool clbad;
    const int clroot = build_table(t.cl, kClCap, 19, t.lens, kClRoot, 0, &clbad, lane);
    if (clbad) return kInvalidData;
    const uint32_t cl_mask = (1u << clroot) - 1u;
    const int total = nlen + ndist;
    int i = 0, prev = 0;
    while (i < total) {
      if (N - bp < 7) return kTruncated;
      const uint32_t w1 = peek();
      const uint32_t e = t.cl[w1 & cl_mask];
      const int sym = e_val(e);
      const int nb = e_nbits(e);
      if (sym < 16) {
        if (lane == 0) t.lens[i] = sym;
        adv(nb);
        i++;
        prev = sym;
        continue;
      }
      const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (N - bp < nb + ebits) return kTruncated;
      adv(nb);
      if (sym == 16 && i == 0) return kInvalidData;
      const int r = (int)((w1 >> nb) & ((1u << ebits) - 1u)) + (sym == 18 ? 11 : 3);
      adv(ebits);
      const int v = sym == 16 ? prev : 0;
      if (i + r > total) return kInvalidData;
      for (int j = lane; j < r; j += 32) t.lens[i + j] = v;
      i += r;
      prev = v;
    }
    __syncwarp();
    if (lane == 0)
      for (int j = 31; j >= 0; j--)
        if (j < ndist) t.lens[288 + j] = t.lens[nlen + j];
    __syncwarp();
    *nlen_out = nlen;
    *ndist_out = ndist;
    return t.lens[256] == 0 ? kInvalidData : kOk;
  }

  // a copy of `length` cells from `dist` back, at n (every source at or
  // past 0): 32 cells a step, K6's three cases
  __device__ void copy_cells(int length, int dist) {
    const int at = n;
    if (dist == 1) {
      const uint16_t v = cells[at - 1];
#pragma unroll 1
      for (int k = lane; k < length; k += 32) cells[at + k] = v;
    } else if (dist >= 32 || dist >= length) {
#pragma unroll 1
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) cells[at + k + lane] = cells[at - dist + k + lane];
        __syncwarp();
      }
    } else {
      int r = lane;
      while (r >= dist) r -= dist;
      int step = 32;
      while (step >= dist) step -= dist;
#pragma unroll 1
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) cells[at + k + lane] = cells[at - dist + r];
        r += step;
        if (r >= dist) r -= dist;
      }
    }
    __syncwarp();
    n += length;
  }

  __device__ int coded_block(int nlen, int ndist) {
    bool b1, b2;
    const int ll_root = build_table(t.ll, kLlCap, nlen, t.lens, kLlRoot, 1, &b1, lane);
    if (b1) return kInvalidData;
    const int d_root = build_table(t.d, kDCap, ndist, t.lens + 288, kDRoot, 2, &b2, lane);
    if (b2) return kInvalidData;
    const uint32_t ll_mask = (1u << ll_root) - 1u;
    const uint32_t d_mask = (1u << d_root) - 1u;
    for (;;) {
      if (N - bp == 0) return kTruncated;
      const uint32_t w = peek();
      const uint32_t e = lookup(t.ll, w, ll_mask, ll_root);
      const int nb = e_nbits(e);
      if (N - bp < nb) return kTruncated;
      const uint32_t kind = e_kind(e);
      if (kind == kLit) {
        if (n >= cap) return kCap;
        cells[n] = (uint16_t)e_val(e);  // every lane, the same cell and value
        adv(nb);
        n++;
        continue;
      }
      if (kind == kEob) {
        adv(nb);
        return kOk;
      }
      if (kind != kMatch) return kInvalidData;
      const int lext = e_extra(e);
      if (N - bp < nb + lext) return kTruncated;
      int length = e_val(e) + (int)((w >> nb) & ~(0xFFFFFFFFu << lext));
      adv(nb + lext);
      const uint32_t w2 = peek();
      const uint32_t de = lookup(t.d, w2, d_mask, d_root);
      if (e_kind(de) != kMatch) return kInvalidData;
      const int dnb = e_nbits(de);
      const int dext = e_extra(de);
      if (N - bp < dnb + dext) return kTruncated;
      const int dist = e_val(de) + (int)((w2 >> dnb) & ~(0xFFFFFFFFu << dext));
      adv(dnb + dext);
      if ((long long)dist > (long long)n + hist) return kInvalidData;
      if ((long long)n + length > cap) return kCap;
      if (dist > n) {  // markers: the leading run that reaches before the segment
        const int nm = min(length, dist - n);
        need = max(need, dist - n);
        for (int j = lane; j < nm; j += 32) cells[n + j] = (uint16_t)(256 + dist - n - j - 1);
        __syncwarp();
        n += nm;
        length -= nm;
      }
      if (length) copy_cells(length, dist);
    }
  }
};

__global__ void __launch_bounds__(32)
spec_decode(const uint32_t* __restrict__ words, int W, long long N,
            const long long* __restrict__ meta, uint16_t* __restrict__ cells_all,
            long long* __restrict__ recs_all, long long* __restrict__ st) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const long long* m = meta + (size_t)k * kMeta;
  const long long start = m[0], stop = m[1];
  const int cap = (int)m[2];
  long long* rec = recs_all + 2 * m[5];
  const int rec_cap = (int)m[6];
  Spec sp{Bits{words, W - 1, 0, 0, 0, 0}, lane, N, start, 0, cap, 0, m[3], cells_all + m[4]};
  int why = kOk, fin = 0, nrec = 0, ovf = 0;
  if (start < 0) {
    why = kNoStart;
  } else {
    sp.rd.seek(start);
    bool first = true;
    for (;;) {
      if (!first && sp.bp >= stop) break;
      first = false;
      if (nrec < rec_cap) {
        if (lane == 0) {
          rec[2 * nrec] = sp.bp;
          rec[2 * nrec + 1] = sp.n;
        }
        nrec++;
      } else {
        ovf = 1;
      }
      if (N - sp.bp < 3) {
        why = kTruncated;
        break;
      }
      const uint32_t w = sp.peek();
      const int final_ = (int)(w & 1u);
      const int typ = (int)((w >> 1) & 3u);
      sp.adv(3);
      if (typ == 0) {
        why = sp.stored_block();
      } else if (typ == 3) {
        why = kInvalidData;
      } else {
        int nlen = 288, ndist = 32;
        if (typ == 1)
          sp.fixed_lens();
        else
          why = sp.dynamic_header(&nlen, &ndist);
        if (why == kOk) why = sp.coded_block(nlen, ndist);
      }
      if (why != kOk) break;
      if (final_) {
        fin = 1;
        break;
      }
    }
  }
  if (lane == 0) {
    long long* so = st + (size_t)k * kStatus;
    so[0] = sp.n;
    so[1] = why == kOk ? sp.bp : -1;
    so[2] = fin;
    so[3] = why;
    so[4] = sp.need;
    so[5] = nrec;
    so[6] = ovf;
    so[7] = start;
  }
}

// ---------------------------------------------------------------------------
// SP3: the marker resolve
// ---------------------------------------------------------------------------

__global__ void resolve_init(const uint16_t* __restrict__ cells, int n,
                             const long long* __restrict__ seg_ofs, int E, int* __restrict__ ptr) {
  const long long i = (long long)blockIdx.x * kResolveThreads + threadIdx.x;
  if (i >= n) return;
  const int c = cells[i];
  if (c < 256) {
    ptr[i] = (int)i;
    return;
  }
  int lo = 0, hi = E - 1;  // the last segment that starts at or before i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_ofs[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  long long src = seg_ofs[lo] - (c - 255);
  src = src < 0 ? 0 : (src > n - 1 ? n - 1 : src);
  ptr[i] = (int)src;
}

__global__ void resolve_jump(const int* __restrict__ a, int* __restrict__ b, int n) {
  const long long i = (long long)blockIdx.x * kResolveThreads + threadIdx.x;
  if (i < n) b[i] = a[a[i]];
}

__global__ void resolve_narrow(const uint16_t* __restrict__ cells, const int* __restrict__ ptr,
                               int n, uint8_t* __restrict__ out, int* flag) {
  const long long i = (long long)blockIdx.x * kResolveThreads + threadIdx.x;
  if (i >= n) return;
  const int c = cells[ptr[i]];
  if (c >= 256) atomicOr(flag, 1);
  out[i] = (uint8_t)c;  // an unresolved marker's low byte, as the plain version
}


#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// SP1, the block finder: a tile's pre-filter, then a block a segment checks
// its survivors in offset order (zrs_block_find; find_prefilter and
// find_check above are the first design, zrs_block_find_thread)
// ---------------------------------------------------------------------------

constexpr int kTileWords = 256;  // a pre-filter tile: a word of 32 offsets a thread (a u16 offset)
constexpr int kGroup = 256;      // the check: survivors a round, a thread each

IS_INL uint32_t funnel(uint32_t lo, uint32_t hi, int s) {  // 32 bits of hi:lo from bit s < 32
#ifdef __CUDACC__
  return __funnelshift_r(lo, hi, s);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
#endif
}

IS_INL int low_bit(uint32_t m) {
#ifdef __CUDACC__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

IS_INL int popcount(uint32_t m) {
#ifdef __CUDACC__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

IS_INL void add64(long long* p, long long v) {
#ifdef __CUDACC__
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
#else
  *p += v;
#endif
}

IS_INL int block_any(int v) {
#ifdef __CUDACC__
  return __syncthreads_or(v);
#else
  return v;
#endif
}

// the exclusive scan of v over the block's threads in order (a multiple of
// 32 of them; thread 0 of 1 on the host), the sum in *total. Every thread
// calls it; wsum is 32 ints of shared memory.
IS_INL int block_scan(int v, int* wsum, int* total, int tid, int nthr) {
#ifdef __CUDACC__
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  *total = wsum[nw - 1];
  const int r = (warp ? wsum[warp - 1] : 0) + x - v;
  __syncthreads();  // wsum is free for the next scan
  return r;
#else
  (void)wsum, (void)tid, (void)nthr;
  *total = v;
  return 0;
#endif
}

// the Kraft sum of a code-length code, 2^(7 - len) over the 3-bit lengths
// of y (a length 0 adds nothing): 128 exactly when the code is complete,
// more when it is over-subscribed at any length
IS_INL uint32_t cl_kraft(uint64_t y) {
  uint32_t sum = 0;
#ifdef __CUDACC__
#pragma unroll
  for (int g = 0; g < 5; g++) {  // four lengths a PRMT, each picking its byte 2^(7 - len)
    const uint32_t v = (uint32_t)(y >> (12 * g)) & 0xFFFu;
    const uint32_t sel =
        (v & 7u) | ((v << 1) & 0x70u) | ((v << 2) & 0x700u) | ((v << 3) & 0x7000u);
    sum = __dp4a(__byte_perm(0x10204000u, 0x01020408u, sel), 0x01010101u, sum);
  }
#else
  for (int i = 0; i < 19; i++) {
    const uint32_t l = (uint32_t)(y >> (3 * i)) & 7u;
    sum += l ? 128u >> l : 0u;
  }
#endif
  return sum;
}

// the pre-filter over the 32 offsets b0 + s of one word (w0-w3 the words
// from b0's on, `valid` the offsets in range), a bit a survivor:
// prefilter_plain's checks, so every offset validate_header_at accepts
// passes. The stored and dynamic types come from two shifts of the word
// (bits b + 1 and b + 2); each such offset reads its fields from three
// funnel shifts.
IS_INL uint32_t prefilter_word(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, long long b0,
                               long long N, uint32_t valid) {
  const uint32_t t1 = funnel(w0, w1, 1), t2 = funnel(w0, w1, 2);
  uint32_t dyn = ~t1 & t2 & valid, sto = ~t1 & ~t2 & valid, keep = 0;
  while (dyn) {
    const int s = low_bit(dyn);
    dyn &= dyn - 1;
    const uint32_t p0 = funnel(w0, w1, s), p1 = funnel(w1, w2, s), p2 = funnel(w2, w3, s);
    const uint32_t h = (p0 >> 3) & 0x3FFFu;
    const int ncode = (int)(h >> 10) + 4;
    if ((h & 31u) > 29 || ((h >> 5) & 31u) > 29 || b0 + s + 17 + 3 * ncode > N) continue;
    const uint64_t y = (((uint64_t)funnel(p1, p2, 17) << 32) | funnel(p0, p1, 17)) &
                       ((1ull << (3 * ncode)) - 1);
    if (cl_kraft(y) == 128) keep |= 1u << s;
  }
  while (sto) {
    const int s = low_bit(sto);
    sto &= sto - 1;
    const int d = ((s + 10) & ~7) - s;  // LEN at the byte boundary past the 3 header bits
    const uint32_t v = funnel(funnel(w0, w1, s), funnel(w1, w2, s), d);
    if (b0 + s + d + 32 <= N && ((v & 0xFFFFu) ^ (v >> 16)) == 0xFFFFu && (v & 0xFFFFu) != 0)
      keep |= 1u << s;
  }
  return keep;
}

// segment k's offsets [a, e): at or past 0, within [lo, hi), b + 3 <= N.
// ops is int64 [3T + 1]: lo [T], hi [T], each segment's first tile [T + 1]
// (its tiles of kTileWords words from word a >> 5 on; tile_counts in
// ops/kernels/speculative_kernel.py counts them).
IS_INL void seg_range(const long long* ops, int T, int k, long long N, long long* a, long long* e) {
  *a = ops[k] < 0 ? 0 : ops[k];
  *e = ops[T + k] < N - 2 ? ops[T + k] : N - 2;
}

// the segment of tile g: the last k whose first tile is at or before g
IS_INL int tile_segment(const long long* first, int T, int g) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= g)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// the bits of offsets b0 + s that lie in [a, e)
IS_INL uint32_t range_mask(long long b0, long long a, long long e) {
  const long long l = a - b0 < 0 ? 0 : a - b0, h = e - b0 > 32 ? 32 : e - b0;
  if (h <= l) return 0;
  return (h == 32 ? kFull : (1u << h) - 1u) & ~((1u << l) - 1u);
}

// tile g's pre-filter: its words staged (stage: kTileWords + 4 words), a
// thread kTileWords / nthr consecutive words, the survivors in offset order
// into the tile's room of u16 offsets from its first word's bit 0, at most
// `room` of them, the exact count into counts[g]
IS_DEV void find_tile(const uint32_t* w, int top, long long N, const long long* ops, int T, int g,
                      uint16_t* surv, int room, int* counts, uint32_t* stage, int* wsum, int tid,
                      int nthr) {
  const long long* first = ops + 2 * T;
  const int k = tile_segment(first, T, g);
  long long a, e;
  seg_range(ops, T, k, N, &a, &e);
  const long long wb = (a >> 5) + (g - first[k]) * kTileWords;
  for (int i = tid; i < kTileWords + 4; i += nthr) stage[i] = word_at(w, top, wb + i);
  block_sync();
  const int per = kTileWords / nthr, j0 = tid * per;
  uint32_t keep0 = 0;
  int c = 0;
  for (int j = j0; j < j0 + per; j++) {
    const long long b0 = (wb + j) * 32;
    keep0 = prefilter_word(stage[j], stage[j + 1], stage[j + 2], stage[j + 3], b0, N,
                           range_mask(b0, a, e));
    c += popcount(keep0);
  }
  int total;
  int r = block_scan(c, wsum, &total, tid, nthr);
  if (tid == 0) counts[g] = total;
  uint16_t* out = surv + (size_t)g * room;
  for (int j = j0; j < j0 + per && r < room; j++) {
    const long long b0 = (wb + j) * 32;
    uint32_t keep = per == 1 ? keep0
                             : prefilter_word(stage[j], stage[j + 1], stage[j + 2], stage[j + 3],
                                              b0, N, range_mask(b0, a, e));
    for (; keep && r < room; keep &= keep - 1, r++) out[r] = (uint16_t)(j * 32 + low_bit(keep));
  }
}

// stream bits from a position, 64 at a time in a register (at least 33
// after every step); reads past the words see zeros
struct BitBuf {
  const uint32_t* w;
  int top;
  long long wi;
  uint64_t acc;
  int n;
  IS_INL void init(const uint32_t* w_, int top_, long long pos) {
    w = w_;
    top = top_;
    wi = pos >> 5;
    acc = word_at(w, top, wi++) >> (pos & 31);
    n = 32 - (int)(pos & 31);
    acc |= (uint64_t)word_at(w, top, wi++) << n;
    n += 32;
  }
  IS_INL uint32_t peek(int k) const { return (uint32_t)acc & ((1u << k) - 1u); }
  IS_INL void skip(int k) {
    acc >>= k;
    n -= k;
    if (n <= 32) {
      acc |= (uint64_t)word_at(w, top, wi++) << n;
      n += 32;
    }
  }
};

// native parse_dynamic_tables at `pos` (after the block's 3 header bits),
// without building the tables: 0 when it would accept the header. The
// code lengths decode through this thread's 128 entries of the
// code-length code by 7-bit peeks (symbol | length << 5), entry r at
// tab[r * kGroup + tid] (a warp's 32 tables interleaved, so that a fill
// of one slot by every lane touches 8 banks once), and both codes' Kraft
// sums are kept as integers (2^(15 - len) a length and the number of
// codes), which is all native's build_table checks.
IS_DEV int dynamic_check(const uint32_t* w, int top, long long N, long long pos, uint8_t* tab,
                         int tid) {
  if (N - pos < 14) return kTruncated;
  BitBuf bb;
  bb.init(w, top, pos);
  const uint32_t h = bb.peek(14);
  const int nlen = (int)(h & 31u) + 257, ndist = (int)((h >> 5) & 31u) + 1;
  const int ncode = (int)((h >> 10) & 15u) + 4;
  bb.skip(14);
  pos += 14;
  if (nlen > 286 || ndist > 30) return kInvalidData;
  uint64_t lens = 0;  // the code-length code's lengths by symbol, 3 bits each
  for (int i = 0; i < ncode; i++) {
    if (N - pos < 3) return kTruncated;
    lens |= (uint64_t)bb.peek(3) << (3 * kClOrder[i]);
    bb.skip(3);
    pos += 3;
  }
  uint64_t cnt = 0;  // its codes a length, 8 bits each
  for (int s = 0; s < 19; s++) {
    const int l = (int)(lens >> (3 * s)) & 7;
    if (l) cnt += 1ull << (8 * l);
  }
  uint32_t kraft = 0;
  for (int l = 1; l < 8; l++) kraft += (uint32_t)((cnt >> (8 * l)) & 0xFFu) << (7 - l);
  if (kraft != 128) return kInvalidData;
  uint64_t next = 0;  // canonical next codes a length, 8 bits each
  uint32_t code = 0;
  for (int l = 1; l < 8; l++) {
    code = (code + (uint32_t)((cnt >> (8 * (l - 1))) & 0xFFu)) << 1;
    next |= (uint64_t)code << (8 * l);
  }
  for (int s = 0; s < 19; s++) {
    const int l = (int)(lens >> (3 * s)) & 7;
    if (!l) continue;
    const uint32_t c = (uint32_t)(next >> (8 * l)) & 0xFFu;
    next += 1ull << (8 * l);
    for (uint32_t r = bit_reverse(c, l); r < 128; r += 1u << l)
      tab[r * kGroup + tid] = (uint8_t)(s | (l << 5));
  }
  const int total = nlen + ndist;
  int have = 0, prev = 0, len256 = 0, n_lit = 0, n_dist = 0;
  uint32_t k_lit = 0, k_dist = 0;
  while (have < total) {
    if (N - pos < 7) return kTruncated;
    const int ent = tab[bb.peek(7) * kGroup + tid];
    const int sym = ent & 31, nb = ent >> 5;
    int rep, fill;
    if (sym < 16) {
      bb.skip(nb);
      pos += nb;
      rep = 1;
      fill = sym;
    } else {
      const int extra = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (N - pos < nb + extra) return kTruncated;
      const int x = (int)(bb.peek(nb + extra) >> nb);
      bb.skip(nb + extra);
      pos += nb + extra;
      if (sym == 16) {
        if (have == 0) return kInvalidData;
        rep = 3 + x;
        fill = prev;
      } else {
        rep = (sym == 17 ? 3 : 11) + x;
        fill = 0;
      }
      if (have + rep > total) return kInvalidData;
    }
    const int in_lit = (have + rep < nlen ? have + rep : nlen) - have;
    const int lit = in_lit > 0 ? in_lit : 0;
    if (fill) {
      k_lit += (uint32_t)lit << (15 - fill);
      k_dist += (uint32_t)(rep - lit) << (15 - fill);
      n_lit += lit;
      n_dist += rep - lit;
    }
    if (have <= 256 && 256 < have + rep) len256 = fill;
    have += rep;
    prev = fill;
  }
  // build_table's refusals: over-subscribed, or incomplete with other than
  // one litlen code, or with more than one distance code
  const bool lit_bad = k_lit > 32768u || (k_lit < 32768u && n_lit != 1);
  const bool dist_bad = k_dist > 32768u || (k_dist < 32768u && n_dist > 1);
  return len256 == 0 || lit_bad || dist_bad ? kInvalidData : kOk;
}

// native validate_header_at(b, depth 6), its dynamic link by dynamic_check
IS_DEV bool validate_chain(const uint32_t* w, int top, long long N, long long b, uint8_t* tab,
                           int tid) {
  long long pos = b;
  int stored = 0;
  for (int d = 0; d < kDepth; d++) {
    if (N - pos < 3) return false;
    const int typ = (int)bits_at(w, top, pos + 1, 2);
    pos += 3;
    if (typ == 3 || (typ == 1 && d == 0)) return false;
    if (typ == 0) {
      pos = (pos + 7) & ~7LL;
      if (N - pos < 32) return false;
      const uint32_t v = peek32(w, top, pos);
      const int ln = (int)(v & 0xFFFFu), nln = (int)(v >> 16);
      pos += 32;
      if ((ln ^ nln) != 0xFFFF || ln == 0 || N - pos < 8 * ln) return false;
      pos += 8 * ln;
      stored++;
      continue;
    }
    if (typ == 2) return dynamic_check(w, top, N, pos, tab, tid) == kOk;
    // a static follower: the fixed code by arithmetic, its bits from a
    // register buffer (a load a word, not two a symbol)
    BitBuf bb;
    bb.init(w, top, pos);
    int syms = 0;
    bool eob = false;
    while (syms < kStaticSyms) {
      if (N - pos == 0) return false;
      const uint32_t p = bb.peek(9);
      int sym, nb;
      const uint32_t r7 = bit_reverse(p & 0x7Fu, 7);
      if (r7 < 24) {
        sym = 256 + (int)r7;
        nb = 7;
      } else {
        const uint32_t r8 = bit_reverse(p & 0xFFu, 8);
        if (r8 < 192) {
          sym = (int)r8 - 48;
          nb = 8;
        } else if (r8 < 200) {
          sym = 280 + (int)r8 - 192;
          nb = 8;
        } else {
          sym = 144 + (int)bit_reverse(p, 9) - 400;
          nb = 9;
        }
      }
      if (N - pos < nb || sym >= 286) return false;
      if (sym == 256) {
        pos += nb;
        eob = true;
        break;
      }
      if (sym < 256) {
        bb.skip(nb);
        pos += nb;
        syms++;
        continue;
      }
      const int extra = kLenExtra[sym - 257];
      if (N - pos < nb + extra) return false;
      bb.skip(nb + extra);
      pos += nb + extra;
      const int dsym = (int)bit_reverse(bb.peek(5), 5);
      if (dsym >= 30) return false;
      if (N - pos < 5 + kDistExtra[dsym]) return false;
      bb.skip(5 + kDistExtra[dsym]);
      pos += 5 + kDistExtra[dsym];
      syms++;
    }
    if (!eob) return true;
  }
  return stored >= 2;
}

// the check's scratch (shared memory on the card)
struct CheckScratch {
  uint8_t tab[128 * kGroup];  // each thread's code-length code by 7-bit peeks, interleaved
  int prefix[kGroup];        // a window of tiles: the offsets of their survivors
  int wsum[32];
  int pick[2];  // a group's smallest passing survivor, two groups in turn
  long long found;
};

// segment k's check: its survivors in offset order, nthr at a time, a
// thread each, up to the first group in which one passes (the smallest
// wins). res[k] gets the offset or -1, res[T + k] 1 where a tile of the
// segment outgrew its room (the survivors past the room were not kept, so
// the host reruns with room for all). stats (or null) gets the segment's
// survivors and the ones it checked.
IS_DEV void check_segment(const uint32_t* w, int top, long long N, const long long* ops, int T,
                          int k, const uint16_t* surv, int room, const int* counts, long long* res,
                          long long* stats, CheckScratch* sc, int tid, int nthr) {
  const long long* first = ops + 2 * T;
  const int t0 = (int)first[k], t1 = (int)first[k + 1];
  long long a, e;
  seg_range(ops, T, k, N, &a, &e);
  const long long wb = a >> 5;
  if (tid == 0) sc->pick[0] = INT_MAX;
  int over = 0, counted = 0;
  for (int t = t0 + tid; t < t1; t += nthr) {
    over |= counts[t] > room;
    counted += counts[t];
  }
  over = block_any(over);
  block_scan(counted, sc->wsum, &counted, tid, nthr);
  long long best = -1, checked = 0;
  int group = 0;
  for (int win = t0; win < t1 && best < 0; win += nthr) {
    const int nt = t1 - win < nthr ? t1 - win : nthr;
    int c = 0, total;
    if (tid < nt) c = counts[win + tid] < room ? counts[win + tid] : room;
    const int p = block_scan(c, sc->wsum, &total, tid, nthr);
    if (tid < nt) sc->prefix[tid] = p;
    block_sync();
    for (int g0 = 0; g0 < total && best < 0; g0 += nthr) {
      const int j = g0 + tid;
      bool pass = false;
      long long b = 0;
      if (j < total) {
        int lo = 0, hi = nt - 1;  // the window's last tile whose survivors start at or before j
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sc->prefix[mid] <= j)
            lo = mid;
          else
            hi = mid - 1;
        }
        b = (wb + (long long)(win - t0 + lo) * kTileWords) * 32 +
            surv[(size_t)(win + lo) * room + (j - sc->prefix[lo])];
        pass = validate_chain(w, top, N, b, sc->tab, tid);
      }
      int* pk = sc->pick + (group & 1);
      if (pass) s_min(pk, j);
      block_sync();
      const int pick = *pk;
      if (tid == 0) sc->pick[~group & 1] = INT_MAX;  // the next group's, read before the last barrier
      if (pass && j == pick) sc->found = b;
      block_sync();
      if (pick != INT_MAX) best = sc->found;
      checked += total - g0 < nthr ? total - g0 : nthr;
      group++;
    }
  }
  if (tid == 0) {
    res[k] = best;
    res[T + k] = over;
    if (stats) {
      add64(stats, counted);
      add64(stats + 1, checked);
    }
  }
}

// ---------------------------------------------------------------------------
// SP3, the marker resolve: a chase a cell (zrs_spec_resolve; resolve_init,
// resolve_jump and resolve_narrow above are the first design,
// zrs_spec_resolve_jump)
// ---------------------------------------------------------------------------

constexpr int kHopBudget = 16;    // hops a chain takes in the first launch
constexpr int kSegStage = 6144;   // seg_ofs entries held in shared memory (48 KiB)
constexpr int kResolveStats = 4;  // markers, hops, most hops, pending after the first launch

// the segment of cell q: the last s < E whose offset is at or before q (0
// when none is)
IS_INL int seg_of(const long long* so, int E, long long q) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (so[mid] <= q)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// the resolve's counters a thread, summed (the most hops: the largest)
// into stats at the end of a launch
struct HopStats {
  long long v[kResolveStats];
};

IS_INL void flush_stats(long long* stats, HopStats& hs) {
  if (!stats) return;
#ifdef __CUDACC__
  for (int f = 0; f < kResolveStats; f++) {
    long long x = hs.v[f];
    for (int o = 16; o; o >>= 1) {
      const long long y = __shfl_xor_sync(kFull, x, o);
      x = f == 2 ? (x > y ? x : y) : x + y;
    }
    if ((threadIdx.x & 31) == 0) {
      if (f == 2)
        atomicMax(stats + f, x);
      else
        atomicAdd((unsigned long long*)(stats + f), (unsigned long long)x);
    }
  }
#else
  for (int f = 0; f < kResolveStats; f++)
    stats[f] = f == 2 ? (hs.v[f] > stats[f] ? hs.v[f] : stats[f]) : stats[f] + hs.v[f];
#endif
}

// cell i's byte from `work` (a copy of the cells): its marker's chain
// followed, q <- seg_ofs[seg(q)] - back(q) clamped to the cells, until a
// literal, a cell that is its own target (a marker at cell 0 that clamps
// onto itself), `limit` hops (the plain version's 2^rounds: the pointer
// jumping's end), or `budget` hops (INT_MAX: the second launch). A hop
// lands in the segment before its source's in most streams (a reference
// reaches 32 KiB back), which is tried before a binary search. Writes
// out[i] and returns true, or false when the budget ran out (the cell
// stays a marker: pending). With `memo` (where seg_ofs[0] <= 0: every
// chain then ends within its segments' count of hops, under `limit`) a
// resolved marker's byte goes back into work[i] as a literal, so that a
// later chain through it ends there; a racing read sees the marker or its
// byte, which end the chain alike. A chain that ends on a marker sets
// ctl[0].
IS_DEV bool resolve_one(uint16_t* work, int n, const long long* so, int E, long long limit,
                        int budget, bool memo, uint8_t* out, int* ctl, int i, HopStats& hs) {
  int c = work[i];
  if (c < 256) {
    out[i] = (uint8_t)c;
    return true;
  }
  if (budget != INT_MAX) hs.v[0]++;  // a marker, counted on the first launch
  int q = i, s = seg_of(so, E, i);
  long long h = 0;
  for (int k = 0; c >= 256 && h < limit; k++) {
    long long t = so[s] - (c - 255);
    t = t < 0 ? 0 : (t > n - 1 ? n - 1 : t);
    if (t == q) break;
    if (k == budget) {
      hs.v[1] += h;
      hs.v[3]++;
      return false;
    }
    s = s > 0 && so[s - 1] <= t && t < so[s] ? s - 1 : seg_of(so, E, t);
    q = (int)t;
    c = work[q];
    h++;
  }
  hs.v[1] += h;
  hs.v[2] = h > hs.v[2] ? h : hs.v[2];
  if (c >= 256) s_or((uint32_t*)ctl, 1u);
  out[i] = (uint8_t)c;
  if (memo) work[i] = (uint16_t)(c & 0xFF);
  return true;
}
// ---------------------------------------------------------------------------
// SP2: the marker decode, a thread block a row (spec_sync)
// ---------------------------------------------------------------------------

constexpr int P_HEAD = 0, P_BODY = 1, P_DONE = 2;  // the head: at a header, in a body, done
constexpr int kNext = -1;  // a header step's outcome besides A_STOP and A_COPY

// the head's scratch (shared memory on the card)
struct HeadScratch {
  uint16_t lens[320];    // the block's code lengths: litlen [0, 288), distance [288, 320)
  uint16_t sorted[320];  // the same order as Body::sorted, for the serial decode
  uint16_t cl[19], cl_sorted[19];
  uint32_t ct[128];  // the code-length code by 7-bit peeks: symbol | length << 16
  int32_t cl_cnt[16], cnt_ll[16], cnt_d[16];
};

// native build_table's refusal from a code's counts: kind 0 code lengths
// (complete), 1 litlen (incomplete with one code), 2 distance (one code
// or none)
IS_INL bool code_bad(const int32_t* cnt, int kind) {
  int left = 1, ncodes = 0;
  for (int l = 1; l < 16; l++) {
    left = 2 * left - cnt[l];
    ncodes += cnt[l];
    if (left < 0) return true;
  }
  if (kind == 0) return left != 0;
  if (kind == 1) return left > 0 && ncodes != 1;
  return left > 0 && ncodes > 1;
}

// the counts of lens[0, n) and its symbols in canonical order, on one lane
IS_INL void canon_order(const uint16_t* lens, int n, int32_t* cnt, uint16_t* sorted) {
  int offs[16];
  for (int l = 0; l < 16; l++) cnt[l] = 0;
  for (int s = 0; s < n; s++) cnt[lens[s]]++;
  cnt[0] = 0;
  offs[1] = 0;
  for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + cnt[l];
  for (int s = 0; s < n; s++)
    if (lens[s]) sorted[offs[lens[s]]++] = (uint16_t)s;
}

// SP2's head: native spec_decode's control flow (Spec's, the plain
// version's), all lanes of warp 0 on the same values. It runs a row's
// block headers (the stop rule, the records, stored blocks, fixed and
// dynamic headers with native's acceptance) and hands each coded body
// with more than kMargin + kMinBody bits of the stream left to the
// block (A_BODY), a long stored span too (A_COPY). It decodes a body's
// symbols itself in the stream's last bits and from the first token the
// block refused (a bad code, a reference past n + hist, a cell past cap):
// a canonical decode over the code lengths' counts, with native's
// truncation and error order.
struct SpecHead {
  // the head parses each header between windows: parsed during the
  // expansion, as IS's head does, the launch measured slower (PERF.md §6)
  static constexpr bool kSpeculates = false;
  struct Saved {};

  const uint32_t* words;
  int top;
  long long N, start, stop, hist, bp, pending;
  uint16_t* cells;
  long long* rec;
  HeadScratch* sc;
  int cap, rec_cap, n, need, nrec, ovf, why, fin, lane, lanes, phase, gen, maxlen_ll;
  bool first, final_, no_par, par, canon_ready;

  IS_INL uint32_t word(long long i) const { return word_at(words, top, i); }
  IS_INL uint32_t peek() const { return peek32(words, top, bp); }

  IS_DEV void load(const uint32_t* words_, int W, long long N_, const long long* m,
                   uint16_t* cells_all, long long* recs_all, HeadScratch* sc_, int lane_,
                   int lanes_, bool par_) {
    words = words_;
    top = W - 1;
    N = N_;
    start = m[0];
    stop = m[1];
    cap = (int)m[2];
    hist = m[3];
    cells = cells_all + m[4];
    rec = recs_all + 2 * m[5];
    rec_cap = (int)m[6];
    sc = sc_;
    lane = lane_;
    lanes = lanes_;
    par = par_;
    bp = start;
    pending = -1;
    n = need = nrec = ovf = fin = gen = maxlen_ll = 0;
    why = start < 0 ? kNoStart : kOk;
    phase = start < 0 ? P_DONE : P_HEAD;
    first = true;
    final_ = no_par = canon_ready = false;
  }

  IS_DEV void finish(int why_) {
    why = why_;
    phase = P_DONE;
  }

  // a block's end: true where the row ends with it
  IS_DEV bool end_block() {
    if (final_) {
      fin = 1;
      finish(kOk);
      return true;
    }
    phase = P_HEAD;
    return false;
  }

  // the litlen and distance codes' counts (lane-strided), their
  // acceptance, and a new generation of code lengths for the body's table
  IS_DEV int take_lens() {
    for (int l = lane; l < 16; l += lanes) sc->cnt_ll[l] = sc->cnt_d[l] = 0;
    warp_sync();
    for (int s = lane; s < 320; s += lanes)
      if (sc->lens[s]) s_add(s < 288 ? &sc->cnt_ll[sc->lens[s]] : &sc->cnt_d[sc->lens[s]], 1);
    warp_sync();
    if (code_bad(sc->cnt_ll, 1) || code_bad(sc->cnt_d, 2)) return kInvalidData;
    maxlen_ll = 0;
    for (int l = 1; l < 16; l++)
      if (sc->cnt_ll[l]) maxlen_ll = l;
    gen++;
    canon_ready = false;
    return kOk;
  }

  IS_DEV void fixed_lens() {
    for (int i = lane; i < 320; i += lanes)
      sc->lens[i] = (uint16_t)(i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5);
    warp_sync();
    take_lens();
  }

  // native parse_dynamic_tables: the code lengths into sc->lens
  IS_DEV int dynamic_header() {
    if (N - bp < 14) return kTruncated;
    const uint32_t w = peek();
    const int nlen = (int)(w & 31u) + 257;
    const int ndist = (int)((w >> 5) & 31u) + 1;
    const int ncode = (int)((w >> 10) & 15u) + 4;
    bp += 14;
    if (nlen > 286 || ndist > 30) return kInvalidData;
    if (lane == 0)
      for (int i = 0; i < 19; i++) sc->cl[i] = 0;
    for (int i = 0; i < ncode; i++) {
      if (N - bp < 3) return kTruncated;
      const uint16_t v = (uint16_t)(peek() & 7u);
      if (lane == 0) sc->cl[kClOrder[i]] = v;
      bp += 3;
    }
    warp_sync();
    if (lane == 0) canon_order(sc->cl, 19, sc->cl_cnt, sc->cl_sorted);
    warp_sync();
    if (code_bad(sc->cl_cnt, 0)) return kInvalidData;
    for (int i = lane; i < 128; i += lanes) {
      int len = 0;
      const int s = canon((uint32_t)i, 7, sc->cl_cnt, sc->cl_sorted, &len);
      sc->ct[i] = (uint32_t)s | ((uint32_t)len << 16);
    }
    warp_sync();
    const int total = nlen + ndist;
    int have = 0, prev = 0;
    while (have < total) {
      if (N - bp < 7) return kTruncated;
      const uint32_t w1 = peek();
      const uint32_t e = sc->ct[w1 & 127u];
      const int sym = (int)(e & 0xFFFFu), nb = (int)(e >> 16);
      if (sym < 16) {
        if (lane == 0) sc->lens[have < nlen ? have : 288 + have - nlen] = (uint16_t)sym;
        bp += nb;
        have++;
        prev = sym;
        continue;
      }
      const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (N - bp < nb + ebits) return kTruncated;
      bp += nb;
      if (sym == 16 && have == 0) return kInvalidData;
      const int r = (int)low_bits(w1 >> nb, ebits) + (sym == 18 ? 11 : 3);
      bp += ebits;
      const int v = sym == 16 ? prev : 0;
      if (have + r > total) return kInvalidData;
      for (int j = lane; j < r; j += lanes) {
        const int i = have + j;
        sc->lens[i < nlen ? i : 288 + i - nlen] = (uint16_t)v;
      }
      have += r;
      prev = v;
    }
    warp_sync();
    for (int i = lane; i < 320; i += lanes)
      if ((i >= nlen && i < 288) || i >= 288 + ndist) sc->lens[i] = 0;
    warp_sync();
    if (sc->lens[256] == 0) return kInvalidData;
    return take_lens();
  }

  // native's stored block after its 3 header bits: A_COPY where the
  // block copies the span, else kOk once copied here, or an error
  IS_DEV int stored_block() {
    bp = (bp + 7) & ~7LL;
    if (N - bp < 32) return kTruncated;
    const uint32_t v = peek();
    const int ln = (int)(v & 0xFFFFu), nln = (int)(v >> 16);
    bp += 32;
    if ((ln ^ nln) != 0xFFFF) return kInvalidData;
    if ((long long)n + ln > cap) return kCap;
    if (N - bp < 8LL * ln) return kTruncated;
    if (par && ln >= kBlockCopy) {
      pending = ln;
      return A_COPY;
    }
    const long long off = bp >> 3;
    for (int j = lane; j < ln; j += lanes) {
      const long long q = off + j;
      cells[n + j] = (uint16_t)((word(q >> 2) >> ((q & 3) << 3)) & 0xFFu);
    }
    warp_sync();
    n += ln;
    bp += 8LL * ln;
    return kOk;
  }

  // one symbol of a coded body: 0, 1 at its EOB, or an error
  IS_DEV int token() {
    if (!canon_ready) {
      if (lane == 0) {
        canon_order(sc->lens, 288, sc->cnt_ll, sc->sorted);
        canon_order(sc->lens + 288, 32, sc->cnt_d, sc->sorted + 288);
      }
      warp_sync();
      canon_ready = true;
    }
    if (N - bp == 0) return kTruncated;
    const uint32_t w = peek();
    int len = 0;
    const int sym = canon(w, 15, sc->cnt_ll, sc->sorted, &len);
    // a slot no code reaches (an incomplete code has one code) carries
    // native's root: that code's length
    const int nb = sym >= 0 ? len : maxlen_ll;
    if (N - bp < nb) return kTruncated;
    if (sym >= 0 && sym < 256) {
      if (n >= cap) return kCap;
      if (lane == 0) cells[n] = (uint16_t)sym;
      n++;
      bp += nb;
      return 0;
    }
    if (sym == 256) {
      bp += nb;
      return 1;
    }
    if (sym < 0 || sym >= 286) return kInvalidData;
    const int lext = kLenExtra[sym - 257];
    if (N - bp < nb + lext) return kTruncated;
    const int length = kLenBase[sym - 257] + (int)low_bits(w >> nb, lext);
    bp += nb + lext;
    const uint32_t w2 = peek();
    int dl = 0;
    const int dsym = canon(w2, 15, sc->cnt_d, sc->sorted + 288, &dl);
    if (dsym < 0 || dsym >= 30) return kInvalidData;
    const int dext = kDistExtra[dsym];
    if (N - bp < dl + dext) return kTruncated;
    const int dist = kDistBase[dsym] + (int)low_bits(w2 >> dl, dext);
    bp += dl + dext;
    if ((long long)dist > (long long)n + hist) return kInvalidData;
    if ((long long)n + length > cap) return kCap;
    if (dist > n && dist - n > need) need = dist - n;
    // a cell whose source lies before the row is its marker
    if (lane == 0)
      for (int k = 0; k < length; k++) {
        const int src = n + k - dist;
        cells[n + k] = src < 0 ? (uint16_t)(255 - src) : cells[src];
      }
    warp_sync();
    n += length;
    return 0;
  }

  // one block header at bp: A_STOP where the row ends, A_COPY where the
  // block copies a stored span, kNext where the head goes on (a coded
  // body, or the next header after a stored block copied here)
  IS_DEV int header_step() {
    if (!first && bp >= stop) {
      finish(kOk);
      return A_STOP;
    }
    first = false;
    if (nrec < rec_cap) {
      if (lane == 0) {
        rec[2 * nrec] = bp;
        rec[2 * nrec + 1] = n;
      }
      nrec++;
    } else {
      ovf = 1;
    }
    if (N - bp < 3) {
      finish(kTruncated);
      return A_STOP;
    }
    const uint32_t w = peek();
    const int typ = (int)((w >> 1) & 3u);
    final_ = (w & 1u) != 0;
    bp += 3;
    no_par = false;
    int r = kOk;
    if (typ == 0) {
      r = stored_block();
      if (r == A_COPY) return A_COPY;
      if (r == kOk) return end_block() ? A_STOP : kNext;
    } else if (typ == 3) {
      r = kInvalidData;
    } else {
      if (typ == 1)
        fixed_lens();
      else
        r = dynamic_header();
      phase = P_BODY;
    }
    if (r != kOk) {
      finish(r);
      return A_STOP;
    }
    return kNext;
  }

  // native spec_decode from where the head stands: A_STOP at the row's
  // end, A_BODY or A_COPY where the block takes over
  IS_DEV int resume() {
    if (pending >= 0) {  // a stored span the block copied
      n += (int)pending;
      bp += 8 * pending;
      pending = -1;
      if (end_block()) return A_STOP;
    }
    for (;;) {
      if (phase == P_DONE) return A_STOP;
      if (phase == P_HEAD) {
        const int a = header_step();
        if (a != kNext) return a;
        continue;
      }
      if (par && !no_par && N - bp > kMargin + kMinBody) return A_BODY;
      int r;
      do {
        r = token();
      } while (r == 0);
      if (r < 0) {
        finish(r);
        return A_STOP;
      }
      if (end_block()) return A_STOP;
    }
  }

  IS_DEV void store(long long* so) const {
    if (lane) return;
    so[0] = n;
    so[1] = why == kOk ? bp : -1;
    so[2] = fin;
    so[3] = why;
    so[4] = need;
    so[5] = nrec;
    so[6] = ovf;
    so[7] = start;
  }
};

// one row k of meta, the whole block: the head hands bodies and stored
// spans to the block until the row ends
IS_DEV void run_row(const uint32_t* words, int W, long long N, const long long* meta, int k,
                    uint16_t* cells_all, long long* recs_all, long long* st, int32_t* ptrs,
                    long long* stats, int L, int T, Body* b, HeadScratch* sc, int tid, int nthr) {
  const bool head = tid < 32;
  const long long* m = meta + (size_t)k * kMeta;
  uint16_t* cells = cells_all + m[4];
  SpecHead h;
  if (head) h.load(words, W, N, m, cells_all, recs_all, sc, tid, nthr < 32 ? nthr : 32, true);
  if (tid == 0) {
    b->gen = 0;
    b->lut_gen = -1;
  }
  block_sync();
  for (;;) {
    if (head) {
      const long long t0 = stats && tid == 0 ? now_ns() : 0;
      const int a = h.resume();
      if (tid == 0) {
        b->action = a;
        b->bp = h.bp;
        b->op = h.n;
        b->nbits = N;
        b->base = 0;
        b->cap = h.cap;
        b->reach = h.hist;
        b->mode = M_CODED;
        b->last = h.final_;
        b->no_par = 0;
        b->gen = h.gen;
        b->copy_src = h.bp >> 3;
        b->copy_dst = h.n;
        b->copy_len = h.pending;
        if (stats) {
          stats[S_NS_HEAD] += now_ns() - t0;
          if (a == A_COPY) stats[S_COPIES]++;
        }
      }
    }
    block_sync();
    const int a = b->action;
    if (a == A_STOP) break;
    if (a == A_COPY) {
      for (long long j = tid; j < b->copy_len; j += nthr) {
        const long long q = b->copy_src + j;
        cells[b->copy_dst + j] =
            (uint16_t)((word_at(words, W - 1, q >> 2) >> ((q & 3) << 3)) & 0xFFu);
      }
    }
    if (a == A_BODY) body(b, &h, words, W, sc->lens, cells, ptrs, stats, L, T, tid, nthr);
    block_sync();
    if (head && a == A_BODY) {
      h.bp = b->bp;
      h.n = (int)b->op;
      h.no_par = b->no_par != 0;
      if (b->need_max > h.need) h.need = b->need_max;
      if (b->mode != M_CODED) h.end_block();
    }
  }
  if (head) h.store(st + (size_t)k * kStatus);
}

#ifdef __CUDACC__
// a block of kThreads a row, as many blocks as are resident: each takes
// the next row of `order` (the longest first) from the counter `next`
__global__ void __launch_bounds__(kThreads)
spec_sync(const uint32_t* __restrict__ words, int W, long long N,
          const long long* __restrict__ meta, int segs, const int* __restrict__ order, int* next,
          uint16_t* cells, long long* __restrict__ recs, long long* __restrict__ st, int32_t* ptrs,
          long long* stats) {
  __shared__ HeadScratch sc;
  extern __shared__ __align__(16) unsigned char body_smem[];
  Body* b = (Body*)body_smem;
  int32_t* my_ptrs = ptrs + (size_t)blockIdx.x * kPtrCap;
  long long* my_stats = stats ? stats + (size_t)blockIdx.x * kStats : nullptr;
  for (;;) {
    if (threadIdx.x == 0) b->row = atomicAdd(next, 1);
    __syncthreads();
    const int r = b->row;
    __syncthreads();
    if (r >= segs) break;
    run_row(words, W, N, meta, order[r], cells, recs, st, my_ptrs, my_stats, 0, kThreads, b, &sc,
            threadIdx.x, kThreads);
  }
}

// SP1's pre-filter: a block a tile
__global__ void __launch_bounds__(kTileWords)
find_tiles(const uint32_t* __restrict__ w, int top, long long N, const long long* __restrict__ ops,
           int T, uint16_t* __restrict__ surv, int room, int* __restrict__ counts) {
  __shared__ uint32_t stage[kTileWords + 4];
  __shared__ int wsum[32];
  find_tile(w, top, N, ops, T, blockIdx.x, surv, room, counts, stage, wsum, threadIdx.x,
            kTileWords);
}

// SP1's check: a block a segment
__global__ void __launch_bounds__(kGroup)
find_first(const uint32_t* __restrict__ w, int top, long long N, const long long* __restrict__ ops,
           int T, const uint16_t* __restrict__ surv, int room, const int* __restrict__ counts,
           long long* __restrict__ res, long long* stats) {
  __shared__ CheckScratch sc;
  check_segment(w, top, N, ops, T, blockIdx.x, surv, room, counts, res, stats, &sc, threadIdx.x,
                kGroup);
}

// seg_ofs in the block's shared memory where it fits (E <= kSegStage)
__device__ const long long* stage_offsets(const long long* seg_ofs, int E, long long* smem) {
  if (E > kSegStage) return seg_ofs;
  for (int i = threadIdx.x; i < E; i += blockDim.x) smem[i] = seg_ofs[i];
  __syncthreads();
  return smem;
}

// SP3's first launch: a warp 32 consecutive cells at a time, grid-strided,
// each chain for `budget` hops; the cells left pending counted in ctl[1]
__global__ void __launch_bounds__(kResolveThreads)
resolve_chase(uint16_t* work, int n, const long long* __restrict__ seg_ofs, int E,
              long long limit, int budget, uint8_t* __restrict__ out, int* ctl, long long* stats) {
  extern __shared__ long long so_stage[];
  const long long* so = stage_offsets(seg_ofs, E, so_stage);
  const bool memo = so[0] <= 0;
  HopStats hs = {};
  const long long stride = (long long)gridDim.x * kResolveThreads;
  for (long long base = (long long)blockIdx.x * kResolveThreads + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long i = base + (threadIdx.x & 31);
    const bool pend =
        i < n && !resolve_one(work, n, so, E, limit, memo ? budget : INT_MAX, memo, out, ctl,
                              (int)i, hs);
    const unsigned m = __ballot_sync(kFull, pend);
    if ((threadIdx.x & 31) == 0 && m) atomicAdd(ctl + 1, __popc(m));
  }
  flush_stats(stats, hs);
}

// SP3's second launch, where the first left cells pending (still markers
// in work): each one's chain to its end
__global__ void __launch_bounds__(kResolveThreads)
resolve_tail(uint16_t* work, int n, const long long* __restrict__ seg_ofs, int E,
             long long limit, uint8_t* __restrict__ out, int* ctl, long long* stats) {
  if (*(volatile int*)(ctl + 1) == 0) return;
  extern __shared__ long long so_stage[];
  const long long* so = stage_offsets(seg_ofs, E, so_stage);
  HopStats hs = {};
  const long long stride = (long long)gridDim.x * kResolveThreads;
  for (long long i = (long long)blockIdx.x * kResolveThreads + threadIdx.x; i < n; i += stride)
    if (work[i] >= 256) resolve_one(work, n, so, E, limit, INT_MAX, true, out, ctl, (int)i, hs);
  flush_stats(stats, hs);
}
#endif

}  // namespace

// int32 a block's pointer scratch; int64 a block's stats
extern "C" long long zrs_spec_scratch_words() { return kPtrCap; }
extern "C" long long zrs_spec_stats_len() { return kStats; }

#ifdef __CUDACC__
namespace {
constexpr int kMaxDevices = 64;
int g_sync_blocks[kMaxDevices];  // a device's resident spec_sync blocks, once its attribute is set
int g_sms[kMaxDevices];          // a device's SMs, once read

int sm_count(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_sms[dev]) {
    e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *out = g_sms[dev];
  return 0;
}
}  // namespace

// SP1: per segment k of ops (int64 [3T + 1]: lo [T], hi [T], the first
// of its pre-filter tiles [T + 1], `tiles` in all), the first offset in
// [lo[k], hi[k]) whose chain passes, or -1, into res[k], and into res[T + k]
// 1 where a tile of the segment counted more survivors than its room (u16
// surv [tiles, room], int32 counts [tiles]; the host reruns with room
// 32 * kTileWords); stats int64 [2] (zeroed: the survivors counted and
// checked) or null
extern "C" int zrs_block_find(const void* words, int w, long long nbits, const void* ops, int segs,
                              int tiles, void* surv, int room, void* counts, void* res,
                              void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (segs <= 0) return (int)cudaGetLastError();
  if (tiles > 0)
    find_tiles<<<tiles, kTileWords, 0, s>>>((const uint32_t*)words, w - 1, nbits,
                                            (const long long*)ops, segs, (uint16_t*)surv, room,
                                            (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  find_first<<<segs, kGroup, 0, s>>>((const uint32_t*)words, w - 1, nbits, (const long long*)ops,
                                     segs, (const uint16_t*)surv, room, (const int*)counts,
                                     (long long*)res, (long long*)stats);
  return (int)cudaGetLastError();
}

// SP1's first design (find_prefilter, find_check), kept to be timed against
// zrs_block_find and called by no route: per segment k the first offset in
// [lo[k], hi[k]) whose chain passes, written into best[k] (which the wrapper
// fills with INT_MAX); the survivors of the pre-filter go to surv (cap
// pairs), their number to *count, which the wrapper zeroes and reads back
extern "C" int zrs_block_find_thread(const void* words, int w, long long nbits, const void* lo,
                              const void* hi, int segs, int span, void* surv, int cap,
                              void* count, void* best, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (span + kFindThreads - 1) / kFindThreads;
  const long long blocks = (long long)segs * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    find_prefilter<<<(unsigned)blocks, kFindThreads, 0, s>>>(
        (const uint32_t*)words, w - 1, nbits, (const long long*)lo, (const long long*)hi, tiles,
        (longlong2*)surv, cap, (int*)count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (cap > 0)
    find_check<<<(cap + kCheckThreads - 1) / kCheckThreads, kCheckThreads, 0, s>>>(
        (const uint32_t*)words, w - 1, nbits, (const longlong2*)surv, cap, (const int*)count,
        (unsigned long long*)best);
  return (int)cudaGetLastError();
}

// SP2 over rows of meta (int64 [segs, 8]: start_bit, stop_bit, cap, hist,
// cell_off, rec_off, rec_cap, 0): cells u16, records int64 pairs, status
// int64 [segs, 8]. A block of kThreads a row, as many blocks as the
// device holds resident and ptr_blocks scratches of kPtrCap int32 allow
// (at most segs); the blocks take the rows of `order` (int32 [segs]) from
// the zeroed counter `next`; stats int64 [blocks, kStats] or null. The
// words must be 16-byte aligned (the body stages them with cp.async).
extern "C" int zrs_spec_decode(const void* words, int w, long long nbits, const void* meta, int segs,
                               void* cells, void* recs, void* st, const void* order, void* next,
                               void* ptrs, int ptr_blocks, void* stats, void* stream) {
  if (segs <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)words & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_sync_blocks[dev]) {  // the attribute is the device's, not the process's
    e = cudaFuncSetAttribute(spec_sync, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Body));
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spec_sync, kThreads, sizeof(Body));
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    g_sync_blocks[dev] = per_sm * sms;
  }
  int blocks = g_sync_blocks[dev] < ptr_blocks ? g_sync_blocks[dev] : ptr_blocks;
  blocks = blocks < segs ? blocks : segs;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  spec_sync<<<blocks, kThreads, sizeof(Body), (cudaStream_t)stream>>>(
      (const uint32_t*)words, w, nbits, (const long long*)meta, segs, (const int*)order,
      (int*)next, (uint16_t*)cells, (long long*)recs, (long long*)st, (int32_t*)ptrs,
      (long long*)stats);
  return (int)cudaGetLastError();
}

// the same rows through the one-warp launch (spec_decode, a warp a row):
// kept to be timed against zrs_spec_decode, and called by no route
extern "C" int zrs_spec_decode_warp(const void* words, int w, long long nbits, const void* meta,
                                    int segs, void* cells, void* recs, void* st, void* stream) {
  if (segs > 0)
    spec_decode<<<segs, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, w, nbits, (const long long*)meta, (uint16_t*)cells,
        (long long*)recs, (long long*)st);
  return (int)cudaGetLastError();
}

// SP3 over work (u16 [n], a copy of the cells, which it rewrites) and
// seg_ofs (int64 [segs + 1]): the bytes into out, each cell's chain
// followed for `budget` hops in a first launch, the chains still pending
// to their ends in a second; ctl int32 [2], zeroed: set where a chain
// ended on a marker after `limit` hops (the plain version's 2^rounds),
// then the cells the first launch left pending; stats int64
// [kResolveStats] (zeroed) or null
extern "C" int zrs_spec_resolve(void* work, int n, const void* seg_ofs, int segs, long long limit,
                                int budget, void* out, void* ctl, void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || segs <= 0) return (int)cudaGetLastError();
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const long long need = ((long long)n + kResolveThreads - 1) / kResolveThreads;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  const size_t smem = segs <= kSegStage ? sizeof(long long) * segs : 0;
  resolve_chase<<<blocks, kResolveThreads, smem, s>>>((uint16_t*)work, n,
                                                      (const long long*)seg_ofs, segs, limit,
                                                      budget, (uint8_t*)out, (int*)ctl,
                                                      (long long*)stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resolve_tail<<<blocks, kResolveThreads, smem, s>>>((uint16_t*)work, n,
                                                     (const long long*)seg_ofs, segs, limit,
                                                     (uint8_t*)out, (int*)ctl, (long long*)stats);
  return (int)cudaGetLastError();
}

// SP3's first design (resolve_init, resolve_jump, resolve_narrow), kept to
// be timed against zrs_spec_resolve and called by no route: pointers into
// ptr_a, `rounds` rounds of jumping between ptr_a and ptr_b, then the
// bytes; *flag is set where a marker outlived the rounds
extern "C" int zrs_spec_resolve_jump(const void* cells, int n, const void* seg_ofs, int segs,
                                void* ptr_a, void* ptr_b, int rounds, void* out, void* flag,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kResolveThreads - 1) / kResolveThreads);
  int* a = (int*)ptr_a;
  int* b = (int*)ptr_b;
  resolve_init<<<blocks, kResolveThreads, 0, s>>>((const uint16_t*)cells, n,
                                                  (const long long*)seg_ofs, segs, a);
  for (int r = 0; r < rounds; r++) {
    resolve_jump<<<blocks, kResolveThreads, 0, s>>>(a, b, n);
    int* tmp = a;
    a = b;
    b = tmp;
  }
  resolve_narrow<<<blocks, kResolveThreads, 0, s>>>((const uint16_t*)cells, a, n,
                                                    (uint8_t*)out, (int*)flag);
  return (int)cudaGetLastError();
}
#else
// zrs_spec_decode on the host: the rows in turn, each by one block whose
// T threads run in turn, sub-ranges of L bits (0: the card's adaptive L);
// ptrs int32 [kPtrCap], stats int64 [kStats] or null. The CPU tests' way
// into this file's SP2.
extern "C" int zrs_spec_decode_host(const void* words, int w, long long nbits, const void* meta,
                                    int segs, void* cells, void* recs, void* st, void* ptrs,
                                    void* stats, int L, int T) {
  static HeadScratch sc;
  static Body b;
  if (T < 1 || T > kThreads || L < 0 || L > kStageWords * 8) return 1;
  for (int k = 0; k < segs; k++)
    run_row((const uint32_t*)words, w, nbits, (const long long*)meta, k, (uint16_t*)cells,
            (long long*)recs, (long long*)st, (int32_t*)ptrs, (long long*)stats, L, T, &b, &sc, 0,
            1);
  return 0;
}

// zrs_block_find on the host: every tile's pre-filter, then every
// segment's check, by one block whose one thread runs them in turn (the
// CPU tests' way into this file's SP1)
extern "C" int zrs_block_find_host(const void* words, int w, long long nbits, const void* ops,
                                   int segs, int tiles, void* surv, int room, void* counts,
                                   void* res, void* stats) {
  static uint32_t stage[kTileWords + 4];
  static int wsum[32];
  static CheckScratch sc;
  for (int g = 0; g < tiles; g++)
    find_tile((const uint32_t*)words, w - 1, nbits, (const long long*)ops, segs, g,
              (uint16_t*)surv, room, (int*)counts, stage, wsum, 0, 1);
  for (int k = 0; k < segs; k++)
    check_segment((const uint32_t*)words, w - 1, nbits, (const long long*)ops, segs, k,
                  (const uint16_t*)surv, room, (const int*)counts, (long long*)res,
                  (long long*)stats, &sc, 0, 1);
  return 0;
}

// zrs_spec_resolve on the host: the first launch's cells in turn
// (`descending`: from the last, so that no chain meets a resolved cell),
// then the pending cells in turn (the CPU tests' way into this file's SP3)
extern "C" int zrs_spec_resolve_host(void* work, int n, const void* seg_ofs, int segs,
                                     long long limit, int budget, void* out, void* ctl,
                                     void* stats, int descending) {
  if (n <= 0 || segs <= 0) return 0;
  uint16_t* wk = (uint16_t*)work;
  const long long* so = (const long long*)seg_ofs;
  int* ct = (int*)ctl;
  const bool memo = so[0] <= 0;
  HopStats hs = {};
  for (int k = 0; k < n; k++)
    ct[1] += !resolve_one(wk, n, so, segs, limit, memo ? budget : INT_MAX, memo, (uint8_t*)out,
                          ct, descending ? n - 1 - k : k, hs);
  for (int i = 0; i < n && ct[1]; i++)
    if (wk[i] >= 256) resolve_one(wk, n, so, segs, limit, INT_MAX, true, (uint8_t*)out, ct, i, hs);
  flush_stats((long long*)stats, hs);
  return 0;
}
#endif
