// SP1-SP3: the speculative decode of one raw-deflate stream with no index.
//
// Replaces no pallas_call site. It is the card's counterpart of the decode
// half of the reference's native engine (zlib_rs_tpu/native.py
// inflate_speculative and zran_index over native/zrs_native.cpp):
//   zrs_block_find   SP1, validate_header_at / find_candidate (depth 6)
//   zrs_spec_decode  SP2, spec_decode with inflate_raw_impl's error codes
//                    and its stop and point hooks (a thread block a row;
//                    zrs_spec_decode_warp, the one-warp launch it
//                    replaced, stays to be timed against it)
//   zrs_spec_resolve SP3, the stitch: markers resolved, cells to bytes
// ops/kernels/speculative_kernel.py holds each one's plain version, whose
// control flow these kernels follow step for step, and the wrappers.
//
// Bounds on the H100. SP1 reads the compressed stream and writes a few
// ints a segment: its byte bound is microseconds for megabytes, and its
// work is a test at every bit offset of the searched ranges, most of which
// fail within 17 bits. SP2 moves the stream in and 2 bytes a cell out; a
// row is one serial chain (a code's length decides where the next
// starts), which its design breaks inside each coded block. SP3 moves
// bytes: cells in, pointers through log2(segments) rounds, bytes out.
//
// Design.
// - Stream bit positions are 64-bit everywhere: SP1's ranges, survivors and
//   best offsets, SP2's start, stop and end bits and its block-start
//   records, int64 from the host's chain walk on (a stream of 2^28 bytes
//   or more has bit positions past int32). Cell counts stay int32, a
//   segment's room being under 2^31 cells.
// - SP1 runs two passes. The pre-filter is a thread a bit offset over every
//   searched range: the chain's first header by its type, a stored LEN and
//   NLEN, or a dynamic header's counts and a complete code-length code,
//   each field read from two 32-bit words (bits straddle words). Survivors
//   (under 1% of offsets on compressed data) are appended to a list, one
//   atomic a warp. The full check then runs a thread a survivor: the
//   native chain of up to 6 headers (stored links over their payloads,
//   static followers sanity-decoded for up to 192 symbols by arithmetic on
//   the fixed code, a dynamic link's code lengths decoded canonically and
//   both codes' Kraft sums checked, which is all that building native's
//   tables can refuse), and an atomicMin a segment keeps its first passing
//   offset. A survivor beyond its segment's best so far exits early. So a
//   warp of pass 2 is 32 survivors, not the rare survivor among 31 idle
//   lanes that a one-pass scan would make it.
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
// - SP3 runs three kernels from one entry: each cell takes a pointer (to
//   itself when known; a marker to its segment's offset minus back, the
//   segment found by binary search over the offsets), then rounds of
//   pointer jumping, p[i] = p[p[i]], in two buffers: a hop always lands in
//   an earlier segment, so log2(segments) rounds resolve every chain, even
//   one that crosses many segments under 32 KiB of output; then each cell
//   reads its target and narrows to a byte.
//
// Without __CUDACC__ the file compiles as host C++ with SP2's block launch
// alone (zrs_spec_decode_host): the rows in turn, the block's threads in
// turn, L an argument, so that the CPU tests run this file's SP2 against
// its plain version and native.

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
  int c = cells[ptr[i]];
  if (c >= 256) {
    atomicOr(flag, 1);
    c = 0;
  }
  out[i] = (uint8_t)c;
}


#endif  // __CUDACC__

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
#endif

}  // namespace

// int32 a block's pointer scratch; int64 a block's stats
extern "C" long long zrs_spec_scratch_words() { return kPtrCap; }
extern "C" long long zrs_spec_stats_len() { return kStats; }

#ifdef __CUDACC__
// SP1: per segment k the first offset in [lo[k], hi[k]) whose chain passes,
// written into best[k] (which the wrapper fills with INT_MAX); the
// survivors of the pre-filter go to surv (cap pairs), their number to
// *count, which the wrapper zeroes and reads back
extern "C" int zrs_block_find(const void* words, int w, long long nbits, const void* lo,
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

namespace {
constexpr int kMaxDevices = 64;
int g_sync_blocks[kMaxDevices];  // a device's resident spec_sync blocks, once its attribute is set
}  // namespace

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

// SP3: pointers into ptr_a, `rounds` rounds of jumping between ptr_a and
// ptr_b, then the bytes; *flag is set where a marker outlived the rounds
extern "C" int zrs_spec_resolve(const void* cells, int n, const void* seg_ofs, int segs,
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
#endif
