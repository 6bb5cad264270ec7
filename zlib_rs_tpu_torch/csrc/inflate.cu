// K6: the sequential RFC 1951 inflate, one raw-deflate stream per block of
// two warps: a decode warp and a copy warp over shared memory.
//
// Replaces zlib_rs_tpu/ops/pallas/inflate_kernel.py:decode_streams_pallas
// (body _kernel_body): stored, fixed and dynamic blocks, multi-block
// bodies, the two-level decode tables built inside the decode, a history
// window in front of the output, a start bit anywhere, and a stop mode in
// which out_len is a checkpoint target. Outputs per stream: LE32 output
// words, produced, bad, end_bit, fin_seen.
//
// Bound on the H100. The byte bound is the compressed bytes in and the
// output bytes out over 3.35 TB/s, microseconds for the 8 MiB index. It
// is not the floor: the format makes each stream one serial chain (a
// code's length decides where the next code starts), so the honest floor
// is the stream's symbols times the latency of one shared-memory table
// lookup and the shifts around it. The design keeps only that chain on
// the decoder and moves everything else off it.
//
// Design. Warp 0 decodes into a 64 KiB ring of output bytes in shared
// memory; warp 1 copies the finished bytes from the ring to the device row.
//
// - The decode warp runs the reference's control flow as it stands (the
//   block loop and its exit rules, stored/fixed/dynamic headers, the
//   literal run, the match checks), all 32 lanes in step on the same
//   values, so that a table build and a match copy can use every lane
//   with no branch between lanes. It reads the compressed words through a
//   64-bit bit reservoir in registers, refilled a word at a time from a
//   word loaded one refill ahead, so that a symbol costs one shared table
//   lookup (two with a subtable) and register shifts. The reservoir holds
//   the same bits as the reference's peek32: the stream of words in order,
//   each index clamped to [0, W - 1] (an index past W - 1 reads word W - 1,
//   one below 0 reads word 0), and a stored block or a start bit re-seeks
//   it. A literal is one shared store. A match is copied 32 bytes a step
//   by the 32 lanes: a distance of 1 is a run of one byte; with a distance
//   of 32 or more every source of a step lies before the step (a barrier
//   between steps); under 32 lane i of the step at offset k copies byte
//   (k + i) mod dist of the period before the match, its offset in the
//   period carried from step to step. A
//   stored span is copied from the compressed words in device memory, a
//   lane a byte, in pieces of 4 KiB. Every distance is at most 32,768 and
//   `dist > op` is bad before any copy, so each source lies in the ring;
//   the ring starts with the last <= 32 KiB of the window.
// - The common path of a symbol is kept short, because it is one chain of
//   dependent instructions that a single warp issues about one every six
//   cycles: a literal is written below a limit that folds max_out, the
//   next publication and the ring's free room into one compare, and the
//   rest (publishing, waiting for the copy warp, literals past max_out,
//   refills, subtable lookups) is off that path.
// - The two warps meet only every kPublish output bytes (a queue of tokens
//   between them cost more than the copying it moved off the decoder, and
//   staging the compressed words in shared memory saved little against
//   reading them a word ahead through the read-only cache, by in-kernel
//   clocks on the card): the decode warp publishes how far it has written
//   (a release store), and the copy warp publishes how far it has stored
//   to the device row. Before it writes past a ring slot the copy warp has
//   not yet stored, the decode warp publishes and waits for it, so no
//   pending byte is overwritten; the copy warp stores up to the
//   word-aligned published position, so the wait always ends.
// - The copy warp stores 32-bit words, coalesced, a lane a word. The
//   wrapper returns only bytes [wpad, wpad + max_out) of the row, so the
//   window head is not written back and nothing at or past max_out is
//   stored; the row starts zeroed and the last word is masked at the
//   stream's end, so every byte past `produced` reads 0 as it does in the
//   reference.
// - Tables are built by the whole decode warp: clear with 32 lanes, count
//   lengths by shared atomics, offsets and canonical first codes by a warp
//   scan over the 16 counts, each symbol ranked within its length by
//   __match_any_sync in symbol order (the counting sort's order), its code
//   then canonical (bit-reversed, as the reference's `huff` increment
//   makes it), and every slot filled one lane per code. The subtable
//   headers (sub_off, curr) of the codes longer than the root are computed
//   by the serial loop's rule, in sorted order, with the remaining counts
//   it would see.
//
// Why the parallel build is exact. In a table whose `bad` is false, the
// code is complete (or is the single distance code, which has no long
// codes), so every slot is written by exactly one code and codes sharing a
// root prefix are consecutive in sorted order: the order of the fill does
// not matter, and each long code finds its subtable header at its root
// slot. When `bad` is true no decode reads the table, because the code
// length loop and the coded block both test `bad` first. So `bad` and the
// root are computed exactly as the serial loop computes them: `left`,
// `maxlen == 0`, `used > cap`, every slot `>= cap` or `< 0`, the single
// distance code exception; each is an OR over the codes, whatever order
// they are checked in.
//
// Status on every lane, corrupt ones too: produced counts the literals of
// a run past max_out up to the next non-literal code (they are not
// written), end_bit is the bit position wherever the decode stopped, and a
// stored block is checked against comp_bits + 32 and max_out before any
// copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLit = 0, kMatch = 1, kEob = 2, kSub = 3, kInvalid = 7;
constexpr int kLlRoot = 9, kDRoot = 6, kClRoot = 7;
constexpr int kLlCap = 852, kDCap = 592, kClCap = 128;
constexpr int kMeta = 8;
constexpr int kThreads = 64;             // the decode warp and the copy warp
constexpr int kRing = 1 << 16;           // output ring, bytes
constexpr int kRingMask = kRing - 1;
constexpr int kSmemBytes = kRing;
constexpr int kPublish = 4096;           // output bytes between publications
constexpr int kPiece = 4096;             // a stored span's copy step
constexpr int kMaxMatch = 258;
constexpr unsigned kFull = 0xFFFFFFFFu;

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                 11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ uint32_t entry(uint32_t kind, uint32_t extra,
                                          uint32_t nbits, uint32_t val) {
  return (kind << 28) | (extra << 22) | (nbits << 16) | val;
}
__device__ __forceinline__ uint32_t e_kind(uint32_t e) { return e >> 28; }
__device__ __forceinline__ int e_extra(uint32_t e) { return (e >> 22) & 0x3F; }
__device__ __forceinline__ int e_nbits(uint32_t e) { return (e >> 16) & 0x3F; }
__device__ __forceinline__ int e_val(uint32_t e) { return e & 0xFFFF; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// lane 0 reads, every lane gets the value
__device__ __forceinline__ int bcast_acquire(const int* p, int lane) {
  int v = 0;
  if (lane == 0) v = ld_acquire(p);
  return __shfl_sync(kFull, v, 0);
}

// (kind, extra, val) of symbol `sym`: kind_of 0 = code lengths,
// 1 = litlen, 2 = distance
__device__ uint32_t sym_entry(int kind_of, int sym, int nbits) {
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

// the decode warp's shared state
struct Tables {
  uint32_t ll[kLlCap];
  uint32_t d[kDCap];
  uint32_t cl[kClCap];
  int lens[320];
  uint16_t work[320];  // symbols in sorted order
  int cnt[16], offs[16], run[16], next[16], rem[16];
};

// The block's shared memory lives at namespace scope, so that every access
// compiles to a shared-memory instruction and not a generic one: the
// decode warp's tables, the positions the two warps publish (the decode
// warp's written end, its end flag, the copy warp's stored end) and the
// dynamic part, the output ring.
__shared__ Tables t;
__shared__ int s_wop, s_done, s_fpos;
extern __shared__ __align__(16) uint8_t smem[];

// The ring is addressed by its 32-bit offset in the shared window, held in
// a register (the asm keeps the compiler from rebuilding it, with a slow
// special-register read, before every store), so that a byte access is
// one ld/st.shared. The accesses are volatile asm, so they keep their
// order among themselves and against the barriers and the release and
// acquire operations, but carry no memory clobber: the decoder's table
// loads may move past them.
__device__ __forceinline__ uint32_t ring_base() {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"((uint32_t)__cvta_generic_to_shared(smem)));
  return r;
}
__device__ __forceinline__ void ring_st(uint32_t base, int pos, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(base + (uint32_t)(pos & kRingMask)), "r"(v));
}
__device__ __forceinline__ uint32_t ring_ld(uint32_t base, int pos) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(base + (uint32_t)(pos & kRingMask)));
  return v;
}
__device__ __forceinline__ uint32_t ring_ld32(uint32_t base, int pos) {  // pos % 4 == 0
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(base + (uint32_t)(pos & kRingMask)));
  return v;
}

// canonical code of sorted index k of length l, bit-reversed to l bits
__device__ __forceinline__ uint32_t huff_of(int k, int l) {
  return __brev((uint32_t)(t.next[l] + k - t.offs[l])) >> (32 - l);
}

// the two-level canonical table of lens[0 : nsyms), built by the whole
// warp; returns the root bits, sets *bad_out (the same on every lane)
__device__ int build_table(uint32_t* tab, int cap, int nsyms, const int* lens,
                           int root_in, int kind_of, bool* bad_out, int lane) {
  if (lane < 16) t.cnt[lane] = 0;
  __syncwarp();
  for (int i = lane; i < nsyms; i += 32) {
    const int l = lens[i];
    if (l > 0) atomicAdd(&t.cnt[l], 1);
  }
  __syncwarp();
  const int c = lane < 16 ? t.cnt[lane] : 0;  // lane l holds the count of length l
  const unsigned nz = __ballot_sync(kFull, lane >= 1 && c > 0);
  const int maxlen = nz ? 31 - __clz(nz) : 0;
  const int minlen = nz ? __ffs(nz) - 1 : 15;
  const int root = min(max(root_in, minlen), max(maxlen, 1));
  int incl = c;  // codes of length <= lane
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
  bool bad = left < 0 || (left > 0 && !(kind_of == 2 && ncodes <= 1)) || maxlen == 0;
  if (lane < 16) {
    t.offs[lane] = incl - c;
    t.run[lane] = incl - c;
    t.next[lane] = next_l;
    t.rem[lane] = c;
  }
  const uint32_t inv = entry(kInvalid, 0, root, 0);
  for (int i = lane; i < cap; i += 32) tab[i] = inv;
  __syncwarp();

  // rank each symbol within its length, in symbol order; fill the codes
  // no longer than the root, one lane a code
  const unsigned lt = (1u << lane) - 1u;
  bool sbad = false;
  for (int base = 0; base < nsyms; base += 32) {
    const int i = base + lane;
    const int l = i < nsyms ? lens[i] : 0;
    const unsigned grp = __match_any_sync(kFull, l);
    if (l > 0) {
      const int k = t.run[l] + __popc(grp & lt);
      t.work[k] = (uint16_t)i;
      if (l <= root) {
        const int huff = (int)huff_of(k, l);
        const uint32_t ent = sym_entry(kind_of, i, l);
        for (int f = (1 << root) - (1 << l); f >= 0; f -= 1 << l) {
          if (huff + f >= cap) {  // the highest slot first
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

  // the subtable headers, by the serial loop's rule, in sorted order
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
  // the codes longer than the root, one lane a code, into their subtables
  if (!bad) {
    bool lbad = false;
    for (int k = nshort + lane; k < ncodes; k += 32) {
      const int sym = t.work[k];
      const int l = lens[sym];
      const uint32_t huff = huff_of(k, l);
      const uint32_t hdr = tab[huff & rmask];
      const int at = e_val(hdr) + (int)(huff >> root);
      const int step = 1 << (l - root);
      const uint32_t ent = sym_entry(kind_of, sym, l);
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

// root <= 15 and a subtable's bits <= 15, so the shifts need no guard
__device__ __forceinline__ uint32_t lookup(const uint32_t* tab, uint32_t w, uint32_t mask,
                                           int root) {
  const uint32_t e0 = tab[w & mask];
  if (__builtin_expect(e_kind(e0) == kSub, 0))
    return tab[e_val(e0) + (int)((w >> root) & ~(0xFFFFFFFFu << e_extra(e0)))];
  return e0;
}

// the compressed stream as a bit reservoir over clamped word reads
struct Bits {
  const uint32_t* words;
  int top;  // W - 1
  uint64_t res;
  int nbits, nxt_i;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t word(int i) const {
    i = i < 0 ? 0 : (i > top ? top : i);
    return __ldg(words + i);
  }
  __device__ void seek(int bp) {
    const int wi = bp >> 5;
    const int sh = bp & 31;
    res = ((uint64_t)word(wi) | ((uint64_t)word(wi + 1) << 32)) >> sh;
    nbits = 64 - sh;
    nxt_i = wi + 2;
    nxt = word(nxt_i);
  }
  // at least 33 valid bits afterwards
  __device__ __forceinline__ void refill() {
    if (__builtin_expect(nbits <= 32, 0)) {
      res |= (uint64_t)nxt << nbits;
      nbits += 32;
      nxt = __ldg(words + min(max(++nxt_i, 0), top));
    }
  }
  __device__ __forceinline__ uint32_t peek() const { return (uint32_t)res; }
  __device__ __forceinline__ void skip(int n) {
    res >>= n;
    nbits -= n;
  }
};

struct Decoder {
  Bits rd;
  uint32_t ring;  // the ring's shared-window offset
  int lane;
  int comp_bits, max_out;
  int bp, op;
  int pub, fcache;  // the last published end; the copy warp's end as last read
  // below rl a match may be written with no publication and no wait; below
  // lit_lim (also below max_out) a literal
  int rl, lit_lim;

  __device__ void publish(int p) {
    pub = p;
    if (lane == 0) st_release(&s_wop, p);
  }
  __device__ void limits() {
    rl = min(pub + kPublish, fcache + kRing - kMaxMatch + 1);
    lit_lim = min(max_out, rl);
  }
  // before writing [op, op + n): publish if due, and wait until the copy
  // warp has stored every ring slot the write reuses
  __device__ void room(int n) {
    if (op - pub >= kPublish || op + n - fcache > kRing) publish(op);
    while (op + n - fcache > kRing) fcache = bcast_acquire(&s_fpos, lane);
    limits();
  }

  __device__ void adv(int n) {
    rd.skip(n);
    bp += n;
  }
  __device__ uint32_t peek() {
    rd.refill();
    return rd.peek();
  }

  __device__ void stored_block(bool* bad_io) {
    adv(((bp + 7) & ~7) - bp);
    const uint32_t w = peek();
    const int ln = (int)(w & 0xFFFFu);
    const int nln = (int)(w >> 16);
    adv(32);
    bool bad = *bad_io;
    bad = bad || (ln ^ 0xFFFF) != nln;
    bad = bad || bp + ln * 8 > comp_bits + 32;
    bad = bad || op + ln > max_out;
    *bad_io = bad;
    if (bad) return;
    const uint32_t* words = rd.words;
    const int off = bp >> 3;
    for (int k0 = 0; k0 < ln; k0 += kPiece) {  // a lane a byte, in pieces
      const int n = min(kPiece, ln - k0);
      room(max(n, kMaxMatch));
      for (int j = lane; j < n; j += 32) {
        const int q = off + k0 + j;
        int wi = q >> 2;
        wi = wi < 0 ? 0 : (wi > rd.top ? rd.top : wi);
        ring_st(ring, op + j, (__ldg(words + wi) >> ((q & 3) << 3)) & 0xFFu);
      }
      __syncwarp();
      op += n;
    }
    bp += ln << 3;
    rd.seek(bp);
  }

  __device__ void fixed_lens() {
    for (int i = lane; i < 320; i += 32)
      t.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
    __syncwarp();
  }

  __device__ void dynamic_header(int* nlen_out, int* ndist_out, bool* bad_io) {
    bool bad = *bad_io;
    const uint32_t w = peek();
    const int nlen = (int)(w & 31u) + 257;
    const int ndist = (int)((w >> 5) & 31u) + 1;
    const int hclen = (int)((w >> 10) & 15u) + 4;
    adv(14);
    bad = bad || nlen > 286 || ndist > 30;
    if (lane < 19) t.lens[lane] = 0;
    __syncwarp();
    for (int i = 0; i < hclen; i++) {
      const int v = (int)(peek() & 7u);
      if (lane == 0) t.lens[kClOrder[i]] = v;
      adv(3);
    }
    __syncwarp();
    bool clbad;
    const int clroot = build_table(t.cl, kClCap, 19, t.lens, kClRoot, 0, &clbad, lane);
    bad = bad || clbad;
    const uint32_t cl_mask = (1u << clroot) - 1u;
    const int total = nlen + ndist;
    int i = 0, prev = -1;
    while (i < total && !bad) {
      const uint32_t e = t.cl[peek() & cl_mask];
      const int sym = e_val(e);
      bad = bad || e_kind(e) == kInvalid;
      adv(e_nbits(e));
      const uint32_t w2 = peek();
      if (sym < 16) {
        if (lane == 0) t.lens[i] = sym;
        i++;
        prev = sym;
        continue;
      }
      const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      const int r = (int)(w2 & ((1u << ebits) - 1u)) + (sym == 18 ? 11 : 3);
      const int v = sym == 16 ? prev : 0;
      bad = bad || (sym == 16 && i == 0) || i + r > total;
      if (!bad)
        for (int j = lane; j < r; j += 32)
          if (i + j < total) t.lens[i + j] = v;
      i += r;
      adv(ebits);
      prev = v;
    }
    bad = bad || bp > comp_bits + 32;
    __syncwarp();
    // distance lengths move to lens[288:]; the ranges may overlap, so the
    // copy runs from the top down
    if (lane == 0)
      for (int j = 31; j >= 0; j--)
        if (j < ndist) t.lens[288 + j] = t.lens[nlen + j];
    __syncwarp();
    bad = bad || t.lens[256] == 0;
    *nlen_out = nlen;
    *ndist_out = ndist;
    *bad_io = bad;
  }

  // a match at `at`, 32 bytes a step: byte j of the match is byte j mod
  // dist of the dist bytes before it
  __device__ __forceinline__ void copy_match(int at, int length, int dist) {
    if (dist == 1) {  // a run of one byte
      const uint32_t v = ring_ld(ring, at - 1);
#pragma unroll 1
      for (int k = lane; k < length; k += 32) ring_st(ring, at + k, v);
    } else if (dist >= 32 || dist >= length) {  // every source lies before its step
#pragma unroll 1
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) ring_st(ring, at + k + lane, ring_ld(ring, at - dist + k + lane));
        __syncwarp();
      }
    } else {  // a period under 32: the lane's offset in it, advanced 32 a step
      int r = lane;
      while (r >= dist) r -= dist;
      int step = 32;
      while (step >= dist) step -= dist;
#pragma unroll 1
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) ring_st(ring, at + k + lane, ring_ld(ring, at - dist + r));
        r += step;
        if (r >= dist) r -= dist;
      }
    }
    __syncwarp();
  }

  __device__ void coded_block(bool* bad_io, int nlen, int ndist) {
    bool b1, b2;
    const int ll_root = build_table(t.ll, kLlCap, nlen, t.lens, kLlRoot, 1, &b1, lane);
    const int d_root = build_table(t.d, kDCap, ndist, t.lens + 288, kDRoot, 2, &b2, lane);
    bool bad = *bad_io || b1 || b2;
    const uint32_t ll_mask = (1u << ll_root) - 1u;
    const uint32_t d_mask = (1u << d_root) - 1u;
    bool eob = false;
    while (!(bad || eob) && bp <= comp_bits) {
      uint32_t w = peek();
      uint32_t e = lookup(t.ll, w, ll_mask, ll_root);
      // the literal run: the reference's sprint, one literal a step;
      // literals at or past max_out are counted and not written
      while (e < (1u << 28) && bp <= comp_bits) {  // kind kLit
        // every lane stores the same byte; at lit_lim, the rare cases
        if (op >= lit_lim && op < max_out) room(kMaxMatch);
        if (op < lit_lim) ring_st(ring, op, e & 0xFFu);
        adv(e_nbits(e));
        op++;
        w = peek();
        e = lookup(t.ll, w, ll_mask, ll_root);
      }
      bad = bad || op > max_out;
      const bool exhausted = bp > comp_bits;
      const uint32_t kind = e_kind(e);
      const int nb = e_nbits(e);
      const bool is_eob = kind == kEob && !exhausted;
      const bool is_match = kind == kMatch && !exhausted;
      bad = bad || (!exhausted && !(is_eob || is_match));
      if (is_eob) {
        adv(nb);
        eob = true;
      }
      if (is_match) {
        const int lext = e_extra(e);
        const int length = e_val(e) + (int)((w >> nb) & ~(0xFFFFFFFFu << lext));
        adv(nb + lext);
        const uint32_t w2 = peek();
        const uint32_t de = lookup(t.d, w2, d_mask, d_root);
        bad = bad || e_kind(de) != kMatch;
        const int dnb = e_nbits(de);
        const int dext = e_extra(de);
        // an entry other than a match sets bad; its nbits and extra are
        // still below 32, as every entry's is
        const int dist = e_val(de) + (int)((w2 >> dnb) & ~(0xFFFFFFFFu << dext));
        adv(dnb + dext);
        bad = bad || dist > op || op + length > max_out || dist < 1;
        if (!bad) {
          if (op >= rl) room(kMaxMatch);
          copy_match(op, length, dist);
          op += length;
        }
      }
    }
    *bad_io = bad;
  }
};

// the copy warp: stores the ring's finished bytes to the device row
struct Copier {
  uint32_t* out;  // the stream's row
  int lim;        // max_out + wpad: no byte at or past it is stored
  int lane, fpos;

  // store [fpos, end) a word a lane; a last partial word is masked
  __device__ void store(int end) {
    const uint32_t ring = ring_base();
    for (int p = fpos + 4 * lane; p < end; p += 128) {
      uint32_t v = ring_ld32(ring, p);
      if (end - p < 4) v &= (1u << ((end - p) << 3)) - 1u;
      out[p >> 2] = v;
    }
    if (end > fpos) fpos = end;
    __syncwarp();
  }

  __device__ void run() {
    for (;;) {
      const int done = bcast_acquire(&s_done, lane);
      const int end = min(bcast_acquire(&s_wop, lane), lim);
      if (done) {
        store(end);
        return;
      }
      if ((end & ~3) > fpos) {
        store(end & ~3);
        if (lane == 0) st_release(&s_fpos, fpos);
      } else {
        __nanosleep(256);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
inflate_streams(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ meta,
                const uint32_t* __restrict__ win, int WW, uint32_t* __restrict__ out, int OW,
                int32_t* __restrict__ st) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int32_t* m = meta + (size_t)b * kMeta;
  const int nwin = m[4];
  if (threadIdx.x == 0) {
    s_wop = nwin << 2;
    s_done = 0;
    s_fpos = nwin << 2;
  }
  // the ring starts with the last <= 32 KiB of the window
  const uint32_t* wrow = win + (size_t)b * WW;
  uint32_t* ring32 = reinterpret_cast<uint32_t*>(smem);
  for (int i = max(0, nwin - 8192) + (int)threadIdx.x; i < nwin; i += kThreads)
    ring32[i & (kRing / 4 - 1)] = wrow[i];
  __syncthreads();

  if (threadIdx.x >= 32) {  // the copy warp
    Copier cp{out + (size_t)b * OW, m[3], lane, nwin << 2};
    cp.run();
    return;
  }

  // the decode warp
  const int start_bit = m[0];
  const int out_len = m[2];
  const bool stop = m[5] != 0;
  Decoder dc{Bits{words + (size_t)b * W, W - 1, 0, 0, 0, 0}, ring_base(), lane, m[1], m[3],
             start_bit,
             nwin << 2, nwin << 2, nwin << 2, 0, 0};
  dc.limits();
  dc.rd.seek(start_bit);
  bool bad = false, done = false, fin_seen = false;
  while (!(bad || done)) {
    const uint32_t w = dc.peek();
    const int final_ = (int)(w & 1u);
    const int btype = (int)((w >> 1) & 3u);
    dc.adv(3);
    bad = btype == 3 || dc.bp > dc.comp_bits;
    if (btype == 0) {
      dc.stored_block(&bad);
    } else if (btype == 1) {
      dc.fixed_lens();
      dc.coded_block(&bad, 288, 32);
    } else {  // 2, and 3 parses as 2 with bad already set
      int nlen, ndist;
      dc.dynamic_header(&nlen, &ndist, &bad);
      if (!bad) dc.coded_block(&bad, nlen, ndist);
    }
    done = final_ > 0 || (out_len >= 0 && dc.op >= out_len) || dc.bp >= dc.comp_bits;
    fin_seen = fin_seen || (final_ > 0 && !bad);
  }
  dc.publish(min(dc.op, dc.max_out));
  if (lane == 0) st_release(&s_done, 1);
  bad = bad || (out_len >= 0 && dc.op != out_len && !stop);
  if (lane == 0) {
    int32_t* so = st + (size_t)b * 4;
    so[0] = dc.op - (nwin << 2);
    so[1] = bad ? 1 : 0;
    so[2] = dc.bp;
    so[3] = fin_seen ? 1 : 0;
  }
}

}  // namespace

// smem: the dynamic shared memory the wrapper asks for, which must be the
// kernel's (the output ring)
extern "C" int zrs_inflate(const void* words, int batch, int w, const void* meta,
                           const void* win, int ww, void* out, int ow, void* st, int smem,
                           void* stream) {
  if (smem != kSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      inflate_streams, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // all of the unified cache as shared memory: three blocks an SM
  err = cudaFuncSetAttribute(inflate_streams, cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    inflate_streams<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)words, w, (const int32_t*)meta, (const uint32_t*)win, ww,
        (uint32_t*)out, ow, (int32_t*)st);
  }
  return (int)cudaGetLastError();
}
