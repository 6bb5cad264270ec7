// K6: the sequential RFC 1951 inflate, one raw-deflate stream per thread.
//
// Replaces zlib_rs_tpu/ops/pallas/inflate_kernel.py:decode_streams_pallas
// (body _kernel_body): stored, fixed and dynamic blocks, multi-block
// bodies, the two-level decode tables built inside the decode, a history
// window pre-copied in front of the output, a start bit anywhere, and a
// stop mode in which out_len is a checkpoint target. Outputs per stream:
// LE32 output words, produced, bad, end_bit, fin_seen.
//
// Bound on the H100: neither bytes nor operations. The format makes each
// stream one serial chain (a code's length decides where the next code
// starts), so a stream runs at one thread's latency: a table lookup in
// shared memory, a word read, a few ALU ops per symbol. The byte bound is
// the compressed bytes in and the output bytes out over 3.35 TB/s.
//
// Design: one block of one thread per stream, so that no two streams share
// a warp (their control flow diverges at every symbol) and the card keeps
// up to ~25 of them resident per SM. The stream's tables (litlen 852,
// distance 592 and code-length 128 entries), code lengths, sort space and
// counts live in the block's 8,976 bytes of static shared memory. The
// compressed words are read from device memory through the read-only
// cache, every index clamped to [0, W - 1] as the reference's dynamic
// reads clamp; the output row lives in device memory and every store past
// the row lands in its last (slack) word. The algorithm is the reference's
// as it stands: the literal sprint with its register for the output word,
// one match-copy path for every distance, the counting-sort table build
// with subtable sizing, the block loop and its exit rules, so that bad,
// produced, end_bit and fin_seen agree with it even on corrupt input.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLit = 0, kMatch = 1, kEob = 2, kSub = 3, kInvalid = 7;
constexpr int kLlRoot = 9, kDRoot = 6, kClRoot = 7;
constexpr int kLlCap = 852, kDCap = 592, kClCap = 128;
constexpr int kMeta = 8;

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
// n low bits set; all 32 for n >= 32 (a shift past the width gives 0, and
// 0 - 1 wraps, as in the reference)
__device__ __forceinline__ uint32_t low_mask(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}
__device__ __forceinline__ uint32_t shr(uint32_t x, int n) {
  return n >= 32 ? 0u : x >> n;
}

struct Stream {
  const uint32_t* words;
  int top;  // W - 1
  uint32_t* out;
  int dead;  // OW - 1: the slack word
  int comp_bits;
  int max_out;
  uint32_t* lltab;
  uint32_t* dtab;
  uint32_t* cltab;
  int* lens;
  int* work;
  int* cnt;
  int* offs;

  __device__ uint32_t word(int i) const {
    i = i < 0 ? 0 : (i > top ? top : i);
    return __ldg(words + i);
  }

  __device__ uint32_t peek32(int bp) const {
    const int wi = bp >> 5;
    const int sh = bp & 31;
    if (sh) return (word(wi) >> sh) | (word(wi + 1) << (32 - sh));
    return word(wi);
  }

  __device__ uint32_t src4(int p, int dist) const {
    const int s0 = p - dist;
    int swi = s0 >> 2;
    swi = swi < 0 ? 0 : (swi > dead - 1 ? dead - 1 : swi);
    const int ssh = (s0 & 3) << 3;
    uint32_t v = out[swi];
    if (ssh) v = (v >> ssh) | (out[swi + 1] << (32 - ssh));
    if (dist == 1) return (v & 0xFFu) * 0x01010101u;
    if (dist == 2) return (v & 0xFFFFu) * 0x00010001u;
    if (dist == 3) return (v & 0xFFFFFFu) | ((v & 0xFFu) << 24);
    return v;
  }

  __device__ void masked_store(int p, int nby, uint32_t v) {
    if (nby == 0) return;  // the reference rewrites the slack word as it is
    const int sh = (p & 3) << 3;
    const uint32_t m = (0xFFFFFFFFu >> ((4 - nby) << 3)) << sh;
    const int wi = min(p >> 2, dead);
    out[wi] = (out[wi] & ~m) | ((v << sh) & m);
  }

  __device__ void copy_match(int p, int length, int dist) {
    const int head = min((4 - (p & 3)) & 3, length);
    masked_store(p, head, src4(p, dist));
    const int nwords = (length - head) >> 2;
    const int wbase = (p + head) >> 2;
    for (int k = 0; k < nwords; k++) out[wbase + k] = src4((wbase + k) << 2, dist);
    const int tail0 = p + head + (nwords << 2);
    masked_store(tail0, p + length - tail0, src4(tail0, dist));
  }

  // (kind, extra, val) of symbol `sym`: kind_of 0 = code lengths,
  // 1 = litlen, 2 = distance
  __device__ static uint32_t sym_entry(int kind_of, int sym, int nbits) {
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

  // two-level canonical table from lens[lens_base : lens_base + nsyms];
  // returns root bits, sets *bad_out
  __device__ int build_table(uint32_t* tab, int cap, int nsyms, int lens_base,
                             int root_in, int kind_of, bool* bad_out) {
    for (int i = 0; i < 16; i++) cnt[i] = 0;
    for (int i = 0; i < nsyms; i++) {
      const int l = lens[lens_base + i];
      if (l > 0) cnt[l]++;
    }
    int maxlen = 0;
    for (int i = 1; i < 16; i++)
      if (cnt[i] > 0) maxlen = i;
    int minlen = 15;
    for (int j = 15; j > 0; j--)
      if (cnt[j] > 0) minlen = j;
    const int root = min(max(root_in, minlen), max(maxlen, 1));
    int left = 1, ncodes = 0;
    for (int i = 1; i < 16; i++) {
      left = left * 2 - cnt[i];
      ncodes += cnt[i];
    }
    bool b = left < 0 || (left > 0 && !(kind_of == 2 && ncodes <= 1));
    b = b || maxlen == 0;
    offs[1] = 0;
    for (int i = 2; i < 16; i++) offs[i] = offs[i - 1] + cnt[i - 1];
    for (int i = 0; i < nsyms; i++) {
      const int l = lens[lens_base + i];
      if (l > 0) work[offs[l]++] = i;
    }
    const uint32_t inv = entry(kInvalid, 0, root, 0);
    for (int i = 0; i < cap; i++) tab[i] = inv;
    const uint32_t rmask = (1u << root) - 1u;
    uint32_t huff = 0;
    int low = -1, drop = 0, curr = root, sub_off = 0, used = 1 << root;
    for (int k = 0; k < ncodes; k++) {
      const int sym = work[k];
      const int l = lens[lens_base + sym];
      if (l > root && (int)(huff & rmask) != low) {
        drop = root;
        int c = l - drop;
        int lft = 1 << c;
        while (lft > 0 && c + drop < maxlen) {
          lft -= cnt[c + drop];
          if (lft > 0 && c + drop < maxlen) {
            c++;
            lft *= 2;
          }
        }
        curr = c;
        sub_off = used;
        used += 1 << c;
        low = (int)(huff & rmask);
        b = b || used > cap;
        if (!b) tab[low] = entry(kSub, c, root, sub_off);
      }
      const uint32_t ent = sym_entry(kind_of, sym, l);
      const int base = drop > 0 ? sub_off : 0;
      const int idx = (int)(huff >> drop);
      const int step = 1 << (l - drop);
      int f = 1 << (drop > 0 ? curr : root);
      while (f > 0) {
        f -= step;
        const int slot = base + idx + f;
        b = b || slot >= cap || slot < 0;
        if (!b) tab[slot] = ent;
      }
      cnt[l]--;
      uint32_t incr = 1u << (l - 1);
      while (huff & incr) incr >>= 1;
      huff = incr ? (huff & (incr - 1u)) + incr : 0u;
    }
    *bad_out = b;
    return root;
  }

  __device__ uint32_t lookup(const uint32_t* tab, uint32_t w, uint32_t mask,
                             int root) const {
    const uint32_t e0 = tab[w & mask];
    if (e_kind(e0) == kSub)
      return tab[e_val(e0) + (int)(shr(w, root) & low_mask(e_extra(e0)))];
    return e0;
  }

  __device__ void stored_block(int* bp_io, int* op_io, bool* bad_io) {
    int bp = (*bp_io + 7) & ~7;
    const int op = *op_io;
    const uint32_t w = peek32(bp);
    const int ln = (int)(w & 0xFFFFu);
    const int nln = (int)(w >> 16);
    bp += 32;
    bool bad = *bad_io;
    bad = bad || (ln ^ 0xFFFF) != nln;
    bad = bad || bp + ln * 8 > comp_bits + 32;
    bad = bad || op + ln > max_out;
    *bad_io = bad;
    if (bad) {
      *bp_io = bp;
      return;
    }
    const int head = min((4 - (op & 3)) & 3, ln);
    for (int j = 0; j < ln; j++) {
      if (j == head) {  // the dst-aligned word copy
        const int nwords = (ln - head) >> 2;
        const int wbase = (op + head) >> 2;
        const int s0 = (bp >> 3) + head;
        const int swi = s0 >> 2;
        const int ssh = (s0 & 3) << 3;
        for (int k = 0; k < nwords; k++) {
          uint32_t v = word(swi + k);
          if (ssh) v = (v >> ssh) | (word(swi + k + 1) << (32 - ssh));
          out[wbase + k] = v;
        }
        j = head + (nwords << 2);
        if (j >= ln) break;
      }
      const uint32_t v = peek32(bp + (j << 3)) & 0xFFu;
      const int pos = op + j;
      const int sh = (pos & 3) << 3;
      out[pos >> 2] = (out[pos >> 2] & ~(0xFFu << sh)) | (v << sh);
    }
    *bp_io = bp + (ln << 3);
    *op_io = op + ln;
  }

  __device__ void fixed_lens() {
    for (int i = 0; i < 288; i++) lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    for (int i = 0; i < 32; i++) lens[288 + i] = 5;
  }

  __device__ void dynamic_header(int* bp_io, int* nlen_out, int* ndist_out,
                                 bool* bad_io) {
    int bp = *bp_io;
    bool bad = *bad_io;
    const uint32_t w = peek32(bp);
    const int nlen = (int)(w & 31u) + 257;
    const int ndist = (int)((w >> 5) & 31u) + 1;
    const int hclen = (int)((w >> 10) & 15u) + 4;
    bp += 14;
    bad = bad || nlen > 286 || ndist > 30;
    for (int i = 0; i < 19; i++) lens[i] = 0;
    for (int i = 0; i < hclen; i++) {
      lens[kClOrder[i]] = (int)(peek32(bp) & 7u);
      bp += 3;
    }
    bool clbad;
    const int clroot = build_table(cltab, kClCap, 19, 0, kClRoot, 0, &clbad);
    bad = bad || clbad;
    const uint32_t cl_mask = (1u << clroot) - 1u;
    const int total = nlen + ndist;
    int i = 0, prev = -1;
    while (i < total && !bad) {
      const uint32_t e = cltab[peek32(bp) & cl_mask];
      const int sym = e_val(e);
      bad = bad || e_kind(e) == kInvalid;
      bp += e_nbits(e);
      const uint32_t w2 = peek32(bp);
      if (sym < 16) {
        lens[i] = sym;
        i++;
        prev = sym;
        continue;
      }
      const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      const int r = (int)(w2 & ((1u << ebits) - 1u)) + (sym == 18 ? 11 : 3);
      const int v = sym == 16 ? prev : 0;
      bad = bad || (sym == 16 && i == 0) || i + r > total;
      if (!bad)
        for (int j = 0; j < r; j++)
          if (i + j < total) lens[i + j] = v;
      i += r;
      bp += ebits;
      prev = v;
    }
    bad = bad || bp > comp_bits + 32;
    // distance lengths move to lens[288:]; the ranges may overlap, so the
    // copy runs from the top down
    for (int j = 31; j >= 0; j--)
      if (j < ndist) lens[288 + j] = lens[nlen + j];
    bad = bad || lens[256] == 0;
    *bp_io = bp;
    *nlen_out = nlen;
    *ndist_out = ndist;
    *bad_io = bad;
  }

  __device__ void coded_block(int* bp_io, int* op_io, bool* bad_io, int nlen,
                              int ndist) {
    bool b1, b2;
    const int ll_root = build_table(lltab, kLlCap, nlen, 0, kLlRoot, 1, &b1);
    const int d_root = build_table(dtab, kDCap, ndist, 288, kDRoot, 2, &b2);
    bool bad = *bad_io || b1 || b2;
    const uint32_t ll_mask = (1u << ll_root) - 1u;
    const uint32_t d_mask = (1u << d_root) - 1u;
    int bp = *bp_io, op = *op_io;
    uint32_t oword = out[min(op >> 2, dead)] & ((1u << ((op & 3) << 3)) - 1u);
    bool eob = false;
    while (!(bad || eob) && bp <= comp_bits) {
      uint32_t w = peek32(bp);
      uint32_t e = lookup(lltab, w, ll_mask, ll_root);
      // the literal sprint: one literal, then a second if the next code is
      // one too; stores past the row land in the slack word
      while (e_kind(e) == kLit && bp <= comp_bits) {
        const uint32_t ow2 = oword | ((e & 0xFFu) << ((op & 3) << 3));
        out[min(op >> 2, dead)] = ow2;
        oword = (op & 3) == 3 ? 0u : ow2;
        bp += e_nbits(e);
        op++;
        w = peek32(bp);
        e = lookup(lltab, w, ll_mask, ll_root);
        if (e_kind(e) == kLit && bp <= comp_bits) {
          const uint32_t ow3 = oword | ((e & 0xFFu) << ((op & 3) << 3));
          out[min(op >> 2, dead)] = ow3;
          oword = (op & 3) == 3 ? 0u : ow3;
          bp += e_nbits(e);
          op++;
          w = peek32(bp);
          e = lookup(lltab, w, ll_mask, ll_root);
        } else {
          out[dead] = oword;
        }
      }
      bad = bad || op > max_out;
      const bool exhausted = bp > comp_bits;
      const uint32_t kind = e_kind(e);
      const int nb = e_nbits(e);
      const bool is_eob = kind == kEob && !exhausted;
      const bool is_match = kind == kMatch && !exhausted;
      bad = bad || (!exhausted && !(is_eob || is_match));
      if (is_eob) {
        bp += nb;
        eob = true;
      }
      if (is_match) {
        const int lext = e_extra(e);
        const int length = e_val(e) + (int)(shr(w, nb) & low_mask(lext));
        bp += nb + lext;
        const uint32_t w2 = peek32(bp);
        const uint32_t de = lookup(dtab, w2, d_mask, d_root);
        bad = bad || e_kind(de) != kMatch;
        const int dnb = e_nbits(de);
        const int dext = e_extra(de);
        const int dist = e_val(de) + (int)(shr(w2, dnb) & low_mask(dext));
        bp += dnb + dext;
        bad = bad || dist > op || op + length > max_out || dist < 1;
        if (!bad) {
          copy_match(op, length, dist);
          op += length;
        }
        oword = out[min(op >> 2, dead)] & ((1u << ((op & 3) << 3)) - 1u);
      }
    }
    *bp_io = bp;
    *op_io = op;
    *bad_io = bad;
  }
};

__global__ void inflate_streams(const uint32_t* __restrict__ words, int W,
                                const int32_t* __restrict__ meta,
                                const uint32_t* __restrict__ win, int WW,
                                uint32_t* __restrict__ out, int OW,
                                int32_t* __restrict__ st) {
  __shared__ uint32_t lltab[kLlCap];
  __shared__ uint32_t dtab[kDCap];
  __shared__ uint32_t cltab[kClCap];
  __shared__ int lens[320];
  __shared__ int work[320];
  __shared__ int cnt[16];
  __shared__ int offs[16];

  const int b = blockIdx.x;
  const int32_t* m = meta + (size_t)b * kMeta;
  const int start_bit = m[0];
  const int out_len = m[2];
  const int nwin = m[4];
  const bool stop = m[5] != 0;

  Stream s;
  s.words = words + (size_t)b * W;
  s.top = W - 1;
  s.out = out + (size_t)b * OW;
  s.dead = OW - 1;
  s.comp_bits = m[1];
  s.max_out = m[3];
  s.lltab = lltab;
  s.dtab = dtab;
  s.cltab = cltab;
  s.lens = lens;
  s.work = work;
  s.cnt = cnt;
  s.offs = offs;

  const uint32_t* wrow = win + (size_t)b * WW;
  for (int i = 0; i < nwin; i++) s.out[i] = wrow[i];

  int bp = start_bit, op = nwin << 2;
  bool bad = false, done = false, fin_seen = false;
  while (!(bad || done)) {
    const uint32_t w = s.peek32(bp);
    const int final_ = (int)(w & 1u);
    const int btype = (int)((w >> 1) & 3u);
    bp += 3;
    bad = btype == 3 || bp > s.comp_bits;
    if (btype == 0) {
      s.stored_block(&bp, &op, &bad);
    } else if (btype == 1) {
      s.fixed_lens();
      s.coded_block(&bp, &op, &bad, 288, 32);
    } else {  // 2, and 3 parses as 2 with bad already set
      int nlen, ndist;
      s.dynamic_header(&bp, &nlen, &ndist, &bad);
      if (!bad) s.coded_block(&bp, &op, &bad, nlen, ndist);
    }
    done = final_ > 0 || (out_len >= 0 && op >= out_len) || bp >= s.comp_bits;
    fin_seen = fin_seen || (final_ > 0 && !bad);
  }
  bad = bad || (out_len >= 0 && op != out_len && !stop);
  int32_t* so = st + (size_t)b * 4;
  so[0] = op - (nwin << 2);
  so[1] = bad ? 1 : 0;
  so[2] = bp;
  so[3] = fin_seen ? 1 : 0;
}

}  // namespace

extern "C" int zrs_inflate(const void* words, int batch, int w, const void* meta,
                           const void* win, int ww, void* out, int ow, void* st,
                           void* stream) {
  if (batch > 0) {
    inflate_streams<<<batch, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, w, (const int32_t*)meta, (const uint32_t*)win,
        ww, (uint32_t*)out, ow, (int32_t*)st);
  }
  return (int)cudaGetLastError();
}
