// IS: a resumable raw-deflate decoder, one warp a handle and a launch.
//
// Replaces no pallas_call site. It is the card's counterpart of the
// reference's native resumable inflate (zlib_rs_tpu/native.py
// RawInflateStream over native/zrs_native.cpp InfStream::advance and
// zrs_istream_pump), the raw-body engine under the port's stream objects
// and gzip files (models/faststream.py). A pump appends its input to the
// handle's buffer in device memory and launches IS once; IS decodes as
// far as the input allows and stops where native's advance stops:
// - bits run out inside a symbol: the symbol's first bit is restored, so
//   no state is kept inside a symbol (native's save/restore);
// - a dynamic header is cut short (native's -3): back to the block's
//   first bit, to be parsed again when more input has come;
// - a stored block: the part that has arrived is copied;
// - the final block's end, or a data error (mode -1), with every byte
//   decoded before the error kept for the host to serve.
// native's acceptance rules are kept as they are: build_table (an
// incomplete code of one symbol passes in the litlen alphabet, one or
// none in the distance alphabet, the code-length code must be complete),
// parse_dynamic_tables, and `dist > op` as the far-back check (op counts
// a preset dictionary). The tables have native's layout (root
// min(max(R, minlen), maxlen), a subtable a root prefix as wide as its
// longest code), because a pause depends on it: native pauses when fewer
// than root + subtable bits are left, even for a shorter code.
//
// One more pause that native never needs: output room. Native grows its
// output vector without bound (a pump of 128 KiB can expand more than
// 1000 times); here the output buffer has a capacity, so IS also stops at
// a symbol boundary when the next literal, match or stored byte would not
// fit, and says so in the record; the wrapper grows the room and
// launches again. The served bytes do not show the pause.
//
// The handle's state lives in device memory between pumps: the record
// (kRec int64: mode, last, stored_left, the unconsumed input's offset and
// end, its bit offset, op, base, the output capacity, the two roots, the
// room flag), the current block's litlen and distance tables and the
// code-length table (table_words() uint32), the input not yet consumed
// (with 8 zero bytes past its end, so that a peek near the end reads
// zeros, as native's BitReader does), and the output behind op (the
// 32 KiB window plus what is not yet served; out[0] is absolute `base`).
//
// Bound on the H100. The bytes are the pump's input read once and its
// output written once, microseconds at 3.35 TB/s. That is not the floor:
// a deflate body is one serial chain (a code's length decides where the
// next code starts), so the floor is the pump's symbols times the latency
// of a table lookup and the shifts around it, as native's thread is.
//
// Design. All 32 lanes run native's control flow on the same values (EX's
// and SP2's way), so a table build, a stored copy and a match copy use
// every lane with no divergent branch: a literal is one store by every
// lane to the same byte; a match is copied 32 bytes a step (K6's and
// SP2's three cases: a run of one byte, every source before the step
// with a __syncwarp between steps, a period under 32 from the bytes
// before the match); a stored span a lane a byte; the table fills a lane
// a symbol, the subtable placement serial in symbol order as native's.
// The bits are read as 64 bits from two aligned words, cached while the
// position stays in the first word. Without __CUDACC__ the same source
// compiles as host C++ (a warp of one lane, zrs_istream_advance_host), so
// that the CPU tests run this file's control flow against native.

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define IS_DEV __device__
#define IS_INL __device__ __forceinline__
#define IS_CONST __constant__
#else
#define IS_DEV
#define IS_INL inline
#define IS_CONST static const
#endif

namespace {

constexpr int WSIZE = 32768;
constexpr int kTCap = 32768;  // entries a table: root 15 (a lone code) at most
constexpr int kClCap = 128;
constexpr int kTableWords = 2 * kTCap + kClCap;  // litlen, distance, code lengths
constexpr int kPrefixes = 1024;  // root prefixes that can own a subtable (root <= 10)

// the record, int64 a field (the wrapper's R_* names)
enum {
  R_MODE, R_LAST, R_STORED_LEFT, R_IN_OFF, R_IN_END, R_BIT_OFF, R_OP, R_BASE,
  R_OUT_CAP, R_LT_ROOT, R_DT_ROOT, R_ROOM, kRec = 16
};
constexpr int M_HEAD = 0, M_STORED = 1, M_CODED = 2, M_DONE = 3, M_ERR = -1;
// table entry (native's): bits 0-15 payload, 16-21 bits, 22-27 aux, 28-31 kind
constexpr int K_LIT = 0, K_MATCH = 1, K_EOB = 2, K_SUB = 3, K_BAD = 4;

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

IS_INL void warp_sync() {
#ifdef __CUDACC__
  __syncwarp();
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

// a table build's scratch (shared memory on the card)
struct Scratch {
  uint16_t lens[320];
  uint16_t codes[320];
  uint16_t cl[19];
  int32_t sub_off[kPrefixes];
  int32_t sub_bits[kPrefixes];
};

struct Inflater {
  long long* rec;
  uint32_t* lt;
  uint32_t* dt;
  uint32_t* ct;
  const uint8_t* in;
  uint8_t* out;
  Scratch* sc;
  int lane, lanes;
  long long bp, nbits;  // bit position in the input buffer; bits it holds
  long long op, base, cap, stored_left;
  int mode, last, lt_root, dt_root;
  bool room;
  long long cq;  // the word index the cached 64 bits start at
  uint64_t cw;

  IS_INL long long avail() const { return nbits - bp; }

  // >= 33 bits from bp, zero past the input's end
  IS_INL uint32_t peek() {
    const long long wq = bp >> 5;
    if (wq != cq) {
      uint32_t lo, hi;
#ifdef __CUDACC__
      const uint32_t* iw = (const uint32_t*)in;  // the buffer is word-aligned
      lo = iw[wq];
      hi = iw[wq + 1];
#else
      std::memcpy(&lo, in + 4 * wq, 4);
      std::memcpy(&hi, in + 4 * wq + 4, 4);
#endif
      cw = (uint64_t)lo | ((uint64_t)hi << 32);
      cq = wq;
    }
    return (uint32_t)(cw >> (bp & 31));
  }

  IS_INL uint32_t sym_entry(int alphabet, int s, int nbits_) const {
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

  // native's maxlen_for_prefix: the longest code past the root under a
  // root prefix, a lane a symbol and a warp max
  IS_DEV int prefix_bits(const uint16_t* lens, int n, int low, int root) const {
    int mx = 0;
    for (int s = lane; s < n; s += lanes)
      if (lens[s] > root && (int)low_bits(sc->codes[s], root) == low && lens[s] - root > mx)
        mx = lens[s] - root;
    return warp_max(mx);
  }

  // native build_table: alphabet 0 litlen, 1 distance, 2 code lengths;
  // 0, or -1 where native refuses the code
  IS_DEV int build_table(int alphabet, const uint16_t* lens, int n, int root, uint32_t* t,
                         int* root_out) {
    int cnt[16] = {0};
    int maxlen = 0, minlen = 16, ncodes = 0;
    for (int i = 0; i < n; i++) {
      const int l = lens[i];
      if (!l) continue;
      cnt[l]++;
      ncodes++;
      maxlen = l > maxlen ? l : maxlen;
      minlen = l < minlen ? l : minlen;
    }
    if (maxlen == 0) {
      if (alphabet != 1) return -1;
      if (lane == 0) t[0] = t[1] = mk_entry(K_BAD, 0, 1, 0);
      warp_sync();
      *root_out = 1;
      return 0;
    }
    int left = 1;
    for (int l = 1; l <= 15; l++) {
      left = (left << 1) - cnt[l];
      if (left < 0) return -1;
    }
    if (left > 0 && (alphabet == 2 || ncodes != 1)) return -1;
    root = root > minlen ? root : minlen;
    root = root < maxlen ? root : maxlen;
    if (maxlen > root && (1 << root) > kPrefixes) return -1;  // no code that passed gets here
    // canonical codes, LSB first (native canonical_codes); every lane
    // writes the same values
    uint32_t next[16] = {0};
    uint32_t code = 0;
    cnt[0] = 0;
    for (int l = 1; l <= 15; l++) {
      code = (code + (uint32_t)cnt[l - 1]) << 1;
      next[l] = code;
    }
    for (int s = 0; s < n; s++)
      sc->codes[s] = lens[s] ? (uint16_t)bit_reverse(next[lens[s]]++, lens[s]) : (uint16_t)0;
    const int rsize = 1 << root;
    for (int i = lane; i < rsize; i += lanes) t[i] = mk_entry(K_BAD, 0, root, 0);
    if (maxlen > root)
      for (int i = lane; i < rsize; i += lanes) sc->sub_off[i] = -1;
    warp_sync();
    // subtables in symbol order, as native allocates them
    int size = rsize;
    if (maxlen > root) {
      for (int s = 0; s < n; s++) {
        if (lens[s] <= root) continue;
        const int low = (int)low_bits(sc->codes[s], root);
        if (sc->sub_off[low] >= 0) continue;
        const int sb = prefix_bits(lens, n, low, root);
        if (size + (1 << sb) > kTCap) return -1;  // no code that passed gets here
        for (int i = lane; i < (1 << sb); i += lanes) t[size + i] = mk_entry(K_BAD, 0, sb, 0);
        if (lane == 0) t[low] = mk_entry(K_SUB, sb, root, size);
        sc->sub_off[low] = size;
        sc->sub_bits[low] = sb;
        size += 1 << sb;
        warp_sync();
      }
    }
    // a lane a symbol: the codes of a code that passed are prefix-free,
    // so no two lanes write one slot
    for (int s = lane; s < n; s += lanes) {
      const int l = lens[s];
      if (!l) continue;
      const uint32_t c = sc->codes[s];
      if (l <= root) {
        const uint32_t e = sym_entry(alphabet, s, l);
        for (uint32_t idx = c; idx < (uint32_t)rsize; idx += 1u << l) t[idx] = e;
      } else {
        const int low = (int)low_bits(c, root);
        const int off = sc->sub_off[low], sb = sc->sub_bits[low];
        const uint32_t e = sym_entry(alphabet, s, l - root);
        for (uint32_t idx = c >> root; idx < (1u << sb); idx += 1u << (l - root)) t[off + idx] = e;
      }
    }
    warp_sync();
    *root_out = root;
    return 0;
  }

  IS_DEV int fixed_tables() {
    for (int i = 0; i < 288; i++) sc->lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    if (build_table(0, sc->lens, 288, 9, lt, &lt_root)) return -1;
    for (int i = 0; i < 32; i++) sc->lens[i] = 5;
    return build_table(1, sc->lens, 32, 5, dt, &dt_root);
  }

  // native parse_dynamic_tables: 0, -1 data error, -3 cut short
  IS_DEV int parse_dynamic() {
    if (avail() < 14) return -3;
    const uint32_t h = peek();
    const int nlen = (int)(h & 31u) + 257;
    const int ndist = (int)((h >> 5) & 31u) + 1;
    const int ncode = (int)((h >> 10) & 15u) + 4;
    bp += 14;
    if (nlen > 286 || ndist > 30) return -1;
    for (int i = 0; i < 19; i++) sc->cl[i] = 0;
    for (int i = 0; i < ncode; i++) {
      if (avail() < 3) return -3;
      sc->cl[kClOrder[i]] = (uint16_t)(peek() & 7u);
      bp += 3;
    }
    int ct_root = 0;
    if (build_table(2, sc->cl, 19, 7, ct, &ct_root)) return -1;
    const int total = nlen + ndist;
    int have = 0;
    while (have < total) {
      if (avail() < 7) return -3;
      const uint32_t w = peek();
      const uint32_t e = ct[low_bits(w, ct_root)];
      const int nb = (e >> 16) & 0x3f;
      const int sym = e & 0xffff;
      if (avail() < nb) return -3;
      if (sym < 16) {
        bp += nb;
        sc->lens[have++] = (uint16_t)sym;
        continue;
      }
      const int extra = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (avail() < nb + extra) return -3;
      bp += nb;
      const int v = (int)low_bits(w >> nb, extra);
      bp += extra;
      int rep, fill = 0;
      if (sym == 16) {
        if (have == 0) return -1;
        rep = 3 + v;
        fill = sc->lens[have - 1];
      } else {
        rep = (sym == 17 ? 3 : 11) + v;
      }
      if (have + rep > total) return -1;
      while (rep--) sc->lens[have++] = (uint16_t)fill;
    }
    if (sc->lens[256] == 0) return -1;
    int lr = 0, dr = 0;
    if (build_table(0, sc->lens, nlen, 10, lt, &lr)) return -1;
    if (build_table(1, sc->lens + nlen, ndist, 9, dt, &dr)) return -1;
    lt_root = lr;
    dt_root = dr;
    return 0;
  }

  // a match of `length` bytes from `dist` back, at op: 32 bytes a step
  IS_DEV void copy_match(int length, int dist) {
    warp_sync();
    uint8_t* dst = out + (op - base);
    const uint8_t* src = dst - dist;
#ifdef __CUDACC__
    if (dist == 1) {
      const uint8_t v = src[0];
      for (int k = lane; k < length; k += 32) dst[k] = v;
    } else if (dist >= 32 || dist >= length) {
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) dst[k + lane] = src[k + lane];
        __syncwarp();
      }
    } else {
      int r = lane;
      while (r >= dist) r -= dist;
      int step = 32;
      while (step >= dist) step -= dist;
      for (int k = 0; k < length; k += 32) {
        if (k + lane < length) dst[k + lane] = src[r];
        r += step;
        if (r >= dist) r -= dist;
      }
    }
    __syncwarp();
#else
    for (int i = 0; i < length; i++) dst[i] = src[i];
#endif
  }

  // native InfStream::advance, with the room pause
  IS_DEV void advance() {
    room = false;
    if (mode == M_DONE || mode == M_ERR) return;
    const long long in_off = rec[R_IN_OFF];
    const int bit_off = (int)rec[R_BIT_OFF];
    if (bit_off && rec[R_IN_END] - in_off < 1) return;  // no byte to resume into
    bp = in_off * 8 + bit_off;
    nbits = rec[R_IN_END] * 8;
    for (;;) {
      if (mode == M_HEAD) {
        const long long sv = bp;
        if (avail() < 3) {
          bp = sv;
          break;
        }
        const uint32_t w = peek();
        const int fin = (int)(w & 1u), type = (int)((w >> 1) & 3u);
        bp += 3;
        if (type == 3) {
          mode = M_ERR;
          break;
        }
        if (type == 0) {
          bp = (bp + 7) & ~7LL;
          if (avail() < 32) {
            bp = sv;
            break;
          }
          const uint32_t v = peek();
          bp += 32;
          if (((v & 0xffffu) ^ (v >> 16)) != 0xffffu) {
            mode = M_ERR;
            break;
          }
          last = fin;
          stored_left = v & 0xffffu;
          mode = M_STORED;
        } else if (type == 1) {
          fixed_tables();
          last = fin;
          mode = M_CODED;
        } else {
          const int perr = parse_dynamic();
          if (perr == -3) {  // the header is cut short: wait for it
            bp = sv;
            break;
          }
          if (perr) {
            mode = M_ERR;
            break;
          }
          last = fin;
          mode = M_CODED;
        }
      } else if (mode == M_STORED) {  // bp is on a byte here
        const long long have = (nbits - bp) >> 3;
        const long long want = stored_left < have ? stored_left : have;
        const long long free = cap - (op - base);
        const long long take = want < free ? want : free;
        room = take < want;
        const uint8_t* src = in + (bp >> 3);
        uint8_t* dst = out + (op - base);
        for (long long j = lane; j < take; j += lanes) dst[j] = src[j];
        warp_sync();
        op += take;
        bp += 8 * take;
        stored_left -= take;
        if (stored_left) break;  // more input (or room) first
        mode = last ? M_DONE : M_HEAD;
        if (mode == M_DONE) break;
      } else {  // a coded block's body
        bool pause = false;
        const uint32_t lmask = (1u << lt_root) - 1u, dmask = (1u << dt_root) - 1u;
        long long sv = bp;  // the symbol's first bit, restored on a pause
        for (;;) {
          sv = bp;
          const uint32_t w = peek();
          uint32_t e = lt[w & lmask];
          int kind = (int)(e >> 28), nb = (e >> 16) & 0x3f;
          if (kind == K_SUB) {
            const int off = e & 0xffff, sb = (e >> 22) & 0x3f;
            if (avail() < nb + sb) {
              pause = true;
              break;
            }
            e = lt[off + low_bits(w >> nb, sb)];
            kind = (int)(e >> 28);
            nb += (e >> 16) & 0x3f;
          }
          if (avail() < nb) {
            pause = true;
            break;
          }
          if (kind == K_LIT) {
            if (op - base >= cap) {
              room = pause = true;
              break;
            }
            out[op - base] = (uint8_t)(e & 0xff);  // every lane, one byte
            op++;
            bp += nb;
            continue;
          }
          if (kind == K_EOB) {
            bp += nb;
            mode = last ? M_DONE : M_HEAD;
            break;
          }
          if (kind == K_BAD) {
            mode = M_ERR;
            break;
          }
          const int aux = (e >> 22) & 0x3f;
          if (avail() < nb + aux) {
            pause = true;
            break;
          }
          const int length = (int)(e & 0xffff) + (int)low_bits(w >> nb, aux);
          bp += nb + aux;
          const uint32_t w2 = peek();
          uint32_t de = dt[w2 & dmask];
          int dkind = (int)(de >> 28), dnb = (de >> 16) & 0x3f;
          if (dkind == K_SUB) {
            const int off = de & 0xffff, sb = (de >> 22) & 0x3f;
            if (avail() < dnb + sb) {
              pause = true;
              break;
            }
            de = dt[off + low_bits(w2 >> dnb, sb)];
            dkind = (int)(de >> 28);
            dnb += (de >> 16) & 0x3f;
          }
          if (dkind == K_BAD) {
            mode = M_ERR;
            break;
          }
          const int daux = (de >> 22) & 0x3f;
          if (avail() < dnb + daux) {
            pause = true;
            break;
          }
          const int dist = (int)(de & 0xffff) + (int)low_bits(w2 >> dnb, daux);
          bp += dnb + daux;
          if ((long long)dist > op) {
            mode = M_ERR;
            break;
          }
          if (op - base + length > cap) {
            room = pause = true;
            break;
          }
          copy_match(length, dist);
          op += length;
        }
        if (pause) bp = sv;
        if (pause || mode == M_DONE || mode == M_ERR) break;
      }
      if (mode == M_ERR) break;
    }
  }
};

// one handle's pump: load the record, advance, store the record
IS_DEV void run(long long* rec, uint32_t* tables, const uint8_t* in, uint8_t* out, Scratch* sc,
                int lane, int lanes) {
  Inflater s;
  s.rec = rec;
  s.lt = tables;
  s.dt = tables + kTCap;
  s.ct = tables + 2 * kTCap;
  s.in = in;
  s.out = out;
  s.sc = sc;
  s.lane = lane;
  s.lanes = lanes;
  s.mode = (int)rec[R_MODE];
  s.last = (int)rec[R_LAST];
  s.stored_left = rec[R_STORED_LEFT];
  s.op = rec[R_OP];
  s.base = rec[R_BASE];
  s.cap = rec[R_OUT_CAP];
  s.lt_root = (int)rec[R_LT_ROOT];
  s.dt_root = (int)rec[R_DT_ROOT];
  s.cq = -1;
  s.cw = 0;
  s.bp = -1;
  s.advance();
  warp_sync();
  if (lane == 0) {
    if (s.bp >= 0) {  // the input it consumed: whole bytes leave, the sub-byte stays
      rec[R_IN_OFF] = s.bp >> 3;
      rec[R_BIT_OFF] = s.bp & 7;
    }
    rec[R_MODE] = s.mode;
    rec[R_LAST] = s.last;
    rec[R_STORED_LEFT] = s.stored_left;
    rec[R_OP] = s.op;
    rec[R_LT_ROOT] = s.lt_root;
    rec[R_DT_ROOT] = s.dt_root;
    rec[R_ROOM] = s.room ? 1 : 0;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
istream_advance(long long* __restrict__ rec, uint32_t* __restrict__ tables,
                const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  __shared__ Scratch sc;
  run(rec, tables, in, out, &sc, threadIdx.x, 32);
}
#endif

}  // namespace

// uint32 words of a handle's tables; the record's length in int64
extern "C" long long zrs_istream_table_words() { return kTableWords; }
extern "C" long long zrs_istream_record_len() { return kRec; }

#ifdef __CUDACC__
// IS on one handle: rec int64 [kRec], tables uint32 [kTableWords], the
// input buffer (its capacity a multiple of 4, 8 zero bytes past R_IN_END)
// and the output buffer (R_OUT_CAP bytes from absolute R_BASE)
extern "C" int zrs_istream_advance(void* rec, void* tables, const void* in, void* out,
                                   void* stream) {
  istream_advance<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)rec, (uint32_t*)tables, (const uint8_t*)in, (uint8_t*)out);
  return (int)cudaGetLastError();
}
#else
// the same on the host with one lane: the CPU tests' way into this
// file's control flow
extern "C" int zrs_istream_advance_host(void* rec, void* tables, const void* in, void* out) {
  static Scratch sc;
  run((long long*)rec, (uint32_t*)tables, (const uint8_t*)in, (uint8_t*)out, &sc, 0, 1);
  return 0;
}
#endif
