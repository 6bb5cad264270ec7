// IS: a resumable raw-deflate decoder, one thread block a handle and a
// launch.
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
// room flag), the current block's litlen and distance tables and its
// code lengths (table_words() uint32),
// the input not yet consumed (with 8 zero bytes past its end, so that a
// peek near the end reads zeros, as native's BitReader does), and the
// output behind op (the 32 KiB window plus what is not yet served; out[0]
// is absolute `base`).
//
// Bound on the H100. The bytes are the pump's input read once and its
// output written once, microseconds at 3.35 TB/s. A deflate body is one
// serial chain (a code's length decides where the next code starts), so a
// decoder that follows it is bound by the pump's symbols times the latency
// of a table lookup, as native's thread is. The design below breaks the
// chain inside each coded block.
//
// Design: one block of kThreads threads a launch (istream_sync). The body
// (staging, the compact tables, the sync decode, the expansion) is
// sync_body.cuh's, shared with SP2 (speculative.cu).
// - The head is warp 0. It runs native's control flow (Inflater below,
//   all 32 lanes on the same values, EX's and SP2's way) for block
//   headers (parse_dynamic, with build_table's verdict from the code
//   lengths' counts), stored blocks (copied by the whole block) and every
//   symbol within kMargin bits of the input's end: the tail, where
//   native's pauses live. Native's tables, in native's layout in device
//   memory, are built only where the tail decodes or the launch ends
//   inside a block. The head hands a coded body to the block whenever more
//   than kMargin + kMinBody bits are left, and takes the state back after
//   it; below that it decodes alone, as the one-warp launch does.
// - The body decodes a window of up to 32 KiB of input at a time, staged
//   in shared memory with cp.async, from a known litlen-code start w0. A
//   compact decode table in shared memory (roots 10 and 8, a canonical
//   walk for longer codes; a hole of an incomplete code decodes as bad) is
//   built once a block from the code lengths the head kept.
// - The sync decode. The window is cut into sub-ranges of L bits, one a
//   thread. Each thread decodes from its sub-range's start as though a
//   litlen code began there, marks every litlen-code start it passes in a
//   bitmap (a bit an input bit), and stops at the first litlen start past
//   its sub-range (its exit), or at an EOB or a bad symbol. Thread 0's
//   start is exact; thread i's true entry is thread i-1's true exit. In
//   rounds, a thread whose entry changed decodes again from it until it
//   lands on a litlen start its first pass marked (from there both decodes
//   are the same: a litlen start is a whole decoder state, a bit position
//   is not) or leaves its sub-range. After kMaxRounds rounds thread 0
//   finishes the chain alone, so the result is exact whatever the data.
// - The expansion. Each thread counts its confirmed tokens' output, a
//   block scan gives every token its output position, literals are
//   written at once and every match byte takes a pointer to its source
//   (into the period of a match shorter than its length; a pointer before
//   the window is a byte already) in a scratch in device memory (L2) of
//   kPtrCap entries. Pointer jumping, p[i] = p[p[i]], one barrier a round,
//   eight pointers a thread in flight, resolves the chains. Where the sync
//   decode ends the window at an EOB, the head warp parses the next
//   block's header meanwhile (it writes no output) and the other 31 warps
//   expand, on a named barrier of their own; the parse is taken if the
//   window does end there, else undone. The first
//   token that is bad, points too far back (native's `dist > op`), does
//   not fit the room, or starts within kMargin bits of the input's end,
//   ends the body before it: from that litlen start the head decodes on
//   with native's code, so every pause, error and bit offset is native's.
//
// Without __CUDACC__ the same source compiles as host C++: the one-warp
// launch as a warp of one lane (zrs_istream_advance_host) and the block's
// launch with its threads run in turn, L an argument
// (zrs_istream_sync_host), so that the CPU tests run this file's control
// flow against native. zrs_istream_advance, the one-warp launch, stays for
// the probes that time the two.

#include "sync_body.cuh"

namespace {

constexpr int WSIZE = 32768;
constexpr int kTCap = 32768;  // entries a table: root 15 (a lone code) at most
constexpr int kClCap = 128;  // the code-length code's table (shared memory)
constexpr int kLensOff = 2 * kTCap;  // the block's code lengths, uint16 [320]
constexpr int kTableWords = kLensOff + 160;  // litlen, distance, the code lengths
constexpr int kPrefixes = 1024;  // root prefixes that can own a subtable (root <= 10)

// the record, int64 a field (the wrapper's R_* names)
enum {
  R_MODE, R_LAST, R_STORED_LEFT, R_IN_OFF, R_IN_END, R_BIT_OFF, R_OP, R_BASE,
  R_OUT_CAP, R_LT_ROOT, R_DT_ROOT, R_ROOM, kRec = 16
};

// a table build's scratch (shared memory on the card)
struct Scratch {
  uint32_t ct[kClCap];  // the code-length code's table: it lives only inside parse_dynamic
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
  uint16_t* lens_out;  // the block's code lengths, for the body's table
  const uint8_t* in;
  uint8_t* out;
  Scratch* sc;
  int lane, lanes;
  long long bp, nbits;  // bit position in the input buffer; bits it holds
  long long op, base, cap, stored_left;
  int mode, last, lt_root, dt_root;
  bool room;
  bool par;     // the block's launch: hand coded bodies and stored spans to the block
  bool no_par;  // the body refused a token: decode on here
  bool built;   // native's tables hold the current block's code
  int gen;      // code lengths kept in this launch
  long long pending;  // a stored span the block is copying
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

  // native's maxlen_for_prefix: the longest code past the root under a
  // root prefix, a lane a symbol and a warp max
  IS_DEV int prefix_bits(const uint16_t* lens, int n, int low, int root) const {
    int mx = 0;
    for (int s = lane; s < n; s += lanes)
      if (lens[s] > root && (int)low_bits(sc->codes[s], root) == low && lens[s] - root > mx)
        mx = lens[s] - root;
    return warp_max(mx);
  }

  // a code's count of each length 1-15, its longest and shortest length
  // and its number of codes: on the card a lane a symbol and a ballot a
  // length
  IS_DEV void count_lengths(const uint16_t* lens, int n, int* cnt, int* maxlen, int* minlen,
                            int* ncodes) const {
    for (int l = 0; l < 16; l++) cnt[l] = 0;
#ifdef __CUDACC__
    for (int base = 0; base < n; base += 32) {
      const int l = base + lane < n ? lens[base + lane] : 0;
IS_UNROLL
      for (int k = 1; k < 16; k++) cnt[k] += __popc(__ballot_sync(0xFFFFFFFFu, l == k));
    }
#else
    for (int i = 0; i < n; i++) cnt[lens[i]]++;
    cnt[0] = 0;
#endif
    *maxlen = 0;
    *minlen = 16;
    *ncodes = 0;
    for (int l = 1; l < 16; l++) {
      if (!cnt[l]) continue;
      *ncodes += cnt[l];
      *maxlen = l;
      if (*minlen == 16) *minlen = l;
    }
  }

  // native build_table: alphabet 0 litlen, 1 distance, 2 code lengths;
  // 0, or -1 where native refuses the code
  IS_DEV int build_table(int alphabet, const uint16_t* lens, int n, int root, uint32_t* t,
                         int* root_out) {
    int cnt[16];
    int maxlen, minlen, ncodes;
    count_lengths(lens, n, cnt, &maxlen, &minlen, &ncodes);
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

  // the block's code lengths for the body's table: litlen [0, 288),
  // distance [288, 320), zero where the header sends none
  IS_DEV void keep_lens(const uint16_t* ll, int nlen, const uint16_t* dl, int ndist) {
    for (int i = lane; i < 320; i += lanes)
      lens_out[i] = i < 288 ? (i < nlen ? ll[i] : 0) : (i - 288 < ndist ? dl[i - 288] : 0);
    warp_sync();
    gen++;
    built = false;
  }

  // native build_table's verdict alone, from the counts
  IS_DEV bool code_ok(int alphabet, const uint16_t* lens, int n) const {
    int cnt[16];
    int maxlen, minlen, ncodes;
    count_lengths(lens, n, cnt, &maxlen, &minlen, &ncodes);
    if (maxlen == 0) return alphabet == 1;
    int left = 1;
    for (int l = 1; l <= 15; l++) {
      left = (left << 1) - cnt[l];
      if (left < 0) return false;
    }
    return !(left > 0 && (alphabet == 2 || ncodes != 1));
  }

  // native's litlen and distance tables of the kept code lengths, built
  // where a symbol is decoded here (the tail) or the launch ends inside
  // the block: the body never reads them. Roots 10 and 9 give the fixed
  // code native's 9 and 5 (min(max(R, minlen), maxlen)).
  IS_DEV void ensure_tables() {
    if (built) return;
    build_table(0, lens_out, 288, 10, lt, &lt_root);
    build_table(1, lens_out + 288, 32, 9, dt, &dt_root);
    built = true;
  }

  IS_DEV void fixed_tables() {
    for (int i = 0; i < 288; i++) sc->lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    for (int i = 288; i < 320; i++) sc->lens[i] = 5;
    keep_lens(sc->lens, 288, sc->lens + 288, 32);
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
    // with 14 bits a code length at hand (a 7-bit code and 7 extra bits),
    // no check below can find the header cut short
    const bool whole = avail() >= 14LL * total;
    while (have < total) {
      if (!whole && avail() < 7) return -3;
      const uint32_t w = peek();
      const uint32_t e = ct[low_bits(w, ct_root)];
      const int nb = (e >> 16) & 0x3f;
      const int sym = e & 0xffff;
      if (!whole && avail() < nb) return -3;
      if (sym < 16) {
        bp += nb;
        sc->lens[have++] = (uint16_t)sym;
        continue;
      }
      const int extra = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (!whole && avail() < nb + extra) return -3;
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
    if (!code_ok(0, sc->lens, nlen) || !code_ok(1, sc->lens + nlen, ndist)) return -1;
    keep_lens(sc->lens, nlen, sc->lens + nlen, ndist);
    return 0;
  }

  // a match of `length` bytes from `dist` back, at op: 32 bytes a step
  IS_DEV void copy_match(int length, int dist) {
    warp_sync();
    uint8_t* dst = out + (op - base);
    const uint8_t* src = dst - dist;
#ifdef __CUDACC__
    if (lanes == 1) {
      for (int i = 0; i < length; i++) dst[i] = src[i];
    } else if (dist == 1) {
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

  // a block header at bp (native's M_HEAD step): true where the advance
  // stops (input short, or a data error), with bp as native leaves it
  IS_DEV bool head_step() {
    const long long sv = bp;
    if (avail() < 3) {
      bp = sv;
      return true;
    }
    const uint32_t w = peek();
    const int fin = (int)(w & 1u), type = (int)((w >> 1) & 3u);
    bp += 3;
    if (type == 3) {
      mode = M_ERR;
      return true;
    }
    if (type == 0) {
      bp = (bp + 7) & ~7LL;
      if (avail() < 32) {
        bp = sv;
        return true;
      }
      const uint32_t v = peek();
      bp += 32;
      if (((v & 0xffffu) ^ (v >> 16)) != 0xffffu) {
        mode = M_ERR;
        return true;
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
        return true;
      }
      if (perr) {
        mode = M_ERR;
        return true;
      }
      last = fin;
      mode = M_CODED;
    }
    return false;
  }

  // the body's head parses the next header during an expansion
  static constexpr bool kSpeculates = true;

  // the state a speculative header parse may change
  struct Saved {
    long long bp, stored_left;
    int mode, last, gen;
    bool built;
  };

  // the next block's header at bit `at`, parsed while the other warps
  // expand the window that the sync decode ends there (an EOB): it writes
  // no output, only this warp's scratch and the kept code lengths
  IS_DEV void speculate(long long at, Saved& sv) {
    sv.bp = bp;
    sv.stored_left = stored_left;
    sv.mode = mode;
    sv.last = last;
    sv.gen = gen;
    sv.built = built;
    bp = at;
    mode = M_HEAD;
    head_step();
  }

  // the window ended before its EOB: back to the state before the
  // speculation, the kept code lengths (`lens`, the body's copy) too
  IS_DEV void restore(const Saved& sv, const uint16_t* lens) {
    if (gen != sv.gen) {
      for (int i = lane; i < 320; i += lanes) lens_out[i] = lens[i];
      warp_sync();
    }
    bp = sv.bp;
    stored_left = sv.stored_left;
    mode = sv.mode;
    last = sv.last;
    gen = sv.gen;
    built = sv.built;
  }

  // after the expansion: the speculation taken (the window did end at
  // its EOB) keeps the parse, else it is undone
  IS_DEV void settle(bool taken, const Saved& sv, const Body* b) {
    if (taken)
      op = b->op;
    else
      restore(sv, b->lens);
  }

  // native InfStream::advance's entry: false where it decodes nothing
  IS_DEV bool begin() {
    room = false;
    if (mode == M_DONE || mode == M_ERR) return false;
    const long long in_off = rec[R_IN_OFF];
    const int bit_off = (int)rec[R_BIT_OFF];
    if (bit_off && rec[R_IN_END] - in_off < 1) return false;  // no byte to resume into
    bp = in_off * 8 + bit_off;
    nbits = rec[R_IN_END] * 8;
    return true;
  }

  // the end of a stored span of `take` bytes; true where the advance stops
  IS_DEV bool stored_taken(long long take) {
    op += take;
    bp += 8 * take;
    stored_left -= take;
    if (stored_left) return true;  // more input (or room) first
    mode = last ? M_DONE : M_HEAD;
    return mode == M_DONE;
  }

  // native InfStream::advance, with the room pause: A_STOP where it
  // stops; in the block's launch A_BODY (a coded body with more than
  // kMargin bits left) and A_COPY (a stored span), each resumed here
  IS_DEV int resume() {
    if (mode == M_DONE || mode == M_ERR) return A_STOP;  // the body ended the stream
    if (pending >= 0) {
      const long long take = pending;
      pending = -1;
      if (stored_taken(take)) return A_STOP;
    }
    for (;;) {
      if (mode == M_HEAD) {
        if (head_step()) break;
      } else if (mode == M_STORED) {  // bp is on a byte here
        const long long have = (nbits - bp) >> 3;
        const long long want = stored_left < have ? stored_left : have;
        const long long free = cap - (op - base);
        const long long take = want < free ? want : free;
        room = take < want;
        if (par && take >= kBlockCopy) {
          pending = take;
          return A_COPY;
        }
        const uint8_t* src = in + (bp >> 3);
        uint8_t* dst = out + (op - base);
        for (long long j = lane; j < take; j += lanes) dst[j] = src[j];
        warp_sync();
        if (stored_taken(take)) break;
      } else {  // a coded block's body
        if (par && !no_par && avail() > kMargin + kMinBody) return A_BODY;
        ensure_tables();
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
    return A_STOP;
  }

  IS_DEV void load(long long* rec_, uint32_t* tables, const uint8_t* in_, uint8_t* out_,
                   Scratch* sc_, int lane_, int lanes_, bool par_) {
    rec = rec_;
    lt = tables;
    dt = tables + kTCap;
    ct = sc_->ct;
    lens_out = (uint16_t*)(tables + kLensOff);
    in = in_;
    out = out_;
    sc = sc_;
    lane = lane_;
    lanes = lanes_;
    par = par_;
    no_par = false;
    built = true;  // the record's block, if any, was built before this launch
    gen = 0;
    pending = -1;
    mode = (int)rec[R_MODE];
    last = (int)rec[R_LAST];
    stored_left = rec[R_STORED_LEFT];
    op = rec[R_OP];
    base = rec[R_BASE];
    cap = rec[R_OUT_CAP];
    lt_root = (int)rec[R_LT_ROOT];
    dt_root = (int)rec[R_DT_ROOT];
    cq = -1;
    cw = 0;
    bp = -1;
  }

  IS_DEV void store() {
    if (mode == M_CODED) ensure_tables();
    if (lane == 0) {
      if (bp >= 0) {  // the input it consumed: whole bytes leave, the sub-byte stays
        rec[R_IN_OFF] = bp >> 3;
        rec[R_BIT_OFF] = bp & 7;
      }
      rec[R_MODE] = mode;
      rec[R_LAST] = last;
      rec[R_STORED_LEFT] = stored_left;
      rec[R_OP] = op;
      rec[R_LT_ROOT] = lt_root;
      rec[R_DT_ROOT] = dt_root;
      rec[R_ROOM] = room ? 1 : 0;
    }
  }
};

// one handle's pump, one warp: load the record, advance, store the record
IS_DEV void run(long long* rec, uint32_t* tables, const uint8_t* in, uint8_t* out, Scratch* sc,
                int lane, int lanes) {
  Inflater s;
  s.load(rec, tables, in, out, sc, lane, lanes, false);
  if (s.begin()) s.resume();
  warp_sync();
  s.store();
}


// one handle's pump, the whole block: the head hands bodies and stored
// spans to the block until it stops
IS_DEV void run_sync(long long* rec, uint32_t* tables, const uint8_t* in, long long in_words,
                     uint8_t* out, int32_t* ptrs, long long* stats, int L, int T, Body* b,
                     Scratch* sc, int tid, int nthr) {
  const bool head = tid < 32;
  const int lanes = nthr < 32 ? nthr : 32;
  Inflater s;
  if (head) {
    s.load(rec, tables, in, out, sc, tid, lanes, true);
    const bool go = s.begin();
    if (tid == 0) {
      b->go = go;
      b->gen = 0;
      b->lut_gen = -1;
    }
  }
  block_sync();
  if (b->go) {
    for (;;) {
      if (head) {
        const long long t0 = stats && tid == 0 ? now_ns() : 0;
        const int a = s.resume();
        if (tid == 0) {
          b->action = a;
          b->bp = s.bp;
          b->op = s.op;
          b->nbits = s.nbits;
          b->base = s.base;
          b->cap = s.cap;
          b->mode = s.mode;
          b->last = s.last;
          b->no_par = 0;
          b->reach = 0;
          b->gen = s.gen;
          b->copy_src = s.bp >> 3;
          b->copy_dst = s.op - s.base;
          b->copy_len = s.pending;
          if (stats) {
            stats[S_NS_HEAD] += now_ns() - t0;
            if (a == A_COPY) stats[S_COPIES]++;
          }
        }
      }
      block_sync();
      const int a = b->action;
      if (a == A_STOP) break;
      bool taken = false;  // the head parsed the next header during the expansion
      if (a == A_COPY) {
        const uint8_t* src = in + b->copy_src;
        uint8_t* dst = out + b->copy_dst;
        for (long long j = tid; j < b->copy_len; j += nthr) dst[j] = src[j];
      } else {
        taken = body(b, &s, (const uint32_t*)in, in_words, (const uint16_t*)(tables + kLensOff),
                     out, ptrs, stats, L, T, tid, nthr);
      }
      block_sync();
      if (head && a == A_BODY && !taken) {
        s.bp = b->bp;
        s.op = b->op;
        s.mode = b->mode;
        s.no_par = b->no_par != 0;
      }
    }
  }
  if (head) {
    warp_sync();
    s.store();
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
istream_advance(long long* __restrict__ rec, uint32_t* __restrict__ tables,
                const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  __shared__ Scratch sc;
  run(rec, tables, in, out, &sc, threadIdx.x, 32);
}

__global__ void __launch_bounds__(kThreads)
istream_sync(long long* __restrict__ rec, uint32_t* __restrict__ tables, const uint8_t* in,
             long long in_words, uint8_t* out, int32_t* ptrs, long long* stats) {
  __shared__ Scratch sc;
  extern __shared__ __align__(16) unsigned char body_smem[];
  run_sync(rec, tables, in, in_words, out, ptrs, stats, 0, kThreads, (Body*)body_smem, &sc,
           threadIdx.x, kThreads);
}
#endif

}  // namespace

// uint32 words of a handle's tables; the record's length in int64; the
// block's pointer scratch in int32 and its stats in int64
extern "C" long long zrs_istream_table_words() { return kTableWords; }
extern "C" long long zrs_istream_record_len() { return kRec; }
extern "C" long long zrs_istream_scratch_words() { return kPtrCap; }
extern "C" long long zrs_istream_stats_len() { return kStats; }

#ifdef __CUDACC__
// IS on one handle, one warp: rec int64 [kRec], tables uint32
// [kTableWords], the input buffer (its capacity a multiple of 4, 8 zero
// bytes past R_IN_END) and the output buffer (R_OUT_CAP bytes from
// absolute R_BASE)
extern "C" int zrs_istream_advance(void* rec, void* tables, const void* in, void* out,
                                   void* stream) {
  istream_advance<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)rec, (uint32_t*)tables, (const uint8_t*)in, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// IS on one handle, one block: the same state, the input buffer's words
// (16-byte aligned), the pointer scratch int32 [kPtrCap] and stats int64
// [kStats] or null
extern "C" int zrs_istream_sync(void* rec, void* tables, const void* in, long long in_words,
                                void* out, void* ptrs, void* stats, void* stream) {
  // the attribute is the device's, not the process's: set once a device
  static bool attr[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr[dev]) {
    e = cudaFuncSetAttribute(istream_sync, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Body));
    if (e != cudaSuccess) return (int)e;
    attr[dev] = true;
  }
  istream_sync<<<1, kThreads, sizeof(Body), (cudaStream_t)stream>>>(
      (long long*)rec, (uint32_t*)tables, (const uint8_t*)in, in_words, (uint8_t*)out,
      (int32_t*)ptrs, (long long*)stats);
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

// the block's launch on the host, its T threads in turn, sub-ranges of L
// bits (0: the card's adaptive L)
extern "C" int zrs_istream_sync_host(void* rec, void* tables, const void* in, long long in_words,
                                     void* out, void* ptrs, void* stats, int L, int T) {
  static Scratch sc;
  static Body b;
  if (T < 1 || T > kThreads || L < 0 || L > kStageWords * 8) return 1;
  run_sync((long long*)rec, (uint32_t*)tables, (const uint8_t*)in, in_words, (uint8_t*)out,
           (int32_t*)ptrs, (long long*)stats, L, T, &b, &sc, 0, 1);
  return 0;
}
#endif
