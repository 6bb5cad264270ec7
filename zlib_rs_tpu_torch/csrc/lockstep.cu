// The lockstep region engine: a DEFLATE state machine a lane, one block a
// lane, its whole run in one launch.
//
// Replaces no pallas_call: the reference's engine is XLA code,
// zlib_rs_tpu/parallel/device_inflate.py:decode_regions (a lax.while_loop
// over all lanes, one small step of each lane's state machine an
// iteration). Its torch port, device_inflate.decode_regions_plain, is this
// kernel's plain version; the outputs are the same element for element on
// every input, corrupt ones included.
//
// Outputs per lane: a token tape (kind uint8, a and b int32, one column a
// step), produced, bad, and the lane's own step count. A lane that is done
// or bad never changes again and every later column of the reference's
// tape is a null token, so the reference's n_steps (it loops while some
// lane runs) is the largest of the lanes' counts, and each lane can run to
// its own end with no step shared with another lane. The wrapper zeroes
// the tapes and reads the counts once, at the end.
//
// Bound on the H100. The bytes are the compressed rows in and the tapes
// out, microseconds at 3.35 TB/s. It is not the floor: a step's position
// depends on the code lengths the step before read, so each lane is one
// serial chain of about two table reads (the literal/length entry, then
// the distance entry) and a few loads of the row, a few hundred cycles a
// step from the L1 and L2 caches.
//
// Design.
// - Thread 0 of the block walks the state machine with the state in
//   registers, each step running the reference's sections in its order
//   (input exhausted, header, stored, table meta, code-length-code
//   lengths, code-length table build, code-length symbols, main table
//   build, symbols, region end), so that a lane crosses phases inside one
//   step as the reference's does. It reads the row a byte at a time,
//   8 bytes at the step's position (57 bits after the sub-byte shift, more
//   than the 48 a symbol step reads), zeros past the row.
// - When a lane enters a table build, thread 0 stops and the whole block
//   builds the table: the 2^7-entry code-length table in shared memory,
//   the 2^15-entry literal/length and distance tables in a global scratch
//   of the lane (256 KiB a lane, read back through the L1 and L2 caches).
//   Each entry is the reference's (_build_flat_lut): key k takes the
//   symbol with the largest (interval start, symbol index) at or below
//   rev(k), the first in that order when none is; its kind is
//   KIND_INVALID unless rev(k) lies inside the symbol's interval and some
//   length is nonzero, its other fields the symbol's. So over-subscribed
//   and incomplete codes resolve as in the reference. A build ranks the
//   symbols by (start, index) in shared memory, then a thread takes keys
//   in turn and finds each one's symbol by binary search over the ranked
//   starts. A fixed block after a fixed block keeps its tables.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kFlatBits = 15;
constexpr int kClBits = 7;
constexpr int kLut = 1 << kFlatBits;
constexpr int kSyms = 320;  // a lane's lengths: literal/length then distance

enum Phase {
  PH_HEADER = 0, PH_STORED, PH_TABLE_META, PH_CL_LENS, PH_CL_BUILD, PH_CLEN, PH_BUILD,
  PH_SYMS, PH_DONE, PH_BAD
};
enum Kind { KIND_LIT = 0, KIND_MATCH = 1, KIND_EOB = 2, KIND_INVALID = 4 };
enum Tok { TOK_NULL = 0, TOK_LIT = 1, TOK_MATCH = 2, TOK_RAW = 3 };
enum Alphabet { ALPHA_CL = 0, ALPHA_LL = 1, ALPHA_D = 2 };
// what thread 0 asks of the block
enum Cmd { CMD_END = 0, CMD_BUILD_CL, CMD_BUILD_MAIN };
// where a step resumes after a build
enum Sec { SEC_START = 0, SEC_CLEN, SEC_SYMS };

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
__constant__ int kLBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                               33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                               1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
__constant__ int kDExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct Lane {
  long long bitpos, produced;
  int phase, final_f, hlit, hdist, hclen, cl_got, lens_have, prev_len;
  int step, sec, col_kind, col_a, col_b, tables_fixed;
};

// the shared state of a block: thread 0's hand-off to the builds
struct Shared {
  int cl_lens[19];
  int lens[kSyms];
  uint32_t cl_lut[1 << kClBits];
  // a build's scratch
  int blen[kSyms];
  int start[kSyms];
  int end[kSyms];
  uint32_t entry[kSyms];  // the symbol's entry with its own kind
  int sorted_start[kSyms];
  int sorted_sym[kSyms];
  int count[16];
  int first[16];
  int cmd;
  int hlit, hdist, fixed;
};

// 64 bits of the row from bit `pos` (57 of them whole), zeros past the row
__device__ __forceinline__ uint64_t fetch(const uint8_t* row, long long L, long long pos) {
  long long byte = pos >> 3;
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    long long i = byte + k;
    uint64_t b = (i < L) ? row[i] : 0;
    w |= b << (8 * k);
  }
  return w >> (pos & 7);
}

// (kind, aux, payload) of symbol s of an alphabet, packed as an entry of
// length `len`
__device__ __forceinline__ uint32_t sym_entry(int alphabet, int s, int len) {
  int kind = KIND_LIT, aux = 0, payload = s;
  if (alphabet == ALPHA_LL) {
    if (s == 256) {
      kind = KIND_EOB;
      payload = 0;
    } else if (s >= 257 && s < 286) {
      kind = KIND_MATCH;
      aux = kLExtra[s - 257];
      payload = kLBase[s - 257];
    } else if (s >= 286) {
      kind = KIND_INVALID;
      payload = 0;
    }
  } else if (alphabet == ALPHA_D) {
    if (s < 30) {
      kind = KIND_MATCH;
      aux = kDExtra[s];
      payload = kDBase[s];
    } else {
      kind = KIND_INVALID;
      payload = 0;
    }
  }
  return ((uint32_t)kind << 28) | ((uint32_t)aux << 22) | ((uint32_t)len << 16) | (uint32_t)payload;
}

// The flat table of an alphabet from sh.blen[0, n), by the whole block:
// out[k] for every key k < 2^nbits. Starts with a barrier and ends with one.
__device__ void build_table(Shared& sh, int n, int nbits, int alphabet, uint32_t* out) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < 16) {
    int c = 0;
    for (int s = 0; s < n; ++s) c += sh.blen[s] == tid;
    sh.count[tid] = c;
  }
  __syncthreads();
  if (tid == 0) {
    // canonical first code of each length: lengths 0 and 1 start at 0
    int code = 0;
    sh.first[0] = sh.first[1] = 0;
    for (int l = 2; l < 16; ++l) {
      code = (code + sh.count[l - 1]) << 1;
      sh.first[l] = code;
    }
  }
  __syncthreads();
  const int sentinel = 1 << nbits;
  for (int s = tid; s < n; s += blockDim.x) {
    int len = sh.blen[s];
    int rank = 0;
    for (int j = 0; j < s; ++j) rank += sh.blen[j] == len;
    int st = sentinel, span = 0;
    if (len > 0) {
      st = (sh.first[len] + rank) << (nbits - len);
      span = 1 << (nbits - len);
    }
    sh.start[s] = st;
    sh.end[s] = st + span;
    sh.entry[s] = sym_entry(alphabet, s, len);
  }
  __syncthreads();
  for (int s = tid; s < n; s += blockDim.x) {
    int st = sh.start[s];
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      int sj = sh.start[j];
      pos += (sj < st) || (sj == st && j < s);
    }
    sh.sorted_start[pos] = st;
    sh.sorted_sym[pos] = s;
  }
  __syncthreads();
  bool any_valid = false;
  for (int l = 1; l < 16; ++l) any_valid |= sh.count[l] > 0;
  const int nkeys = 1 << nbits;
  for (int k = tid; k < nkeys; k += blockDim.x) {
    int m = (int)(__brev((unsigned)k) >> (32 - nbits));
    // the number of ranked starts at or below m
    int lo = 0, hi = n;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (sh.sorted_start[mid] <= m) lo = mid + 1;
      else hi = mid;
    }
    int s = sh.sorted_sym[lo > 0 ? lo - 1 : 0];
    uint32_t e = sh.entry[s];
    if (!(any_valid && m < sh.end[s])) e = (e & 0x0FFFFFFFu) | ((uint32_t)KIND_INVALID << 28);
    out[k] = e;
  }
  __syncthreads();
}

// Thread 0: run the lane's steps until it ends or needs a table build.
// Returns the command for the block.
__device__ int advance(Lane& st, Shared& sh, const uint8_t* row, long long L, long long end,
                       long long target, int max_steps, const uint32_t* ll, const uint32_t* dl,
                       uint8_t* tk, int32_t* ta, int32_t* tb) {
  Lane s = st;
  int cmd = CMD_END;
  for (;;) {
    if (s.sec == SEC_START) {
      if (s.step >= max_steps || s.phase >= PH_DONE) break;
      s.col_kind = TOK_NULL;
      s.col_a = 0;
      s.col_b = 0;
      // input exhausted: done if the lane reached its target, else bad
      if (s.bitpos > end) s.phase = s.produced >= target ? PH_DONE : PH_BAD;
      if (s.phase == PH_HEADER) {
        uint64_t w = fetch(row, L, s.bitpos);
        int btype = (int)((w >> 1) & 3);
        s.final_f = (int)(w & 1);
        s.bitpos += 3;
        if (btype == 1) s.hclen = -1;  // a fixed block
        s.phase = btype == 0 ? PH_STORED
                  : btype == 1 ? PH_BUILD
                  : btype == 2 ? PH_TABLE_META
                               : PH_BAD;
      }
      if (s.phase == PH_STORED) {
        long long aligned = (s.bitpos + 7) & ~7LL;
        uint64_t v = fetch(row, L, aligned);
        int st_len = (int)(v & 0xFFFF);
        int st_nlen = (int)((v >> 16) & 0xFFFF);
        if (st_len == (~st_nlen & 0xFFFF)) {
          if (st_len > 0) s.col_kind = TOK_RAW;
          s.col_a = st_len;
          s.col_b = (int)((aligned + 32) >> 3);
          s.produced += st_len;
          s.bitpos = aligned + 32 + 8LL * st_len;
          s.phase = (s.final_f == 1 || s.produced >= target) ? PH_DONE : PH_HEADER;
        } else {
          s.phase = PH_BAD;
        }
      }
      if (s.phase == PH_TABLE_META) {
        uint64_t m = fetch(row, L, s.bitpos);
        s.hlit = (int)(m & 31) + 257;
        s.hdist = (int)((m >> 5) & 31) + 1;
        s.hclen = (int)((m >> 10) & 15) + 4;
        s.cl_got = 0;
        for (int j = 0; j < 19; ++j) sh.cl_lens[j] = 0;
        for (int j = 0; j < kSyms; ++j) sh.lens[j] = 0;
        s.lens_have = 0;
        s.bitpos += 14;
        s.phase = s.hlit > 286 ? PH_BAD : PH_CL_LENS;
      }
      if (s.phase == PH_CL_LENS) {
        int v3 = (int)(fetch(row, L, s.bitpos) & 7);
        int slot = kClOrder[min(max(s.cl_got, 0), 18)];
        sh.cl_lens[slot] += v3;
        s.bitpos += 3;
        s.cl_got += 1;
        if (s.cl_got >= s.hclen) s.phase = PH_CL_BUILD;
      }
      s.sec = SEC_CLEN;
      if (s.phase == PH_CL_BUILD) {
        cmd = CMD_BUILD_CL;
        break;
      }
    }
    if (s.sec == SEC_CLEN) {
      if (s.phase == PH_CL_BUILD) s.phase = PH_CLEN;  // the block built the table
      if (s.phase == PH_CLEN) {
        uint64_t w = fetch(row, L, s.bitpos);
        uint32_t ce = sh.cl_lut[w & ((1 << kClBits) - 1)];
        int ckind = (int)(ce >> 28);
        int cnb = (int)((ce >> 16) & 0x3F);
        int csym = (int)(ce & 0xFFFF);
        int rep_bits = csym == 16 ? 2 : csym == 17 ? 3 : csym == 18 ? 7 : 0;
        int rep_extra = (int)((w >> cnb) & ((1u << rep_bits) - 1));
        int rep_n = (csym == 16 || csym == 17) ? 3 + rep_extra : csym == 18 ? 11 + rep_extra : 1;
        int rep_val = csym < 16 ? csym : csym == 16 ? s.prev_len : 0;
        bool c_bad = ckind == KIND_INVALID || (csym == 16 && s.lens_have == 0) ||
                     (s.lens_have + rep_n > s.hlit + s.hdist);
        if (c_bad) {
          s.phase = PH_BAD;
        } else {
          for (int j = s.lens_have; j < s.lens_have + rep_n && j < kSyms; ++j) sh.lens[j] = rep_val;
          s.lens_have += rep_n;
          s.prev_len = rep_val;
          s.bitpos += cnb + rep_bits;
          if (s.lens_have >= s.hlit + s.hdist) s.phase = sh.lens[256] == 0 ? PH_BAD : PH_BUILD;
        }
      }
      s.sec = SEC_SYMS;
      if (s.phase == PH_BUILD) {
        bool fixed = s.hclen == -1;
        if (!(fixed && s.tables_fixed)) {
          s.tables_fixed = fixed;
          sh.hlit = s.hlit;
          sh.hdist = s.hdist;
          sh.fixed = fixed;
          cmd = CMD_BUILD_MAIN;
          break;
        }
      }
    }
    // SEC_SYMS
    if (s.phase == PH_BUILD) s.phase = PH_SYMS;  // the tables are built
    if (s.phase == PH_SYMS) {
      uint64_t w = fetch(row, L, s.bitpos);
      uint32_t e = ll[w & (kLut - 1)];
      int kind = (int)(e >> 28);
      int aux = (int)((e >> 22) & 0x3F);
      int nb = (int)((e >> 16) & 0x3F);
      int payload = (int)(e & 0xFFFF);
      if (kind == KIND_LIT) {
        s.col_kind = TOK_LIT;
        s.col_a = 1;
        s.col_b = payload;
        s.produced += 1;
        s.bitpos += nb;
        if (s.produced >= target) s.phase = PH_DONE;
      } else if (kind == KIND_EOB) {
        s.bitpos += nb;
        s.phase = s.final_f == 1 ? PH_DONE : PH_HEADER;
      } else if (kind == KIND_MATCH) {
        int length = payload + (int)((w >> nb) & ((1u << aux) - 1));
        int p2 = nb + aux;
        uint32_t de = dl[(w >> p2) & (kLut - 1)];
        int daux = (int)((de >> 22) & 0x3F);
        int dnb = (int)((de >> 16) & 0x3F);
        int dist = (int)(de & 0xFFFF) + (int)((w >> (p2 + dnb)) & ((1u << daux) - 1));
        s.col_a = length;
        s.col_b = dist;
        if ((int)(de >> 28) != KIND_MATCH) {
          s.phase = PH_BAD;
        } else {
          s.col_kind = TOK_MATCH;
          s.produced += length;
          s.bitpos += p2 + dnb + daux;
          if (s.produced >= target) s.phase = PH_DONE;
        }
      } else {
        s.phase = PH_BAD;  // KIND_INVALID
      }
    }
    // region end: a non-final body ends when its bits run out exactly at a
    // block boundary
    if (s.phase == PH_HEADER && s.bitpos + 3 > end && s.produced >= target) s.phase = PH_DONE;
    tk[s.step] = (uint8_t)s.col_kind;
    ta[s.step] = s.col_a;
    tb[s.step] = s.col_b;
    s.step += 1;
    s.sec = SEC_START;
  }
  st = s;
  return cmd;
}

__global__ void __launch_bounds__(kThreads)
lockstep_regions(const uint8_t* __restrict__ comp, long long L, const int32_t* __restrict__ start_bits,
                 const int32_t* __restrict__ end_bits, const int32_t* __restrict__ targets,
                 int max_steps, uint32_t* __restrict__ scratch, uint8_t* __restrict__ tok_kind,
                 int32_t* __restrict__ tok_a, int32_t* __restrict__ tok_b,
                 int32_t* __restrict__ produced, uint8_t* __restrict__ bad,
                 int32_t* __restrict__ counts) {
  __shared__ Shared sh;
  const int lane = blockIdx.x;
  const uint8_t* row = comp + (long long)lane * L;
  uint32_t* ll = scratch + (long long)lane * 2 * kLut;
  uint32_t* dl = ll + kLut;
  uint8_t* tk = tok_kind + (long long)lane * max_steps;
  int32_t* ta = tok_a + (long long)lane * max_steps;
  int32_t* tb = tok_b + (long long)lane * max_steps;
  const long long end = end_bits[lane];
  const long long target = targets[lane];

  Lane s = {};
  s.bitpos = start_bits[lane];
  s.phase = PH_HEADER;
  s.sec = SEC_START;
  for (;;) {
    if (threadIdx.x == 0) sh.cmd = advance(s, sh, row, L, end, target, max_steps, ll, dl, tk, ta, tb);
    __syncthreads();
    const int cmd = sh.cmd;
    if (cmd == CMD_END) break;
    if (cmd == CMD_BUILD_CL) {
      for (int j = threadIdx.x; j < 19; j += blockDim.x) sh.blen[j] = sh.cl_lens[j];
      build_table(sh, 19, kClBits, ALPHA_CL, sh.cl_lut);
    } else {
      const int hlit = sh.hlit, hdist = sh.hdist, fixed = sh.fixed;
      for (int j = threadIdx.x; j < kSyms; j += blockDim.x) {
        int len;
        if (fixed) len = j < 144 ? 8 : j < 256 ? 9 : j < 280 ? 7 : j < 288 ? 8 : 0;
        else len = j < hlit ? sh.lens[j] : 0;
        sh.blen[j] = len;
      }
      build_table(sh, kSyms, kFlatBits, ALPHA_LL, ll);
      for (int j = threadIdx.x; j < kSyms; j += blockDim.x) {
        int len;
        if (fixed) len = j < 32 ? 5 : 0;
        else len = j < hdist ? sh.lens[min(hlit + j, kSyms - 1)] : 0;
        sh.blen[j] = len;
      }
      build_table(sh, kSyms, kFlatBits, ALPHA_D, dl);
    }
  }
  if (threadIdx.x == 0) {
    produced[lane] = (int32_t)s.produced;
    bad[lane] = s.phase == PH_BAD;
    counts[lane] = s.step;
  }
}

}  // namespace

// comp uint8 [B, L] (rows read as zeros past L), start_bits, end_bits and
// targets int32 [B], scratch uint32 [B, 2 * 2^15], tok_kind uint8 [B,
// max_steps], tok_a and tok_b int32 [B, max_steps] (zeroed by the caller),
// produced int32 [B], bad uint8 [B], counts int32 [B]: each lane's steps.
extern "C" int zrs_lockstep(const void* comp, int batch, long long L, const void* start_bits,
                            const void* end_bits, const void* targets, int max_steps,
                            void* scratch, void* tok_kind, void* tok_a, void* tok_b,
                            void* produced, void* bad, void* counts, void* stream) {
  if (batch > 0) {
    lockstep_regions<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, L, (const int32_t*)start_bits, (const int32_t*)end_bits,
        (const int32_t*)targets, max_steps, (uint32_t*)scratch, (uint8_t*)tok_kind,
        (int32_t*)tok_a, (int32_t*)tok_b, (int32_t*)produced, (uint8_t*)bad, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
