// EX: zlib-exact deflate of independent chunks, one warp a chunk; and DS,
// the same Deflater paused and resumed as a resumable stream.
//
// Replaces no pallas_call site. It is the card's counterpart of the encode
// half of the reference's native engine (zlib_rs_tpu/native.py
// deflate_chunk and deflate_parallel over native/zrs_native.cpp): the
// ChunkDeflater of zrs_native.cpp:489-1373, run() with its scan loops
// run_fast (levels 1-3), run_slow (4-9), run_medium (MEDIUM 11-13) and
// run_quick (QUICK 10), longest/longest4, flush_block with zlib's exact
// tree build (TreeBuild), the stored schedule of level 0 and the sync seam
// of a chunk that is not final. The output of a chunk is the bytes native's
// deflate_chunk(chunk, level, final, window) returns, which for levels 1-9
// are stdlib zlib's raw deflate of the chunk primed with the window.
// ops/kernels/exact_deflate_kernel.py holds the plain version (the port's
// host engines) and the wrapper.
//
// Bound on the H100, level 0 and QUICK. The bytes are the input
// and window read once and the output written once: microseconds for
// megabytes at 3.35 TB/s. It is not the floor. Each chunk is one serial
// chain of decisions (a position's match decides where the next one
// starts, and the hash chains it walks were written by the positions
// before it), so the floor is the longest chunk's positions times the
// latency of a hash insert, a chain walk of dependent loads and a compare.
// Levels 1-9 and MEDIUM move the inserts and the walks off that chain
// (below); their floor is the chase's one step a loop top and flush_block.
//
// Levels 4-9 (zlib's deflate_slow) in three parts.
// - Static chains. deflate_slow inserts every position once and in
//   increasing order, whatever the parse decides (the loop top, then every
//   interior of an emitted match), and the hash depends only on the 3 bytes
//   at the position. So the chain at every position is fixed by the data
//   before the parse runs: build_chains writes each position's delta to the
//   last earlier position with its hash, capped at 0xffff, which is the
//   prevd value zlib's insert writes (position 0 and a head of 0 are NIL),
//   held by absolute position and not in a 32 KiB ring. A block takes a
//   tile of kTile positions: the last occurrences in the kLookback
//   positions before it (an older one lies past the cap) by shared-memory
//   atomics, 4 positions a thread; then the tile kSort positions at a time
//   (tile_pass): their (hash, position) keys sorted in shared memory and a
//   max-scan over them give each position the last one before it with its
//   hash, and each hash's last one goes into the table for the next. EX's
//   chains start at the window's position 0; DS's at the pump's first
//   insert, those before it read from the handle's head and prevd.
// - The resolve (resolve_walk), a thread a position over the whole card.
//   longest(pos, cur, prev_len) depends on the parse only through prev_len:
//   the walk's best starts at prev_len < lazy <= nice, so it returns
//   max(prev_len, M), M the longest length among the candidates up to the
//   first that reaches nice (the distance of the first with length M; the
//   anchored pre-reject passes over only candidates that cannot beat the
//   running best), and the budget is quartered when prev_len >= good. So
//   two results a position decide every parse: (M, dist) after chain >> 2
//   and after chain candidates, one walk with a snapshot, each packed in 32
//   bits (length << 15 | distance). nice is clamped by total - pos and the
//   zero-extended compare applies near the end of the data, as in longest.
//   K8's warp group (a warp a position, 32 candidates a step reached
//   through pointer-jumping tables) gave the same slots and was slower at
//   every level 4-9 on the H100 (PERF.md keeps its times), so a thread a
//   position is the one mapping.
// - The chase: run_slow on one warp, its inserts no-ops and longest a
//   lookup of the position's slot (the quartered one when prev_len >= good),
//   min(max(prev_len, M), total - pos), its distance taken when M passes
//   prev_len. Where prev_len >= total - pos (nice clamped below prev_len, at
//   the end of the data) the chase walks the static chains itself. The warp
//   stages the slots kStage at a time through shared memory, one stage
//   ahead with cp.async. Every other line keeps its place: the carry state,
//   TOO_FAR, the emission, flush_block at SYM_END, the trailing literal,
//   the seam, DS's record and its limit contract. The loop's state stays
//   in registers; flush_block counts a block's symbols by shared-memory
//   atomics and emits them 32 at a time across the warp (a scan of their
//   bit lengths); the chases ask for the largest L1, which holds the Work.
//
// Levels 1-3 (zlib's deflate_fast), speculative. longest is always called
// with prev_len = MIN_MATCH - 1 < good, so a position's walk depends on
// the parse only through which earlier positions were inserted: the parse
// leaves out the interior of a match longer than lazy (zlib's
// max_insert_length) and every interior of a match ending within
// MIN_MATCH of total. Call that set, a bit a position, the skip map T.
// - The resolve under an assumed map S (a round): build_chains leaves S's
//   positions out of the chains (each position still gets its delta to the
//   last one left in before it), then resolve_greedy walks every
//   position's chain (a thread a position) and keeps the result and the
//   walk's reach (the lowest position of its hash whose bit the result
//   depends on). If S agrees with T on every position of p's hash from the
//   reach up to p, the walk is zlib's: the chain less S's positions is
//   then the chain zlib's inserts built (T's bits below a position are
//   final when the parse reaches it, by induction on the parse).
// - Rounds: the first assumes what the map holds (none skipped at a
//   chunk's start); a dry parse (dry_piece, a warp a piece) follows a
//   round's slots unchecked and writes the next round's S; the wrapper's
//   ROUNDS rounds (by level).
// - The checked chase (run_greedy, one warp): run_fast with no insert,
//   reading the slots. It keeps T as it emits (mark: a long or near-end
//   match's interior set, the rest clear, overwriting S, at most 10 words
//   across the warp) and, for each hash, its positions where S and T
//   differ, newest first (ldh, a position a hash, and a list in `dlist`).
//   EX's ldh lies in the chunk's Work head (128 KB of shared memory a block
//   would hold each SM to one chase), DS's in shared memory (its Work head
//   is the handle's). A slot stands when its reach lies above its hash's
//   newest disagreement; else zlib's walk runs live over S's chains,
//   corrected by the list (true_prev). So the bytes are zlib's whatever S is: S decides
//   only how many walks run live.
// - DS: a pump's map starts at its first insert; after the chase
//   build_chains runs again leaving T's positions out, so that ds_tables
//   leaves head and prevd as zlib's serial inserts do (a skipped
//   position's ring slot keeps its value; a flushing pump's near-end
//   interiors stay out, for the next pump's walks).
// MEDIUM4-6 (levels 11-13, native's run_medium on its one-deeper knob
// rows), the same way over 4-byte-hash chains. med_insert_match inserts a
// match's interior up to 16 x lazy (all of it at MEDIUM6), only the
// position before a 257-258 match's end at MEDIUM4/5, nothing of a match
// ending within its length + 4 of total; the loop top and the lookahead's
// next match start are inserted; native never hashes the dictionary's last
// three positions. The inserts go in increasing order and never twice (the
// orgstart rule keeps a fizzled next match's insert past the lookahead's),
// so every position is inserted or passed over once: the map is the
// positions passed over.
// - The resolve: build_chains keys by hash4 (16 bits: two passes over the
//   tile, a half of the hash space each, so that the table stays 128 KB),
//   a thread a position runs longest4 (greedy_walk from WANT_MIN - 1 on the
//   klevel row) and keeps its reach. A piece's slots run MAX_MATCH past
//   its end (slot_end): the lookahead walks the next match's start.
// - The chase (run_medium_slots, one warp) is run_medium with each walk a
//   slot checked as at 1-3 (ldh by the hash folded to 15 bits; the live
//   walk passes over the other hash's disagreements), the inserts decided
//   into the map from a frontier (the first position not yet decided, in
//   the record between pieces and pumps), the fizzle's byte compares, the
//   emit and flush_block serial. Where the map holds no skipped position
//   past the frontier (the first round's), only the positions passed over
//   are marked. MEDIUM6 takes one round; MEDIUM4/5 a second (a dry parse,
//   dry_medium: the chase with every slot taken and no output) where the
//   first round's slots hold many 257-258 matches (the wrapper's
//   take_round; the host build takes its rounds as given).
// - DS: a pump's chains start at the last pump's frontier, from the
//   handle's head4 and prevd4, and ds_tables leaves those as the serial
//   inserts do. A FULL_FLUSH leaves head4 stale, as native does (the new
//   window restarts at 0): a stale head can put a position of another hash,
//   or one never inserted, on a chain, where native reads the ring slot
//   another position wrote; the static chains do not model that, so from
//   then on the handle's pumps run native's serial run_medium (D_MED_STALE).
// A chunk larger than a piece (the wrapper's PIECE positions) is resolved
// and chased a piece at a time, its state in a record between launches;
// at 1-3 and MEDIUM its map in device memory across the pieces (a bit a
// position), since a match can cross a piece's end.
// After a DS pump ds_tables leaves the handle's head and prevd as the
// serial inserts would have: the last inserted position of each hash
// (atomicMax) and each ring slot's last inserted position's delta.
// Bound of the resolve: the bytes (the input read once, 2 bytes of delta
// and 8 of slot a position written once) and the candidate compares the
// walks make on this data; the chase's floor is the positions it visits,
// times one slot read from shared memory and one step of the parse, plus
// flush_block's tree build and emission a block.
//
// Design.
// - One block of one warp a chunk; every chunk of a call is launched at
//   once (a grid of `slots` blocks, each looping over the chunks
//   k = blockIdx.x, blockIdx.x + slots, ...). Every lane runs native's
//   control flow on the same values, with native's state in registers:
//   a store to the scratch is made by every lane with the same value, so
//   that each lane later reads its own store, and the warp stays converged
//   (uniform branches, a __syncwarp at the top of every scan step).
// - The match length of a candidate is the warp's: 8 bytes a lane, a
//   ballot of the lanes that differ, the first mismatch from the first
//   such lane's XOR (native's match_len_fast over 258 bytes); the
//   zero-extended compare near the end of the data (native's match_len_z)
//   the same over bytes read as 0 past the chunk, so that no byte of the
//   next chunk or past the buffer is read. The pre-reject (two 16-bit
//   loads) and the chain walk stay serial, so the candidate order and the
//   best_len updates are native's (QUICK, MEDIUM; the resolve's thread
//   compares 4 bytes a step).
// - A chunk's scratch is a slot in device memory: head int32[32768],
//   prevd u16[32768], the symbol buffer of 16,384 x 4 bytes and the tree
//   build's heap and code arrays (kWorkBytes); QUICK (and a DS handle at
//   MEDIUM) add head4 int32[65536] and prevd4 u16[32768] (kWork4Bytes).
//   The warp zeroes the hash and chain tables at the start of a chunk, as
//   native's vectors start (levels 1-9 and MEDIUM leave them unused: their
//   chains are static; EX's chase at 1-3 and MEDIUM keeps its ldh in head).
// - Output goes straight into the chunk's slot of room `cap`: a 64-bit
//   word by lanes 0-7 a byte each, a stored span by all lanes. A byte past
//   `cap` is dropped and the length still counts it; a length past `cap`
//   is native's overflow (-1). QUICK's rewind to stored rewrites bytes
//   already written, after a __syncwarp.
// - RFC 1951's tables, the static trees and zlib's LEVELS rows are built
//   on the host once and live in __constant__ memory (every lane reads the
//   same entry, so each read is a broadcast).
// - Without __CUDACC__ the same source compiles as host C++ (a warp of one
//   lane, serial compares, zrs_exact_deflate_host and zrs_dstream_pump_host;
//   at levels 1-9 and MEDIUM the resolve's serial loops, at 1-3 and MEDIUM
//   its rounds and dry parses, then the chase), so that the CPU tests run
//   this file's control flow against native and zlib.
//
// DS (zrs_dstream_pump) is the card's counterpart of native's resumable
// deflate (zlib_rs_tpu/native.py RawDeflateStream over DefStream::pump,
// zrs_native.cpp:2107), the raw-body engine under the port's stream
// objects and gzip files (models/faststream.py): one block of one warp a
// handle and a pump. The Deflater's scalar state (spos, block_start, ns,
// the lazy match's carry, sh/shv, started, BitW's partial word, zlib's
// `insert`, MEDIUM's pre-found next match) is restored from the handle's
// record before the pump and saved after it; the handle's Work (hash
// chains, the block's symbols; MEDIUM4-6 add Work4's head4 and prevd4) and
// its data (the window and the unflushed block, then the pump's input)
// stay in device memory. The scan loops (run_greedy, run_slow, run_medium)
// (and run_medium_slots) take `limit`, as native's do: total -
// (MIN_LOOKAHEAD - 1) under NO_FLUSH, so that no decision depends on how
// much input has arrived, and total under a flush (a chunk passes total,
// so its bytes do not change); the scan starts once (start_scan). A flush
// then runs native's tail: the trailing literal (not at MEDIUM), flush_block, the sync
// seam, FULL_FLUSH's hash clear and window restart, FINISH's last block
// and alignment, and the retroactive insert of the <= 2 tail positions at
// the next pump. The wrapper (ops/kernels/dstream_kernel.py) sizes the
// pump's room from the unflushed bytes, raises when a pump passed it, and
// prunes the data after a pump as native does (by multiples of WSIZE,
// the hash heads, head4 and MEDIUM's next match and frontier rebased). At
// levels 1-9 and MEDIUM a pump is a resolve of its positions [spos, limit)
// over chains from its first insert (the retroactive ones included; at 1-3
// and MEDIUM its rounds), the chase, at 1-3 and MEDIUM the chains of the
// positions it inserted, and ds_tables;
// at levels 1-9 the wrapper hands input longer than a piece to DS a piece
// at a time (NO_FLUSH but the last, which takes the pump's flush: the same
// bytes, since no decision depends on how much input has arrived), so that
// a pump's deltas and slots cover at most a piece and MIN_LOOKAHEAD.
// MEDIUM's pumps go whole: native's lookahead and its no-insert rule read
// the pump's total.
// Its bound is EX's: the pump's bytes are microseconds; its floor is the
// serial chase of the pump's positions.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define EX_DEV __device__
#define EX_INL __device__ __forceinline__
#define EX_HD __host__ __device__
// the large bodies taken once a block (the block flush, the tree build,
// the stored emit): a call each, not a copy at every call site
#define EX_BIG __device__ __noinline__
#else
#define EX_DEV
#define EX_INL inline
#define EX_HD inline
#define EX_BIG
#endif

namespace {

constexpr int MIN_MATCH = 3, MAX_MATCH = 258, WSIZE = 32768;
constexpr int MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1;  // 262
constexpr int MAX_DIST = WSIZE - MIN_LOOKAHEAD;
constexpr int HASH_SIZE = 1 << 15, HASH_SHIFT = 5;  // memLevel 8
constexpr int TOO_FAR = 4096;
constexpr int L_CODES = 286, D_CODES = 30, BL_CODES = 19;
constexpr int HEAP_SIZE = 2 * L_CODES + 1;
constexpr long long LIT_BUFSIZE = 1 << 14;  // memLevel 8
constexpr long long SYM_END = LIT_BUFSIZE - 1;
constexpr int QUICK_LEVEL = 10, MEDIUM_BASE = 11, WANT_MIN = 4;
constexpr long long QSEG = 49152;
constexpr int REP_3_6 = 16, REPZ_3_10 = 17, REPZ_11_138 = 18;
constexpr int kMeta = 6;  // start, len, dict_len, final, out_off, out_cap
constexpr int kOverflow = -1;
constexpr unsigned kFull = 0xFFFFFFFFu;
#ifdef __CUDACC__
constexpr int kLanes = 32;
#else
constexpr int kLanes = 1;
#endif

// a slot of scratch, in bytes: the exact levels' tables, then QUICK's and
// MEDIUM's (the wrapper's WORK_BYTES and WORK4_BYTES)
constexpr size_t kWorkBytes = 300 * 1024;
constexpr size_t kWork4Bytes = 320 * 1024;

// levels 1-9: the static chains, the resolve and the chase
constexpr int kTile = 16384;            // positions a block of build_chains inserts in order
constexpr int kSort = 4096;             // of which tile_pass sorts at a time
constexpr long long kLookback = 65536;  // positions before a tile whose last occurrences seed it
constexpr int kChainThreads = 1024;  // build_chains: a block a tile, 4 keys a thread a sort
static_assert(kSort % kChainThreads == 0 && kTile % kSort == 0, "tile_pass's shares");
// build_chains' dynamic shared memory: the hash table, then a sort's keys,
// its deltas and a total a warp (tile_pass)
constexpr int kChainSmem = HASH_SIZE * (int)sizeof(int32_t) + kSort * (int)sizeof(uint32_t) +
                           kSort * (int)sizeof(uint16_t) + (kChainThreads / 32) * 4;
constexpr int kWalkThreads = 128;       // resolve_walk: a thread a position
constexpr int kStage = 512;             // slots a stage of the chase's shared ring
constexpr int kTableThreads = 256;
constexpr int kEmitWords = 26;  // 32 symbols of <= 48 bits past a partial word, in 64-bit words

// a piece: one resolve's and one chase's range of a chunk (or of a DS
// pump), int64 a field (the wrapper's P_* names)
enum {
  P_BASE,   // offset in `in` of the piece's position 0 (the window's first byte)
  P_TOTAL,  // the data's positions: the dictionary and the chunk
  P_LO,     // the first position the chains insert (EX 0; DS the pump's first insert)
  P_C0,     // deltas are computed for positions [c0, c1) ...
  P_C1,
  P_DOFF,   // ... at deltas[doff + p - c0]
  P_S,      // slots for positions [s, e) ...
  P_E,
  P_SOFF,   // ... at slots[soff + p - s]
  P_CBLK,   // the piece's first block in build_chains
  P_WBLK,   // and in resolve_walk
  P_CHUNK,  // EX: the chunk's meta row
  P_LAST,   // EX: 1 if the piece ends its chunk
  P_WORK,   // EX: the chunk's Work and record in the call's scratch
  kPiece
};

struct Sym {
  uint16_t dist;  // 0: a literal
  uint16_t lenlit;
};

// a position's resolved walk, (length << 15) | distance, 0 where zlib
// calls no longest there; and `aux`: at levels 4-9 the quartered budget's
// walk, packed the same, at levels 1-3 the walk's reach (how far back from
// the position the positions with its hash lie whose bits it depends on)
struct alignas(8) Slot {
  uint32_t full, aux;
};

struct Work {
  int32_t head[HASH_SIZE];
  uint16_t prevd[WSIZE];  // 16-bit deltas to the previous occurrence, 0 = none
  Sym syms[LIT_BUFSIZE];
  // the tree build (TreeBuild::build)
  uint64_t f[HEAP_SIZE];
  int length[HEAP_SIZE], dad[HEAP_SIZE], depth[HEAP_SIZE], heap[HEAP_SIZE + 1];
  // a block's frequencies and codes; QUICK's smoothed counts in llf/df
  uint32_t llf[L_CODES], df[D_CODES], blf[BL_CODES];
  uint8_t lll[L_CODES], dl[D_CODES], bll[BL_CODES];
  uint16_t llc[L_CODES], dc[D_CODES], blc[BL_CODES];
  uint32_t ltab[256];
  uint8_t ltn[256];
  // QUICK: the previous and the current segment's histograms
  uint32_t llf_prev[L_CODES], df_prev[D_CODES], llf_cur[L_CODES], df_cur[D_CODES];
};

struct Work4 {  // QUICK and MEDIUM: the 4-byte-hash chains
  int32_t head4[1 << 16];
  uint16_t prevd4[WSIZE];
};

static_assert(sizeof(Work) <= kWorkBytes, "Work outgrew its slot");
static_assert(sizeof(Work4) <= kWork4Bytes, "Work4 outgrew its slot");

struct Tables {
  int len_base[29], len_extra[29], dist_base[30], dist_extra[30];
  uint8_t len_code[256];   // (len - 3) -> 0..28
  uint8_t dist_code[512];  // zlib's two-part table
  uint16_t s_llc[288], s_dc[30];
  uint8_t s_lll[288], s_dl[30];
  int good[10], lazy[10], nice[10], chain[10], slow[10];
  int bl_order[19], extra_bl[19];
};

#ifdef __CUDACC__
__constant__ Tables kT;
#else
Tables kT;
#endif

// MEDIUM4-6 (levels 11-13) and the zlib knob row each runs (native's
// klevel: one row deeper, 5-7)
EX_HD bool medium_level(int level) { return level >= MEDIUM_BASE && level <= MEDIUM_BASE + 2; }
EX_HD int knob_level(int level) { return medium_level(level) ? level - MEDIUM_BASE + 5 : level; }
EX_HD bool static_level(int level) { return level >= 1 && level <= 9; }
EX_HD bool greedy_level(int level) { return level >= 1 && level <= 3; }
// the levels whose walks are resolved over the card: 1-9 and MEDIUM
EX_HD bool resolved_level(int level) { return static_level(level) || medium_level(level); }
// the levels resolved under a skip map: 1-3 and MEDIUM
EX_HD bool mapped_level(int level) { return greedy_level(level) || medium_level(level); }

uint32_t host_bit_reverse(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

void host_canonical(const uint8_t* lens, int n, uint16_t* codes) {
  int cnt[16] = {0};
  for (int i = 0; i < n; i++) cnt[lens[i]]++;
  cnt[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + cnt[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; i++)
    codes[i] = lens[i] ? (uint16_t)host_bit_reverse(next[lens[i]]++, lens[i]) : 0;
}

// native's Rfc1951, StaticTrees and LEVELS, on the host
void make_tables(Tables* t) {
  std::memset(t, 0, sizeof(Tables));
  int l = 3, i = 0;
  for (; i < 8; i++) {
    t->len_base[i] = l;
    t->len_extra[i] = 0;
    l += 1;
  }
  for (int e = 1; e <= 5; e++)
    for (int k = 0; k < 4; k++) {
      t->len_base[i] = l;
      t->len_extra[i] = e;
      l += 1 << e;
      i++;
    }
  t->len_base[28] = 258;
  t->len_extra[28] = 0;
  for (int c = 0; c < 28; c++)
    for (int v = t->len_base[c] - 3; v < t->len_base[c + 1] - 3; v++) t->len_code[v] = (uint8_t)c;
  t->len_code[255] = 28;
  for (int c = 0; c < 4; c++) {
    t->dist_base[c] = c + 1;
    t->dist_extra[c] = 0;
  }
  int d = 5;
  i = 4;
  for (int e = 1; e <= 13; e++)
    for (int k = 0; k < 2; k++) {
      t->dist_base[i] = d;
      t->dist_extra[i] = e;
      d += 1 << e;
      i++;
    }
  for (int c = 0; c < 30; c++) {
    const int lo = t->dist_base[c];
    const int hi = c < 29 ? t->dist_base[c + 1] : 32769;
    for (int v = lo; v < hi && v <= 256; v++) t->dist_code[v - 1] = (uint8_t)c;
    for (int v = lo > 257 ? lo : 257; v < hi; v++) t->dist_code[256 + ((v - 1) >> 7)] = (uint8_t)c;
  }
  for (int s = 0; s < 288; s++) t->s_lll[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
  host_canonical(t->s_lll, 288, t->s_llc);
  for (int s = 0; s < 30; s++) t->s_dl[s] = 5;
  host_canonical(t->s_dl, 30, t->s_dc);
  // zlib's configuration_table: levels 1-3 greedy, 4-9 lazy
  const int rows[10][5] = {{0, 0, 0, 0, 0},       {4, 4, 8, 4, 0},       {4, 5, 16, 8, 0},
                           {4, 6, 32, 32, 0},     {4, 4, 16, 16, 1},     {8, 16, 32, 32, 1},
                           {8, 16, 128, 128, 1},  {8, 32, 128, 256, 1},  {32, 128, 258, 1024, 1},
                           {32, 258, 258, 4096, 1}};
  for (int v = 0; v < 10; v++) {
    t->good[v] = rows[v][0];
    t->lazy[v] = rows[v][1];
    t->nice[v] = rows[v][2];
    t->chain[v] = rows[v][3];
    t->slow[v] = rows[v][4];
  }
  const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  for (int s = 0; s < 19; s++) {
    t->bl_order[s] = order[s];
    t->extra_bl[s] = s == 16 ? 2 : s == 17 ? 3 : s == 18 ? 7 : 0;
  }
}

// ---------------------------------------------------------------------------
// warp primitives (a warp of one lane on the host)
// ---------------------------------------------------------------------------

EX_INL void warp_sync() {
#ifdef __CUDACC__
  __syncwarp();
#endif
}

EX_INL uint64_t load8(const uint8_t* p) {
  uint64_t v = 0;
  for (int j = 0; j < 8; j++) v |= (uint64_t)p[j] << (8 * j);
  return v;
}

// byte i of the zero-extended buffer: 0 at or past `total`
EX_INL uint8_t zbyte(const uint8_t* base, long long i, long long total) {
  return i < total ? base[i] : (uint8_t)0;
}

// native match_len_fast(a, b, 258): the first index where a and b differ,
// or 258; every byte in bounds
EX_DEV int match258(const uint8_t* a, const uint8_t* b, int lane) {
#ifdef __CUDACC__
  const uint64_t d = load8(a + 8 * lane) ^ load8(b + 8 * lane);
  const unsigned m = __ballot_sync(kFull, d != 0);
  if (m) {
    const int at = 8 * lane + ((__ffsll((long long)d) - 1) >> 3);
    return __shfl_sync(kFull, at, __ffs(m) - 1);
  }
  if (a[256] != b[256]) return 256;
  return a[257] != b[257] ? 257 : 258;
#else
  (void)lane;
  int l = 0;
  while (l < MAX_MATCH && a[l] == b[l]) l++;
  return l;
#endif
}

// native match_len_z: the same over the buffer zero-extended past `total`
EX_DEV int match258_z(const uint8_t* base, long long p, long long q, long long total, int lane) {
#ifdef __CUDACC__
  uint64_t x = 0, y = 0;
  const long long o = 8 * lane;
  for (int j = 0; j < 8; j++) {
    x |= (uint64_t)zbyte(base, p + o + j, total) << (8 * j);
    y |= (uint64_t)zbyte(base, q + o + j, total) << (8 * j);
  }
  const uint64_t d = x ^ y;
  const unsigned m = __ballot_sync(kFull, d != 0);
  if (m) {
    const int at = (int)o + ((__ffsll((long long)d) - 1) >> 3);
    return __shfl_sync(kFull, at, __ffs(m) - 1);
  }
  for (int l = 256; l < MAX_MATCH; l++)
    if (zbyte(base, p + l, total) != zbyte(base, q + l, total)) return l;
  return MAX_MATCH;
#else
  (void)lane;
  int l = 0;
  while (l < MAX_MATCH && zbyte(base, p + l, total) == zbyte(base, q + l, total)) l++;
  return l;
#endif
}

EX_INL uint16_t load16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

// a byte of the input through the read-only path (the serial scans read
// the input while they store symbols: no ordering with those stores)
EX_INL uint8_t ldb(const uint8_t* p) {
#ifdef __CUDACC__
  return __ldg(p);
#else
  return *p;
#endif
}

EX_INL uint32_t bit_reverse(uint32_t v, int n) {
#ifdef __CUDACC__
  return __brev(v) >> (32 - n);
#else
  return host_bit_reverse(v, n);
#endif
}

EX_INL int clz32(uint32_t v) {  // v != 0
#ifdef __CUDACC__
  return __clz(v);
#else
  return __builtin_clz(v);
#endif
}

EX_INL int ctz32(uint32_t v) {  // v != 0
#ifdef __CUDACC__
  return __ffs(v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// the bits [lo, hi) of a word (0 <= lo, hi <= 32; none where hi <= lo)
EX_INL uint32_t bit_range(int lo, int hi) {
  if (hi <= lo) return 0u;
  return (hi == 32 ? kFull : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

EX_INL int dist_to_code(int dist) {
  const int d = dist - 1;
  return d < 256 ? kT.dist_code[d] : kT.dist_code[256 + (d >> 7)];
}

// ---------------------------------------------------------------------------
// levels 1-9: the static chains and the resolve
// ---------------------------------------------------------------------------

EX_INL uint32_t hash_at(const uint8_t* b, long long p) {
  return (((uint32_t)b[p] << (2 * HASH_SHIFT)) ^ ((uint32_t)b[p + 1] << HASH_SHIFT) ^
          (uint32_t)b[p + 2]) & (uint32_t)(HASH_SIZE - 1);
}

// MEDIUM's 4-byte Knuth hash into 16 bits (native's hash4)
EX_INL uint32_t hash4_at(const uint8_t* b, long long p) {
  const uint32_t v = (uint32_t)b[p] | ((uint32_t)b[p + 1] << 8) | ((uint32_t)b[p + 2] << 16) |
                     ((uint32_t)b[p + 3] << 24);
  return (v * 2654435761u) >> 16;
}

// the end of a piece's slots: its scan's end; at MEDIUM past it by the
// lookahead's reach (a walk at the next match's start, up to MAX_MATCH - 1
// past the last loop top), short of the positions hash4 cannot hash
EX_HD long long slot_end(const long long* pr, bool medium) {
  if (!medium) return pr[P_E];
  long long se = pr[P_E] + MAX_MATCH;
  if (se > pr[P_TOTAL] - (WANT_MIN - 1)) se = pr[P_TOTAL] - (WANT_MIN - 1);
  return se > pr[P_S] ? se : pr[P_S];
}

// a skip map's words for positions [b0, total) (b0 a multiple of 32), one
// spare (the wrapper's bit_words)
EX_HD long long map_words(long long b0, long long total) { return ((total - b0 + 31) >> 5) + 1; }

EX_INL void block_sync() {
#ifdef __CUDACC__
  __syncthreads();
#endif
}

EX_INL void atomic_max_i32(int32_t* a, int32_t v) {
#ifdef __CUDACC__
  atomicMax(a, v);
#else
  if (v > *a) *a = v;
#endif
}

// the chain links a walk reads: a position's delta (prevd's value) from the
// static deltas at and past c0, before it from the handle's prevd ring (DS)
struct Chains {
  const uint16_t* delta;  // position p's at delta[p - c0]
  long long c0;
  const uint16_t* ring;   // null for EX: its walks never pass below c0
  EX_INL long long prev(long long p) const {
    const uint32_t d = p >= c0 ? delta[p - c0] : ring ? ring[p & (WSIZE - 1)] : 0u;
    return d ? p - d : 0;
  }
};

// levels 1-3: the positions a parse leaves out of the chains (the
// interior of a match longer than lazy, every interior of a match ending
// within MIN_MATCH of the data's end), a bit a position from b0 (a multiple
// of 32); positions below b0 are never skipped, and a null map skips none
struct Skip {
  const uint32_t* bits;
  long long b0;
  EX_INL bool on(long long p) const {
    return bits && p >= b0 && ((bits[(p - b0) >> 5] >> ((p - b0) & 31)) & 1u);
  }
};

// 4 bytes from any address of the input
EX_INL uint32_t load32u(const uint8_t* p) {
#ifdef __CUDACC__
  const uintptr_t a = (uintptr_t)p;
  const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(a & 3) * 8;
  const uint32_t lo = __ldg(w);
  return sh ? __funnelshift_r(lo, __ldg(w + 1), sh) : lo;
#else
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
#endif
}

// match258 in one thread: the first index where a and b differ, or 258;
// every byte in bounds
EX_DEV int match_thread(const uint8_t* a, const uint8_t* b) {
  for (int l = 0; l < 256; l += 4) {
    const uint32_t x = load32u(a + l) ^ load32u(b + l);
#ifdef __CUDACC__
    if (x) return l + ((__ffs(x) - 1) >> 3);
#else
    if (x) return l + (__builtin_ctz(x) >> 3);
#endif
  }
  if (a[256] != b[256]) return 256;
  return a[257] != b[257] ? 257 : 258;
}

// match258_z in one thread: over the data zero-extended past `total`
EX_DEV int match_z_thread(const uint8_t* base, long long p, long long q, long long total) {
  int l = 0;
  while (l < MAX_MATCH && zbyte(base, p + l, total) == zbyte(base, q + l, total)) l++;
  return l;
}

EX_INL uint32_t pack_slot(int len, int dist) { return ((uint32_t)len << 15) | (uint32_t)dist; }

// zlib's longest_match over the static chains from the candidate `cur`,
// the best starting at `best`: the result packed after `chain` candidates
// (or at nice, or at the chain's end), and in *q the result after `qchain`
// of them (the quartered budget's walk is this walk's prefix); qchain 0
// takes no snapshot; *visited (if given) the candidates compared. The
// candidate order, the anchored pre-reject, the stops and the updates are
// longest's.
EX_DEV uint32_t walk(const uint8_t* base, long long total, long long pos, long long cur,
                     const Chains& ch, int best, int chain, int qchain, int nice, uint32_t* q,
                     int* visited) {
  const int lookahead = (int)(total - pos);
  if (nice > lookahead) nice = lookahead;
  long long limit = pos - MAX_DIST;
  if (limit < 0) limit = 0;
  const bool inb = pos + MAX_MATCH <= total;
  const uint8_t* here = base + pos;
  uint16_t scan_end = inb ? load16(here + best - 1) : 0;
  const uint16_t scan_start = inb ? load16(here) : 0;
  int bd = 0, n = 0, seen = 0;
  bool snap = false;
  for (;;) {
    seen++;
    int ml = 0;
    if (!inb)
      ml = match_z_thread(base, pos, cur, total);
    else if (load16(base + cur + best - 1) == scan_end && load16(base + cur) == scan_start)
      ml = match_thread(here, base + cur);
    if (ml > best) {
      best = ml;
      bd = (int)(pos - cur);
      if (ml >= nice) break;
      if (inb) scan_end = load16(here + best - 1);
    }
    if (++n == qchain) {
      *q = pack_slot(best, bd);
      snap = true;
    }
    const long long next = ch.prev(cur);
    if (next <= limit || next >= cur) break;
    cur = next;
    if (n == chain) break;
  }
  const uint32_t full = pack_slot(best, bd);
  if (qchain && !snap) *q = full;
  if (visited) *visited = seen;
  return full;
}

// a position's slot: its two walks from its first candidate with the best
// starting at MIN_MATCH - 1, or 0 where run_slow would not call longest
EX_DEV Slot resolve_at(const uint8_t* base, long long total, long long p, const Chains& ch,
                       int level, int* visited) {
  Slot r{0u, 0u};
  *visited = 0;
  if (p + MIN_MATCH > total) return r;
  const long long first = ch.prev(p);
  if (first <= 0 || p - first > MAX_DIST) return r;
  const int chain = kT.chain[level];
  r.full = walk(base, total, p, first, ch, MIN_MATCH - 1, chain, chain >> 2, kT.nice[level],
                &r.aux, visited);
  return r;
}

// zlib's deflate_fast at its loop top p (levels 1-3) under an assumed skip
// map S, over chains `mch` built with S's positions left out (each
// position's delta to the last earlier position with its hash that S
// leaves in): hash_head is the first such predecessor, taken while p -
// hash_head <= MAX_DIST, then longest(p, hash_head, MIN_MATCH - 1) with
// level's chain and nice. Where S agrees with the parse's own map T on
// every position with p's hash from *reach up to p, this is zlib's walk:
// those chains are then the chains zlib's inserts built. *reach is the
// last candidate where the walk stops at nice or at its budget, limit + 1
// where a link leaves the window (every position of the window then
// counts; hash_head may lie at limit itself), p - MAX_DIST where hash_head
// lies outside it. The candidate order, the anchored pre-reject, the stops
// and the updates are longest's; the budget ends after its last compare,
// before a link that could not change the result. Returns the result
// packed, 0 where zlib calls no longest. MEDIUM's walk (native's run_medium
// and longest4, over 4-byte-hash chains) is the same with the best from
// WANT_MIN - 1 (best0) and its klevel's row as `level`.
EX_DEV uint32_t greedy_walk(const uint8_t* base, long long total, long long p, const Chains& mch,
                            int level, int best0, long long* reach, int* visited) {
  long long cur = mch.prev(p);
  *visited = 0;
  if (cur <= 0 || p - cur > MAX_DIST) {
    *reach = p - MAX_DIST > 0 ? p - MAX_DIST : 0;
    return 0;
  }
  const int lookahead = (int)(total - p);
  int nice = kT.nice[level];
  if (nice > lookahead) nice = lookahead;
  long long limit = p - MAX_DIST;
  if (limit < 0) limit = 0;
  const int chain = kT.chain[level];
  const bool inb = p + MAX_MATCH <= total;
  const uint8_t* here = base + p;
  int best = best0, bd = 0, n = 0;
  uint16_t scan_end = inb ? load16(here + best - 1) : 0;
  const uint16_t scan_start = inb ? load16(here) : 0;
  for (;;) {
    int ml = 0;
    if (!inb)
      ml = match_z_thread(base, p, cur, total);
    else if (load16(base + cur + best - 1) == scan_end && load16(base + cur) == scan_start)
      ml = match_thread(here, base + cur);
    if (ml > best) {
      best = ml;
      bd = (int)(p - cur);
      if (ml >= nice) break;
      if (inb) scan_end = load16(here + best - 1);
    }
    if (++n == chain) break;
    const long long next = mch.prev(cur);
    if (next <= limit || next >= cur) {
      if (cur > limit) cur = limit + 1;
      break;
    }
    cur = next;
  }
  *reach = cur;
  *visited = n;
  return pack_slot(best, bd);
}

// a position's slot at levels 1-3 and MEDIUM: its greedy walk under the
// assumed map and its reach back (p - reach, at most MAX_DIST); 0 and 0
// where p + need (MIN_MATCH; MEDIUM's WANT_MIN) passes the data (nothing is
// hashed there). MEDIUM's also holds its hash4 folded to 15 bits in the
// high half, the chase's index into ldh.
EX_DEV Slot resolve_greedy(const uint8_t* base, long long total, long long p, const Chains& mch,
                           int level, int need, int* visited) {
  Slot r{0u, 0u};
  *visited = 0;
  if (p + need > total) return r;
  long long reach;
  r.full = greedy_walk(base, total, p, mch, level, need - 1, &reach, visited);
  r.aux = (uint32_t)(p - reach);
  if (need == WANT_MIN) r.aux |= (hash4_at(base, p) & (HASH_SIZE - 1)) << 16;
  return r;
}

// a hash's positions where the chase found its map T and the assumed map
// S to differ, newest first: ldh holds the newest of each hash, `d` each
// one's distance to the one before it (0: none, or past the window), at
// d[q - c0]
struct Disagree {
  const uint16_t* d;
  long long c0;
  EX_INL long long prev(long long q) const {
    const uint32_t v = d[q - c0];
    return v ? q - v : -1;
  }
};

// the last position before x with p's hash that T leaves in (a value <=
// lim where none lies above lim). `ch` (S's chains) gives m, the last one
// S leaves in; `dc` walks down the hash's disagreements: one above m is
// T's (S left it out, T did not); m itself disagreeing is T's skip, so the
// search goes on below m; else m is T's. At MEDIUM the disagreements are
// listed by the hash folded to 15 bits: those of the other hash (hp >= 0,
// p's hash4) are passed over.
EX_DEV long long true_prev(long long x, long long lim, const Chains& ch, const Disagree& dg,
                           long long& dc, const uint8_t* base, long long hp) {
  for (;;) {
    const long long m = ch.prev(x);
    while (dc >= x || (hp >= 0 && dc >= 0 && (long long)hash4_at(base, dc) != hp))
      dc = dg.prev(dc);
    if (dc > m) return dc;
    if (dc < m || m <= 0 || m <= lim) return m;
    x = m;
  }
}

// zlib's deflate_fast walk at p over the parse's own map T (the chase's
// live walk, every bit below p final), from S's chains and the
// disagreements of p's hash (`dc` the newest below p): longest's stops and
// updates, as in greedy_walk (every lane the same walk: the candidates'
// compares mostly end within a few bytes, where one thread's is the
// cheaper). MEDIUM's (`four`): longest4's, the best from WANT_MIN - 1.
EX_DEV uint32_t live_greedy_walk(const uint8_t* base, long long total, long long p,
                                 const Chains& ch, const Disagree& dg, long long dc, int level,
                                 bool four) {
  long long limit = p - MAX_DIST;
  if (limit < 0) limit = 0;
  const long long hp = four ? (long long)hash4_at(base, p) : -1;
  long long cur = true_prev(p, p - MAX_DIST - 1, ch, dg, dc, base, hp);
  if (cur <= 0 || p - cur > MAX_DIST) return 0;
  const int lookahead = (int)(total - p);
  int nice = kT.nice[level];
  if (nice > lookahead) nice = lookahead;
  const int chain = kT.chain[level];
  const bool inb = p + MAX_MATCH <= total;
  const uint8_t* here = base + p;
  int best = four ? WANT_MIN - 1 : MIN_MATCH - 1, bd = 0, n = 0;
  uint16_t scan_end = inb ? load16(here + best - 1) : 0;
  const uint16_t scan_start = inb ? load16(here) : 0;
  for (;;) {
    int ml = 0;
    if (!inb)
      ml = match_z_thread(base, p, cur, total);
    else if (load16(base + cur + best - 1) == scan_end && load16(base + cur) == scan_start)
      ml = match_thread(here, base + cur);
    if (ml > best) {
      best = ml;
      bd = (int)(p - cur);
      if (ml >= nice) break;
      if (inb) scan_end = load16(here + best - 1);
    }
    if (++n == chain) break;
    const long long next = true_prev(cur, limit, ch, dg, dc, base, hp);
    if (next <= limit || next >= cur) break;
    cur = next;
  }
  return pack_slot(best, bd);
}

#ifdef __CUDACC__
// kSort positions [s0, s0 + n) of build_chains' tile on the card, `table`
// holding each hash's last position before s0 that is left in: the keys
// (hash << 13 | position - s0 << 1 | skipped, kSort of them, the padding
// all ones) sorted in shared memory (bitonic), then an exclusive max-scan
// over hash << 13 | (position - s0 + 1, or 0 where skipped) gives each
// key the last position before it in the sort with its hash that is left
// in (low bits 0: none, the table's); the capped deltas go out in order,
// and the last key of each hash leaves its hash's last position in the
// table for the next sort. After the keys lie kSort 16-bit deltas and a
// total a warp. MEDIUM's 16-bit hash4 takes two passes, a half of the hash
// space each (`half`; -1 for the 3-byte hash): the other half's positions
// are padding, and only the half's deltas go out.
__device__ void tile_pass(uint32_t* keys, int32_t* table, long long s0, int n, uint16_t* out,
                          int tid, const uint8_t* base, int half) {
  constexpr int kPer = kSort / kChainThreads;
  for (int k = 2; k <= kSort; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = tid; i < kSort; i += kChainThreads) {
        const int x = i ^ j;
        if (x > i) {
          const uint32_t a = keys[i], b = keys[x];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[x] = a;
          }
        }
      }
    }
  __syncthreads();
  uint16_t* dl = (uint16_t*)(keys + kSort);
  uint32_t* wsum = keys + kSort + kSort / 2;
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t key[kPer], ex[kPer], m = 0;
#pragma unroll
  for (int r = 0; r < kPer; r++) {
    key[r] = keys[kPer * tid + r];
    const uint32_t hi = key[r] >> 13 << 13, pos1 = (key[r] >> 1 & 0xfffu) + 1u;
    const uint32_t wv = key[r] == 0xffffffffu ? 0u : hi | ((key[r] & 1u) ? 0u : pos1);
    ex[r] = m;
    m = m > wv ? m : wv;
  }
  uint32_t x = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off && y > x) x = y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, v, off);
      if (lane >= off && y > v) v = y;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  uint32_t before = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) before = 0;
  if (warp > 0 && wsum[warp - 1] > before) before = wsum[warp - 1];
  int32_t last[kPer];
#pragma unroll
  for (int r = 0; r < kPer; r++) {
    last[r] = -1;
    if (key[r] == 0xffffffffu) continue;
    const uint32_t e = ex[r] > before ? ex[r] : before;
    const uint32_t h = key[r] >> 13;
    const int i = (int)(key[r] >> 1 & 0xfffu);
    const long long pred = (e >> 13) == h && (e & 0x1fffu) ? s0 + (e & 0x1fffu) - 1 : table[h];
    const long long d = s0 + i - pred;
    dl[i] = (uint16_t)(d < 0xffff ? d : 0xffff);
    // the last key of its hash: the hash's last position left in, if any
    const int at = kPer * tid + r;
    if (at + 1 == kSort || keys[at + 1] >> 13 != h) {
      const uint32_t wv = (key[r] & 1u) ? h << 13 : h << 13 | ((uint32_t)i + 1u);
      const uint32_t incl = e > wv ? e : wv;
      if (incl & 0x1fffu) last[r] = (int32_t)(s0 + (incl & 0x1fffu) - 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; r++)
    if (last[r] >= 0) table[key[r] >> 13] = last[r];
  for (int i = tid; i < n; i += kChainThreads)
    if (half < 0 || (int)(hash4_at(base, s0 + i) >> 15) == half) out[i] = dl[i];
  __syncthreads();
}
#endif

// the deltas of a piece's positions [t0, t1): each position's delta to the
// last position before it with its hash (positions [lo, t0) and the tile
// inserted in order, those before lo summed up by head_old), capped at
// 0xffff: the prevd value zlib's serial insert writes. The tile starts from
// the last occurrences in the kLookback positions before it: an older one
// lies at least kLookback back, where the cap gives the same delta.
// Positions `sk` skips are left out of the chains (levels 1-3 and MEDIUM:
// the chains under an assumed skip map, and DS's after a pump under the
// parse's own); each position still gets its delta to the last one left in
// before it. `four`: MEDIUM's chains, keyed by hash4 (head_old int32
// [65536], a half of it a pass on the card); the caller keeps t1 where
// hash4 can hash. On the card the whole block takes kSort positions at
// once (tile_pass).
EX_DEV void tile_chains(const uint8_t* base, const long long* pr, long long t0, long long t1,
                        const int32_t* head_old, int32_t* table, uint32_t* keys, uint16_t* deltas,
                        int tid, int nthreads, const Skip& sk, bool four) {
  const long long lo = pr[P_LO];
  const long long ws = t0 - kLookback > lo ? t0 - kLookback : lo;
  const bool seeded = ws == lo && head_old;
  uint16_t* out = deltas + pr[P_DOFF];
  const long long c0 = pr[P_C0];
#ifdef __CUDACC__
  for (int half = 0; half < (four ? 2 : 1); half++) {
    const uint32_t hb = (uint32_t)half << 15;
    for (int h = tid; h < HASH_SIZE; h += nthreads) table[h] = seeded ? head_old[hb | h] : 0;
    __syncthreads();
    // the lookback: 4 positions a thread a step, their 6 (hash4: 7) bytes
    // in two loads
    for (long long g = ws + 4LL * tid; g < t0; g += 4LL * nthreads) {
      if (g + 3 < t0) {
        const uint32_t a = load32u(base + g), b = load32u(base + g + (four ? 4 : 2));
        if (four) {
#pragma unroll
          for (int r = 0; r < 4; r++) {
            const uint32_t v = r ? (a >> (8 * r)) | (b << (32 - 8 * r)) : a;
            const uint32_t h = (v * 2654435761u) >> 16;
            if ((h >> 15) == (uint32_t)half && !sk.on(g + r))
              atomic_max_i32(table + (h & (HASH_SIZE - 1)), (int32_t)(g + r));
          }
        } else {
          const uint32_t by[6] = {a & 0xff, a >> 8 & 0xff, a >> 16 & 0xff, a >> 24,
                                  b >> 16 & 0xff, b >> 24};
#pragma unroll
          for (int r = 0; r < 4; r++) {
            const uint32_t h = (by[r] << (2 * HASH_SHIFT) ^ by[r + 1] << HASH_SHIFT ^ by[r + 2]) &
                               (HASH_SIZE - 1);
            if (!sk.on(g + r)) atomic_max_i32(table + h, (int32_t)(g + r));
          }
        }
      } else {
        for (long long q = g; q < t0; q++) {
          if (sk.on(q)) continue;
          const uint32_t h = four ? hash4_at(base, q) : hash_at(base, q);
          if (!four || (h >> 15) == (uint32_t)half)
            atomic_max_i32(table + (h & (HASH_SIZE - 1)), (int32_t)q);
        }
      }
    }
    // then the tile kSort positions at a time, each sort's keys (hash,
    // position in the sort, skipped; the padding last) after the last one's
    for (long long s0 = t0; s0 < t1; s0 += kSort) {
      const int n = (int)(t1 - s0 < kSort ? t1 - s0 : kSort);
      for (int i = tid; i < kSort; i += nthreads) {
        uint32_t key = 0xffffffffu;
        if (i < n) {
          const uint32_t h = four ? hash4_at(base, s0 + i) : hash_at(base, s0 + i);
          if (!four || (h >> 15) == (uint32_t)half)
            key = (h & (HASH_SIZE - 1)) << 13 | (uint32_t)i << 1 | (sk.on(s0 + i) ? 1u : 0u);
        }
        keys[i] = key;
      }
      tile_pass(keys, table, s0, n, out + (s0 - c0), tid, base, four ? half : -1);
    }
  }
#else
  (void)keys;
  (void)tid;
  const int hsize = four ? 1 << 16 : HASH_SIZE;
  for (int h = 0; h < hsize; h++) table[h] = seeded ? head_old[h] : 0;
  for (long long p = ws; p < t0; p++)
    if (!sk.on(p)) atomic_max_i32(table + (four ? hash4_at(base, p) : hash_at(base, p)), (int32_t)p);
  for (long long p = t0; p < t1; p++) {
    const uint32_t h = four ? hash4_at(base, p) : hash_at(base, p);
    const long long d = p - table[h];
    out[p - c0] = (uint16_t)(d < 0xffff ? d : 0xffff);
    if (!sk.on(p)) table[h] = (int32_t)p;
  }
#endif
}

// the piece a block serves: the last row whose first block (column `col`)
// is at or below `block`
EX_INL int find_piece(const long long* pieces, int P, int col, long long block) {
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pieces[(size_t)mid * kPiece + col] <= block)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// the chase's slots of positions [s, s + n): on the card staged kStage at a
// time into a ring of two stages in shared memory, the next stage loading
// (cp.async, 8 bytes a copy) while the warp reads this one; every lane calls
// at() with the same position
struct SlotSrc {
  const Slot* g;
  long long s, n;
  Slot* sm;
  long long cur;  // the stage the warp reads, -1 before the first

#ifdef __CUDACC__
  __device__ void stage(long long blk, int lane) {
    Slot* dst = sm + (blk & 1) * kStage;
    const long long i0 = blk * kStage;
    for (int i = lane; i < kStage; i += 32) {
      if (i0 + i >= n) break;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(g + i0 + i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ Slot at(long long pos, int lane) {
    const long long i = pos - s;
    const long long blk = i / kStage;
    if (blk != cur) {
      if (blk != cur + 1 || cur < 0) stage(blk, lane);  // the first read
      asm volatile("cp.async.wait_all;\n" ::);
      __syncwarp();
      cur = blk;
      stage(blk + 1, lane);
    }
    return sm[(blk & 1) * kStage + (i - blk * kStage)];
  }
#else
  Slot at(long long pos, int) const { return g[pos - s]; }
#endif
};

// ---------------------------------------------------------------------------
// the bit writer: native's 64-bit accumulator over the chunk's slot
// ---------------------------------------------------------------------------

struct BitW {
  uint8_t* out;
  long long cap, wpos;
  uint64_t buf;
  int cnt;  // bits held in buf, < 64
  int lane;

  EX_INL void store_byte(long long at, uint8_t v) {
    if (at < cap) out[at] = v;
  }
  EX_INL void store8(uint64_t v) {
#ifdef __CUDACC__
    if (lane < 8) store_byte(wpos + lane, (uint8_t)(v >> (8 * lane)));
#else
    for (int j = 0; j < 8; j++) store_byte(wpos + j, (uint8_t)(v >> (8 * j)));
#endif
    wpos += 8;
  }
  // v masked to n bits, n <= 56
  EX_INL void put64(uint64_t v, int n) {
    if (cnt + n < 64) {
      buf |= v << cnt;
      cnt += n;
    } else {
      buf |= v << cnt;
      store8(buf);
      buf = v >> (64 - cnt);
      cnt = cnt + n - 64;
    }
  }
  EX_INL void put(uint32_t v, int nbits) { put64(v & ((1u << nbits) - 1u), nbits); }
  EX_INL void byte(uint8_t b) {
    if (lane == 0) store_byte(wpos, b);
    wpos++;
  }
  EX_INL void align() {
    while (cnt > 0) {
      byte((uint8_t)buf);
      buf >>= 8;
      cnt -= 8;
    }
    buf = 0;
    cnt = 0;
  }
  // a stored span from the input, every lane a byte in turn
  EX_INL void bytes(const uint8_t* p, long long n) {
#ifdef __CUDACC__
    for (long long j = lane; j < n; j += 32) store_byte(wpos + j, p[j]);
    warp_sync();
#else
    for (long long j = 0; j < n; j++) store_byte(wpos + j, p[j]);
#endif
    wpos += n;
  }
};

// ---------------------------------------------------------------------------
// zlib's tree construction (native TreeBuild)
// ---------------------------------------------------------------------------

struct TreeBuild {
  Work* w;
  uint64_t opt_len, static_len;

  EX_INL bool smaller(int a, int b) const {
    return w->f[a] < w->f[b] || (w->f[a] == w->f[b] && w->depth[a] <= w->depth[b]);
  }
  EX_DEV void downheap(int k, int heap_len) {
    int* heap = w->heap;
    const int v = heap[k];
    int j = k << 1;
    while (j <= heap_len) {
      if (j < heap_len && smaller(heap[j + 1], heap[j])) j++;
      if (smaller(v, heap[j])) break;
      heap[k] = heap[j];
      k = j;
      j <<= 1;
    }
    heap[k] = v;
  }

  EX_BIG int build(const uint32_t* freq_in, int elems, const uint8_t* stree_len, const int* extra,
                   int extra_base, int max_length, uint8_t* lens, uint16_t* codes) {
    const int nnodes = 2 * elems + 1;
    uint64_t* f = w->f;
    int* length = w->length;
    int* dad = w->dad;
    int* depth = w->depth;
    int* heap = w->heap;
    for (int i = 0; i < nnodes; i++) {
      f[i] = 0;
      length[i] = dad[i] = depth[i] = 0;
    }
    for (int i = 0; i <= HEAP_SIZE; i++) heap[i] = 0;
    for (int i = 0; i < elems; i++) f[i] = freq_in[i];
    int heap_len = 0, heap_max = HEAP_SIZE;
    int max_code = -1;
    for (int i = 0; i < elems; i++) {
      if (f[i]) {
        heap[++heap_len] = i;
        max_code = i;
        depth[i] = 0;
      } else {
        lens[i] = 0;
      }
    }
    while (heap_len < 2) {
      const int node = max_code < 2 ? ++max_code : 0;
      heap[++heap_len] = node;
      f[node] = 1;
      depth[node] = 0;
      opt_len--;
      if (stree_len) static_len -= stree_len[node];
    }
    for (int k = heap_len / 2; k >= 1; k--) downheap(k, heap_len);
    int node = elems;
    do {
      const int nmin = heap[1];
      heap[1] = heap[heap_len--];
      downheap(1, heap_len);
      const int m = heap[1];
      heap[--heap_max] = nmin;
      heap[--heap_max] = m;
      f[node] = f[nmin] + f[m];
      depth[node] = (depth[nmin] > depth[m] ? depth[nmin] : depth[m]) + 1;
      dad[nmin] = dad[m] = node;
      heap[1] = node++;
      downheap(1, heap_len);
    } while (heap_len >= 2);
    heap[--heap_max] = heap[1];

    // gen_bitlen
    int bl_count[16] = {0};
    length[heap[heap_max]] = 0;
    int overflow = 0;
    for (int h = heap_max + 1; h < HEAP_SIZE; h++) {
      const int nn = heap[h];
      int bits = length[dad[nn]] + 1;
      if (bits > max_length) {
        bits = max_length;
        overflow++;
      }
      length[nn] = bits;
      if (nn > max_code) continue;
      bl_count[bits]++;
      const int xbits = nn >= extra_base ? extra[nn - extra_base] : 0;
      const uint64_t fr = f[nn];
      opt_len += fr * (uint64_t)(bits + xbits);
      if (stree_len) static_len += fr * (uint64_t)(stree_len[nn] + xbits);
    }
    if (overflow > 0) {
      do {
        int bits = max_length - 1;
        while (bl_count[bits] == 0) bits--;
        bl_count[bits]--;
        bl_count[bits + 1] += 2;
        bl_count[max_length]--;
        overflow -= 2;
      } while (overflow > 0);
      int h = HEAP_SIZE;
      for (int bits = max_length; bits != 0; bits--) {
        int nn = bl_count[bits];
        while (nn != 0) {
          const int m = heap[--h];
          if (m > max_code) continue;
          if (length[m] != bits) {
            opt_len += (uint64_t)(bits - length[m]) * f[m];
            length[m] = bits;
          }
          nn--;
        }
      }
    }
    // gen_codes
    uint32_t next_code[16] = {0};
    uint32_t code = 0;
    for (int bits = 1; bits <= max_length; bits++) {
      code = (code + bl_count[bits - 1]) << 1;
      next_code[bits] = code;
    }
    for (int nn = 0; nn <= max_code; nn++) {
      const int ln = length[nn];
      lens[nn] = (uint8_t)ln;
      codes[nn] = ln ? (uint16_t)bit_reverse(next_code[ln]++, ln) : 0;
    }
    for (int nn = max_code + 1; nn < elems; nn++) {
      lens[nn] = 0;
      codes[nn] = 0;
    }
    return max_code;
  }
};

// scan_tree / send_tree: zlib's run-coalescing state machine
EX_BIG void scan_tree(const uint8_t* lens, int max_code, uint32_t* bl_freq) {
  int prevlen = -1, nextlen = lens[0], count = 0;
  int max_count = nextlen == 0 ? 138 : 7;
  int min_count = nextlen == 0 ? 3 : 4;
  for (int n = 0; n <= max_code; n++) {
    const int curlen = nextlen;
    nextlen = n + 1 <= max_code ? lens[n + 1] : 0xffff;
    if (++count < max_count && curlen == nextlen) continue;
    if (count < min_count) {
      bl_freq[curlen] += count;
    } else if (curlen != 0) {
      if (curlen != prevlen) bl_freq[curlen]++;
      bl_freq[REP_3_6]++;
    } else if (count <= 10) {
      bl_freq[REPZ_3_10]++;
    } else {
      bl_freq[REPZ_11_138]++;
    }
    count = 0;
    prevlen = curlen;
    if (nextlen == 0) {
      max_count = 138;
      min_count = 3;
    } else if (curlen == nextlen) {
      max_count = 6;
      min_count = 3;
    } else {
      max_count = 7;
      min_count = 4;
    }
  }
}

EX_BIG void send_tree(BitW& bw, const uint8_t* lens, int max_code, const uint8_t* bl_len,
                      const uint16_t* bl_code) {
  int prevlen = -1, nextlen = lens[0], count = 0;
  int max_count = nextlen == 0 ? 138 : 7;
  int min_count = nextlen == 0 ? 3 : 4;
  for (int n = 0; n <= max_code; n++) {
    const int curlen = nextlen;
    nextlen = n + 1 <= max_code ? lens[n + 1] : 0xffff;
    if (++count < max_count && curlen == nextlen) continue;
    if (count < min_count) {
      do {
        bw.put(bl_code[curlen], bl_len[curlen]);
      } while (--count != 0);
    } else if (curlen != 0) {
      if (curlen != prevlen) {
        bw.put(bl_code[curlen], bl_len[curlen]);
        count--;
      }
      bw.put(bl_code[REP_3_6], bl_len[REP_3_6]);
      bw.put(count - 3, 2);
    } else if (count <= 10) {
      bw.put(bl_code[REPZ_3_10], bl_len[REPZ_3_10]);
      bw.put(count - 3, 3);
    } else {
      bw.put(bl_code[REPZ_11_138], bl_len[REPZ_11_138]);
      bw.put(count - 11, 7);
    }
    count = 0;
    prevlen = curlen;
    if (nextlen == 0) {
      max_count = 138;
      min_count = 3;
    } else if (curlen == nextlen) {
      max_count = 6;
      min_count = 3;
    } else {
      max_count = 7;
      min_count = 4;
    }
  }
}

// ---------------------------------------------------------------------------
// the chunk deflater (native ChunkDeflater), one per warp
// ---------------------------------------------------------------------------

struct MedMatch {
  long long start;     // the match's source
  long long strstart;  // its destination
  long long orgstart;  // the original destination (insert bookkeeping)
  int length;
};

struct Deflater {
  const uint8_t* base;  // the window's position 0: the dictionary, then the chunk
  long long dict_len, n, total;
  int level, klevel, lane;
  Work* w;
  Work4* w4;
  BitW bw;
  long long ns, block_start;
  // the lazy matcher's carry state (zlib's)
  int match_length, prev_length;
  long long match_start, prev_start;
  bool match_available;
  long long spos;
  uint32_t sh;
  bool shv;
  bool started;  // the scan's start (dictionary insertion) is behind it
  // MEDIUM's pre-found next match
  long long med_next_start, med_next_strstart, med_next_orgstart;
  int med_next_len;
  // levels 1-9: static chains and the resolve's slots instead of inserts
  // and walks (the live walks read `ch`); levels 1-3 keep the parse's skip
  // map in `map` from map_b0 (the truth below the chase's position, the
  // map the slots assumed above it), and count loop tops and live walks
  Chains ch;
  SlotSrc sl;
  uint32_t* map;
  long long map_b0;
  int32_t* ldh;  // levels 1-3: each hash's last position where the two maps differ
  uint16_t* dlist;            // levels 1-3: the disagreements' list (Disagree's d) ...
  long long dlist_c0, dlist_c1;  // ... for positions [c0, c1)
  long long tops, lives;         // levels 1-3: loop tops, live walks
  // MEDIUM over the slots: 4-byte-hash chains (ldh by the hash folded to
  // 15 bits), and the first position whose insert the parse has not decided
  bool four;
  long long front;
  uint32_t* hist;       // on the card: a block's frequencies in shared memory
  uint64_t* ewords;     // and the emission's words (kEmitWords)
  long long clk_flush;  // clock64 cycles inside flush_block (the card)
  long long clk_emit;   // of which in emit_symbols

  // ---- block emission ----------------------------------------------------

  EX_BIG void emit_stored(long long p, long long len, bool last) {
    long long i = 0;
    do {
      const long long take = len - i < 65535 ? len - i : 65535;
      const bool fin = last && i + take == len;
      bw.put(fin ? 1 : 0, 1);
      bw.put(0, 2);
      bw.align();
      bw.byte(take & 0xff);
      bw.byte((take >> 8) & 0xff);
      bw.byte(~take & 0xff);
      bw.byte((~take >> 8) & 0xff);
      bw.bytes(base + p + i, take);
      i += take;
    } while (i < len);
  }

  // a block's fused length table: code and extra bits in one value
  EX_DEV void fuse_lengths(const uint16_t* llc, const uint8_t* lll) {
    for (int v = 0; v < 256; v++) {
      const int lc = kT.len_code[v];
      const int sym = 257 + lc;
      w->ltab[v] = (uint32_t)llc[sym] | ((uint32_t)(v + 3 - kT.len_base[lc]) << lll[sym]);
      w->ltn[v] = (uint8_t)(lll[sym] + kT.len_extra[lc]);
    }
  }

  EX_INL void put_match(int len, int dist, const uint16_t* dc, const uint8_t* dl) {
    const int v = len - 3;
    const int c = dist_to_code(dist);
    const uint64_t dfused = (uint64_t)dc[c] | ((uint64_t)(dist - kT.dist_base[c]) << dl[c]);
    const int dn = dl[c] + kT.dist_extra[c];
    bw.put64((uint64_t)w->ltab[v] | (dfused << w->ltn[v]), w->ltn[v] + dn);
  }

#ifdef __CUDACC__
  // levels 1-9 on the card: the block's symbols 32 at a time, a symbol a
  // lane: its code and extra bits fused (at most 48 bits), their offsets
  // by a warp scan past the bit writer's partial word, ORed into 64-bit
  // words in shared memory; the finished words are stored a byte a lane
  // and the rest is the bit writer's partial word, as put64 leaves them
  __device__ void emit_symbols_warp(const uint16_t* llc, const uint8_t* lll, const uint16_t* dc,
                                    const uint8_t* dl) {
    const Sym* syms = w->syms;
    BitW out = bw;
    for (long long g = 0; g < ns; g += 32) {
      const long long i = g + lane;
      uint64_t v = 0;
      int nb = 0;
      if (i < ns) {
        const Sym s = syms[i];
        if (s.dist == 0) {
          v = llc[s.lenlit];
          nb = lll[s.lenlit];
        } else {
          const int l = s.lenlit - 3;
          const int c = dist_to_code(s.dist);
          const uint64_t dfused =
              (uint64_t)dc[c] | ((uint64_t)(s.dist - kT.dist_base[c]) << dl[c]);
          v = (uint64_t)w->ltab[l] | (dfused << w->ltn[l]);
          nb = w->ltn[l] + dl[c] + kT.dist_extra[c];
        }
      }
      int inc = nb;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const int bits = out.cnt + __shfl_sync(kFull, inc, 31);
      if (lane < kEmitWords) ewords[lane] = lane == 0 ? out.buf : 0;
      __syncwarp();
      if (nb) {
        const int at = out.cnt + inc - nb, sh = at & 63;
        atomicOr((unsigned long long*)ewords + (at >> 6), (unsigned long long)(v << sh));
        if (sh + nb > 64)
          atomicOr((unsigned long long*)ewords + (at >> 6) + 1,
                   (unsigned long long)(v >> (64 - sh)));
      }
      __syncwarp();
      const int full = bits >> 6;
      for (int b = lane; b < 8 * full; b += 32)
        out.store_byte(out.wpos + b, (uint8_t)(ewords[b >> 3] >> (8 * (b & 7))));
      out.wpos += 8 * full;
      out.buf = ewords[full];
      out.cnt = bits & 63;
      __syncwarp();
    }
    bw = out;
  }
#endif

  EX_BIG void emit_symbols(const uint16_t* llc, const uint8_t* lll, const uint16_t* dc,
                           const uint8_t* dl) {
#ifdef __CUDACC__
    const long long clk0 = clock64();
#endif
    fuse_lengths(llc, lll);
#ifdef __CUDACC__
    if (ewords) {
      warp_sync();
      emit_symbols_warp(llc, lll, dc, dl);
      bw.put64(llc[256], lll[256]);  // EOB
      clk_emit += clock64() - clk0;
      return;
    }
    (void)clk0;
#endif
    for (long long i = 0; i < ns; i++) {
      const Sym s = w->syms[i];
      if (s.dist == 0)
        bw.put64(llc[s.lenlit], lll[s.lenlit]);
      else
        put_match(s.lenlit, s.dist, dc, dl);
    }
    bw.put64(llc[256], lll[256]);  // EOB
  }

  // the dynamic header of trees built from llf/df into lll/llc, dl/dc;
  // returns (l_max, d_max, max_blindex) through the pointers and the bits
  // of the trees in opt_len, static_len
  EX_BIG void build_trees(int* l_max, int* d_max, int* max_blindex, uint64_t* opt_len,
                          uint64_t* static_len) {
    TreeBuild tb{w, 0, 0};
    *l_max = tb.build(w->llf, L_CODES, kT.s_lll, kT.len_extra, 257, 15, w->lll, w->llc);
    *d_max = tb.build(w->df, D_CODES, kT.s_dl, kT.dist_extra, 0, 15, w->dl, w->dc);
    for (int i = 0; i < BL_CODES; i++) w->blf[i] = 0;
    scan_tree(w->lll, *l_max, w->blf);
    scan_tree(w->dl, *d_max, w->blf);
    tb.build(w->blf, BL_CODES, nullptr, kT.extra_bl, 0, 7, w->bll, w->blc);
    int mb = BL_CODES - 1;
    while (mb >= 3 && w->bll[kT.bl_order[mb]] == 0) mb--;
    *max_blindex = mb;
    *opt_len = tb.opt_len;
    *static_len = tb.static_len;
  }

  EX_DEV void send_header(bool last, int l_max, int d_max, int max_blindex) {
    bw.put((2u << 1) + (last ? 1u : 0u), 3);
    bw.put(l_max + 1 - 257, 5);
    bw.put(d_max + 1 - 1, 5);
    bw.put(max_blindex + 1 - 4, 4);
    for (int i = 0; i <= max_blindex; i++) bw.put(w->bll[kT.bl_order[i]], 3);
    send_tree(bw, w->lll, l_max, w->bll, w->blc);
    send_tree(bw, w->dl, d_max, w->bll, w->blc);
  }

  // zlib's _tr_flush_block: exact trees, the whole-byte cost rule
  EX_BIG void flush_block(bool last, long long block_end) {
    warp_sync();
#ifdef __CUDACC__
    const long long clk0 = clock64();
#endif
    const long long stored_len = block_end - block_start;
    uint64_t opt_lenb, static_lenb;
    int l_max = 0, d_max = 0, max_blindex = 0;
    if (level > 0) {
#ifdef __CUDACC__
      if (hist) {  // levels 1-9: the lanes share the symbols, shared-memory atomics
        for (int i = lane; i < L_CODES + D_CODES; i += 32) hist[i] = 0;
        __syncwarp();
        for (long long i = lane; i < ns; i += 32) {
          const Sym s = w->syms[i];
          if (s.dist == 0) {
            atomicAdd(hist + s.lenlit, 1u);
          } else {
            atomicAdd(hist + 257 + kT.len_code[s.lenlit - 3], 1u);
            atomicAdd(hist + L_CODES + dist_to_code(s.dist), 1u);
          }
        }
        __syncwarp();
        for (int i = lane; i < L_CODES; i += 32) w->llf[i] = hist[i] + (i == 256 ? 1u : 0u);
        for (int i = lane; i < D_CODES; i += 32) w->df[i] = hist[L_CODES + i];
        __syncwarp();
      } else
#endif
      {
        for (int i = 0; i < L_CODES; i++) w->llf[i] = 0;
        for (int i = 0; i < D_CODES; i++) w->df[i] = 0;
        w->llf[256] = 1;
        for (long long i = 0; i < ns; i++) {
          const Sym s = w->syms[i];
          if (s.dist == 0) {
            w->llf[s.lenlit]++;
          } else {
            w->llf[257 + kT.len_code[s.lenlit - 3]]++;
            w->df[dist_to_code(s.dist)]++;
          }
        }
      }
      uint64_t opt_len, static_len;
      build_trees(&l_max, &d_max, &max_blindex, &opt_len, &static_len);
      opt_len += 3ull * (max_blindex + 1) + 5 + 5 + 4;
      opt_lenb = (opt_len + 3 + 7) >> 3;
      static_lenb = (static_len + 3 + 7) >> 3;
      if (static_lenb <= opt_lenb) opt_lenb = static_lenb;
    } else {
      opt_lenb = static_lenb = (uint64_t)stored_len + 5;
    }
    if ((uint64_t)stored_len + 4 <= opt_lenb) {
      emit_stored(block_start, stored_len, last);
    } else if (static_lenb == opt_lenb) {
      bw.put((1u << 1) + (last ? 1u : 0u), 3);
      emit_symbols(kT.s_llc, kT.s_lll, kT.s_dc, kT.s_dl);
    } else {
      send_header(last, l_max, d_max, max_blindex);
      emit_symbols(w->llc, w->lll, w->dc, w->dl);
    }
    ns = 0;
    block_start = block_end;
    warp_sync();
#ifdef __CUDACC__
    clk_flush += clock64() - clk0;
#endif
  }

  EX_INL void push(int dist, int lenlit) {
    w->syms[ns].dist = (uint16_t)dist;
    w->syms[ns].lenlit = (uint16_t)lenlit;
    ns++;
  }

  EX_DEV void start_scan() {
    if (started) return;
    started = true;
    spos = dict_len;  // the static chains hold the dictionary
  }

  // the parse's map over [a, e) (a < e): the positions in [s0, s1) skipped,
  // the rest left in. The map held what the slots assumed there; it is left
  // holding the truth, each position where the two differed is the last of
  // its hash in ldh, and the result is the highest such position (-1 if
  // none). The word holding e - 1 stays in (cw, cv), written back (dirty)
  // once the parse leaves it or a live walk reads the map. On the card a
  // lane a word (a range spans at most 10); ldh's stores go lane by lane,
  // so that the highest position of a hash stays.
  EX_INL long long mark(long long a, long long e, long long s0, long long s1, long long& cw,
                        uint32_t& cv, bool& dirty) {
    const long long ra = a - map_b0, re = e - map_b0, rs0 = s0 - map_b0, rs1 = s1 - map_b0;
    const long long w0 = ra >> 5, w1 = (re - 1) >> 5;
    if (dirty && cw != w0) {
      if (lane == 0) map[cw] = cv;
      dirty = false;
    }
    if (w0 == w1) {  // one word: the same values on every lane, no shuffle
      const long long wb = w0 << 5, k0 = rs0 - wb, k1 = rs1 - wb;
      const uint32_t mask = bit_range((int)(ra - wb), (int)(re - wb));
      const uint32_t t = mask & bit_range(k0 < 0 ? 0 : k0 > 32 ? 32 : (int)k0,
                                          k1 < 0 ? 0 : k1 > 32 ? 32 : (int)k1);
      const uint32_t old = w0 == cw ? cv : map[w0];
      const uint32_t diff = (old ^ t) & mask;
      for (uint32_t d = diff; d; d &= d - 1) note(map_b0 + wb + ctz32(d));
      dirty = diff != 0 || (w0 == cw && dirty);
      cw = w0;
      cv = (old & ~mask) | t;
      return diff ? map_b0 + wb + 31 - clz32(diff) : -1;
    }
    long long hit = -1;
    uint32_t last = 0, last_diff = 0;
#ifdef __CUDACC__
    uint32_t diff = 0;
    if (lane <= w1 - w0) {
      const long long w = w0 + lane;
#else
    for (long long w = w0; w <= w1; w++) {
      uint32_t diff;
#endif
      const long long wb = w << 5;
      const int lo = ra > wb ? (int)(ra - wb) : 0;
      const int hi = re < wb + 32 ? (int)(re - wb) : 32;
      const uint32_t mask = bit_range(lo, hi);
      const long long k0 = rs0 - wb, k1 = rs1 - wb;
      const uint32_t t = mask & bit_range(k0 < 0 ? 0 : k0 > 32 ? 32 : (int)k0,
                                          k1 < 0 ? 0 : k1 > 32 ? 32 : (int)k1);
      const uint32_t old = w == cw ? cv : map[w];
      const uint32_t nv = (old & ~mask) | t;
      diff = (old ^ t) & mask;
      if (diff) hit = map_b0 + wb + 31 - clz32(diff);
      if (w == w1) {
        last = nv;
        last_diff = diff;
      } else if (diff || (w == cw && dirty)) {
        map[w] = nv;
      }
#ifndef __CUDACC__
      for (uint32_t d = diff; d; d &= d - 1) note(map_b0 + wb + ctz32(d));
#endif
    }
#ifdef __CUDACC__
    for (unsigned dm = __ballot_sync(kFull, diff != 0); dm; dm &= dm - 1) {
      if (lane == __ffs(dm) - 1)
        for (uint32_t d = diff; d; d &= d - 1) note(map_b0 + ((w0 + lane) << 5) + ctz32(d));
      __syncwarp();
    }
    const int top = (int)(w1 - w0);
    last = __shfl_sync(kFull, last, top);
    last_diff = __shfl_sync(kFull, last_diff, top);
#endif
    dirty = last_diff != 0 || (w1 == cw && dirty);
    cw = w1;
    cv = last;
#ifdef __CUDACC__
    const unsigned m = __ballot_sync(kFull, hit >= 0);
    return m ? __shfl_sync(kFull, hit, 31 - __clz(m)) : -1;
#else
    return hit;
#endif
  }

  // a disagreement at q: the newest of its hash (only positions a walk of
  // this chase can read: hashed, below dlist_c1; none in a dry parse)
  EX_INL void note(long long q) {
    if (!ldh || q >= dlist_c1 || q + (four ? WANT_MIN : MIN_MATCH) > total) return;
    const uint32_t h = four ? hash4_at(base, q) & (HASH_SIZE - 1) : hash_at(base, q);
    const long long before = ldh[h];
    dlist[q - dlist_c0] = (uint16_t)(before >= 0 && q - before < 0xffff ? q - before : 0);
    ldh[h] = (int32_t)q;
  }

  // write the map's cached word back (before the map is read)
  EX_INL void map_flush(long long cw, uint32_t cv, bool& dirty) {
    if (dirty) {
      if (lane == 0) map[cw] = cv;
      dirty = false;
    }
    warp_sync();
  }

  // greedy loop, levels 1-3 (zlib deflate_fast), over positions < limit
  // with every clamp against total: a chunk and a flushing pump pass
  // limit = total, a NO_FLUSH pump total - (MIN_LOOKAHEAD - 1), so that no
  // decision depends on how much input has arrived (native's contract).
  // The chains are static and longest is the slot's walk, taken when the
  // walk read no position at or below the last one where the map it
  // assumed and the parse's own map differ (`ld`: the bits below a loop
  // top are final when the parse reaches it); else zlib's walk over the
  // static chains and the true map, live. The walk reads the bits of p's
  // hash chain alone, so a slot whose reach passes `ld` stands where its
  // hash's last disagreement (ldh) lies below the reach. So the symbols
  // are zlib's whatever the slots assumed. The loop's state stays in
  // registers.
  EX_DEV void run_greedy(long long limit) {
    const int lazy = kT.lazy[klevel];
    start_scan();
    const uint8_t* const b = base;
    const long long tot = total;
    Sym* const syms = w->syms;
    SlotSrc src = sl;
    for (int h = lane; h < HASH_SIZE; h += kLanes) ldh[h] = -1;
    long long p = spos, n = ns, ld = -1, nt = 0, nl = 0, cw = -1;
    uint32_t cv = 0;
    bool dirty = false;
    while (p < limit) {
      warp_sync();
      int mdist = 0, ml = 0;
      if (p + MIN_MATCH <= tot) {
        const Slot slot = src.at(p, lane);
        uint32_t v = slot.full;
        const long long reach = p - (long long)slot.aux;
        if (reach <= ld) {
          const long long lh = ldh[hash_at(b, p)];
          if (reach <= lh) {
            v = live_greedy_walk(b, tot, p, ch, Disagree{dlist, dlist_c0}, lh, klevel, false);
            nl++;
          }
        }
        nt++;
        mdist = (int)(v & 0x7fff);
        const long long m = v >> 15;
        ml = (int)(m < tot - p ? m : tot - p);
      }
      long long h;
      if (mdist > 0) {
        syms[n++] = Sym{(uint16_t)mdist, (uint16_t)ml};
        const long long end = p + ml;
        h = mark(p, end, p + 1, !(ml <= lazy && tot - end >= MIN_MATCH) ? end : p + 1, cw, cv,
                 dirty);
        p = end;
      } else {
        syms[n++] = Sym{0, b[p]};
        h = mark(p, p + 1, p + 1, p + 1, cw, cv, dirty);
        p++;
      }
      if (h > ld) ld = h;
      if (n >= SYM_END) {
        ns = n;
        flush_block(false, p);
        n = ns;
      }
    }
    map_flush(cw, cv, dirty);
    spos = p;
    ns = n;
    sl = src;
    tops += nt;
    lives += nl;
  }

  // longest(pos, hash_head, prev_len) from the position's slot: the
  // quartered walk's when prev_len >= good; max(prev_len, M) clamped by
  // total - pos, the distance taken only when M passes prev_len. Where nice
  // falls below prev_len (prev_len >= total - pos, at the end of the data)
  // zlib's walk over the static chains, live (live_walk).
  EX_INL int lookup(const Slot& slot, int lookahead, int prev_len, int good, int& mdist) {
    const uint32_t v = prev_len >= good ? slot.aux : slot.full;
    const int m = (int)(v >> 15);
    const int best = m > prev_len ? m : prev_len;
    mdist = m > prev_len ? (int)(v & 0x7fff) : 0;
    return best <= lookahead ? best : lookahead;
  }
  EX_BIG int live_walk(long long pos, int prev_len, int& mdist) {
    const int lookahead = (int)(total - pos);
    const int chain = prev_len >= kT.good[klevel] ? kT.chain[klevel] >> 2 : kT.chain[klevel];
    const uint32_t v = walk(base, total, pos, ch.prev(pos), ch, prev_len, chain, 0,
                            kT.nice[klevel], nullptr, nullptr);
    mdist = (int)(v & 0x7fff);
    const int best = (int)(v >> 15);
    return best <= lookahead ? best : lookahead;
  }

  // lazy loop, levels 4-9 (zlib deflate_slow); the same limit contract.
  // The chains are static (a match's interior and the loop top need no
  // insert) and longest is the slot's lookup. The loop's state stays in
  // registers (this object lives in local memory), written back for
  // flush_block and at the end.
  EX_DEV void run_slow(long long limit) {
    const int lazy = kT.lazy[klevel], good = kT.good[klevel];
    start_scan();
    const uint8_t* const b = base;
    const long long tot = total;
    Sym* const syms = w->syms;
    SlotSrc src = sl;
    long long p = spos, mstart = match_start, pstart = prev_start, n = ns;
    int mlen = match_length, plen = prev_length;
    bool avail = match_available, hv = shv;
    uint32_t h = sh;
    while (p < limit) {
      warp_sync();
      Slot slot{0u, 0u};
      if (p + MIN_MATCH <= tot) {
        if (!hv) {
          h = hash_at(b, p);
          hv = true;
        }
        slot = src.at(p, lane);
      }
      plen = mlen;
      pstart = mstart;
      mlen = MIN_MATCH - 1;
      if (slot.full && plen < lazy) {
        int mdist = 0;
        const int lookahead = (int)(tot - p);
        mlen = plen >= lookahead ? live_walk(p, plen, mdist)
                                 : lookup(slot, lookahead, plen, good, mdist);
        if (mdist > 0) mstart = p - mdist;
        if (mlen <= 5 && (mlen == MIN_MATCH && p - mstart > TOO_FAR)) mlen = MIN_MATCH - 1;
      }
      if (plen >= MIN_MATCH && mlen <= plen) {
        syms[n++] = Sym{(uint16_t)(p - 1 - pstart), (uint16_t)plen};
        p = p + plen - 1;
        hv = false;
        avail = false;
        mlen = MIN_MATCH - 1;
        if (n >= SYM_END) {
          ns = n;
          flush_block(false, p);
          n = ns;
        }
      } else if (avail) {
        syms[n++] = Sym{0, b[p - 1]};
        if (n >= SYM_END) {
          ns = n;
          flush_block(false, p);
          n = ns;
        }
        p++;
        if (hv) {
          if (p + MIN_MATCH <= tot)
            h = ((h << HASH_SHIFT) ^ (uint32_t)b[p + 2]) & (uint32_t)(HASH_SIZE - 1);
          else
            hv = false;
        }
      } else {
        avail = true;
        p++;
        if (hv) {
          if (p + MIN_MATCH <= tot)
            h = ((h << HASH_SHIFT) ^ (uint32_t)b[p + 2]) & (uint32_t)(HASH_SIZE - 1);
          else
            hv = false;
        }
      }
    }
    spos = p;
    match_start = mstart;
    prev_start = pstart;
    ns = n;
    match_length = mlen;
    prev_length = plen;
    match_available = avail;
    sh = h;
    shv = hv;
    sl = src;
  }

  // zlib's deflate_slow end-of-stream step: the deferred literal at the
  // last position, emitted when a finish or a flush drains the scan
  EX_DEV void emit_trailing_literal() {
    if (match_available) {
      push(0, base[total - 1]);
      match_available = false;
    }
  }

  // ---- MEDIUM (levels 11-13) ----------------------------------------------

  EX_INL uint32_t hash4(long long p) const {
    const uint32_t v = (uint32_t)base[p] | ((uint32_t)base[p + 1] << 8) |
                       ((uint32_t)base[p + 2] << 16) | ((uint32_t)base[p + 3] << 24);
    return (v * 2654435761u) >> 16;
  }
  EX_INL void insert4(long long pos) {
    const uint32_t h = hash4(pos);
    const long long d = pos - w4->head4[h];
    w4->prevd4[pos & (WSIZE - 1)] = (uint16_t)(d < 0xffff ? d : 0xffff);
    w4->head4[h] = (int32_t)pos;
  }
  EX_INL long long chain_prev4(long long pos) const {
    const long long d = w4->prevd4[pos & (WSIZE - 1)];
    return d ? pos - d : 0;
  }
  EX_DEV void insert_range(long long p, long long count) {
    for (long long i = 0; i < count && p + i + 4 <= total; i++) insert4(p + i);
  }

  EX_DEV int longest4(long long pos, long long cur, int& best_dist) {
    const int lookahead = (int)(total - pos);
    int chain = kT.chain[klevel];
    int best_len = WANT_MIN - 1;
    int nice = kT.nice[klevel];
    if (nice > lookahead) nice = lookahead;
    long long limit = pos - MAX_DIST;
    if (limit < 0) limit = 0;
    best_dist = 0;
    if (pos + MAX_MATCH <= total) {
      const uint8_t* here = base + pos;
      uint16_t scan_end = load16(here + best_len - 1);
      const uint16_t scan_start = load16(here);
      for (;;) {
        const uint8_t* cand = base + cur;
        const long long next_cur = cur - w4->prevd4[cur & (WSIZE - 1)];
        if (load16(cand + best_len - 1) == scan_end && load16(cand) == scan_start) {
          const int ml = match258(here, cand, lane);
          if (ml > best_len) {
            best_len = ml;
            best_dist = (int)(pos - cur);
            if (ml >= nice) break;
            scan_end = load16(here + best_len - 1);
          }
        }
        if (next_cur >= cur) break;
        cur = next_cur;
        if (cur <= limit) break;
        if (--chain == 0) break;
      }
    } else {
      for (;;) {
        const int ml = match258_z(base, pos, cur, total, lane);
        if (ml > best_len) {
          best_len = ml;
          best_dist = (int)(pos - cur);
          if (ml >= nice) break;
        }
        const long long next_cur = chain_prev4(cur);
        if (next_cur <= limit || next_cur >= cur) break;
        cur = next_cur;
        if (--chain == 0) break;
      }
    }
    if (!best_dist) return 0;
    return best_len <= lookahead ? best_len : lookahead;
  }

  EX_DEV void med_insert_match(MedMatch m) {
    if (total - m.strstart <= (long long)m.length + WANT_MIN) return;
    if (m.length < WANT_MIN) {  // a literal run: hash the covered tail
      m.strstart += 1;
      m.length -= 1;
      if (m.length > 0 && m.strstart >= m.orgstart) {
        const long long cnt =
            m.strstart + m.length > m.orgstart ? (long long)m.length : m.orgstart - m.strstart + 1;
        insert_range(m.strstart, cnt);
      }
      return;
    }
    if ((long long)m.length <= 16LL * kT.lazy[klevel] && total - m.strstart >= WANT_MIN) {
      m.length -= 1;  // the string at strstart is in the table already
      m.strstart += 1;
      if (m.strstart >= m.orgstart) {
        const long long cnt =
            m.strstart + m.length > m.orgstart ? (long long)m.length : m.orgstart - m.strstart + 1;
        insert_range(m.strstart, cnt);
      } else if (m.orgstart < m.strstart + m.length) {
        insert_range(m.orgstart, m.strstart + m.length - m.orgstart);
      }
    } else {  // a jump: only the position before the landing spot
      m.strstart += m.length;
      m.length = 0;
      if (m.strstart >= 1 && m.strstart - 1 + 4 <= total) insert4(m.strstart - 1);
    }
  }

  EX_INL void med_fizzle(MedMatch& cur, MedMatch& nm) {
    if (cur.length <= 1) return;
    if ((long long)cur.length > 1 + nm.start) return;
    if ((long long)cur.length > 1 + nm.strstart) return;
    if (ldb(base + nm.start - cur.length + 1) != ldb(base + nm.strstart - cur.length + 1)) return;
    const long long limit = nm.strstart > MAX_DIST ? nm.strstart - MAX_DIST : 0;
    MedMatch c = cur, nx = nm;
    long long mi = nx.start, oi = nx.strstart;
    int changed = 0;
    while (mi >= 1 && oi >= 1 && ldb(base + mi - 1) == ldb(base + oi - 1)) {
      if (c.length < 1) break;
      if (nx.strstart <= limit) break;
      if (nx.length >= 256) break;
      if (nx.start <= 1) break;
      nx.strstart--;
      nx.start--;
      nx.length++;
      c.length--;
      mi--;
      oi--;
      changed++;
    }
    if (!changed) return;
    if (c.length <= 1 && nx.length != 2) {
      nx.orgstart += 1;
      cur = c;
      nm = nx;
    }
  }

  // MEDIUM over the slots: the positions whose insert the parse decides
  // from the frontier F to e, those in [F, s) never inserted (the serial
  // inserts go in increasing order, so a position passed over stays out)
  // and [s, e) inserted; F moves to e. Where the map holds no skipped
  // position from F on (`clean`: the first round's), an insert differs
  // from nothing and only the positions passed over are marked.
  EX_INL long long med_decide(long long& F, long long s, long long e, bool clean, long long& cw,
                              uint32_t& cv, bool& dirty) {
    if (e <= F) return -1;
    const long long h = clean ? (s > F ? mark(F, s, F, s, cw, cv, dirty) : -1)
                              : mark(F, e, F, s, cw, cv, dirty);
    F = e;
    return h;
  }

  // whether the map holds no skipped position from `from` on, over its
  // `words` words
  EX_DEV bool map_clean(long long from, long long words) {
    const long long w0 = (from - map_b0) >> 5;
    bool set = false;
    for (long long wi = w0 + lane; wi < words; wi += kLanes) {
      uint32_t v = map[wi];
      if (wi == w0) v &= ~bit_range(0, (int)((from - map_b0) & 31));
      set |= v != 0;
    }
#ifdef __CUDACC__
    return !__any_sync(kFull, set);
#else
    return !set;
#endif
  }

  // the positions med_insert_match inserts for a match, [*a, *e) (none
  // where e <= a; insert_range stops where hash4 would read past the data)
  EX_INL void med_insert_range(MedMatch m, long long& a, long long& e) const {
    a = e = 0;
    if (total - m.strstart <= (long long)m.length + WANT_MIN) return;
    if (m.length < WANT_MIN) {  // a literal run: its covered tail
      m.strstart += 1;
      m.length -= 1;
      if (m.length > 0 && m.strstart >= m.orgstart) {
        a = m.strstart;
        e = a + (m.strstart + m.length > m.orgstart ? (long long)m.length
                                                    : m.orgstart - m.strstart + 1);
      }
    } else if ((long long)m.length <= 16LL * kT.lazy[klevel] && total - m.strstart >= WANT_MIN) {
      m.length -= 1;
      m.strstart += 1;
      if (m.strstart >= m.orgstart) {
        a = m.strstart;
        e = a + (m.strstart + m.length > m.orgstart ? (long long)m.length
                                                    : m.orgstart - m.strstart + 1);
      } else if (m.orgstart < m.strstart + m.length) {
        a = m.orgstart;
        e = m.strstart + m.length;
      }
    } else if (m.strstart + m.length >= 1) {  // a jump: only the position before the landing
      a = m.strstart + m.length - 1;
      e = a + 1;
    }
    if (e > total - (WANT_MIN - 1)) e = total - (WANT_MIN - 1);
  }

  // a MEDIUM walk at p (a loop top's or the lookahead's, p just inserted):
  // the slot, taken when its reach lies above the newest disagreement of
  // its (folded) hash, else longest4 over the parse's own map, live; a dry
  // parse takes every slot
  EX_INL uint32_t med_walk(SlotSrc& src, long long p, long long ld, bool dry, long long& nl) {
    const Slot slot = src.at(p, lane);
    if (dry) return slot.full;
    const long long reach = p - (long long)(slot.aux & 0xffffu);
    if (reach <= ld) {
      const long long lh = ldh[slot.aux >> 16];
      if (reach <= lh) {
        nl++;
        return live_greedy_walk(base, total, p, ch, Disagree{dlist, dlist_c0}, lh, klevel, true);
      }
    }
    return slot.full;
  }

  // MEDIUM (native's run_medium), levels 11-13, over static 4-byte-hash
  // chains: every walk (a fresh loop top's and the lookahead's at the next
  // match) is a slot lookup checked as at levels 1-3, the parse's own map
  // kept by med_decide. The inserts med_insert_match would make are
  // decisions in the map; the fizzle's byte compares, the emit and
  // flush_block stay serial. A dry parse (`dry`) follows the slots
  // unchecked and only writes the map: no symbol, no live walk, no list.
  EX_DEV void run_medium_slots(long long limit, bool dry, long long map_len) {
    if (!started) {
      started = true;
      spos = front = dict_len;
    }
    const bool clean = map_clean(front, map_len);
    const long long tot = total;
    SlotSrc src = sl;
    if (!dry)
      for (int h = lane; h < HASH_SIZE; h += kLanes) ldh[h] = -1;
    long long sp = spos, F = front, ld = -1, nt = 0, nl = 0, cw = -1, n = ns;
    uint32_t cv = 0;
    bool dirty = false;
    Sym* const syms = dry ? nullptr : w->syms;
    const uint8_t* const b = base;
    MedMatch carry{med_next_start, med_next_strstart, med_next_orgstart, med_next_len};
    while (sp < limit) {
      warp_sync();
      MedMatch cur;
      long long h;
      if (carry.length > 0) {
        cur = carry;
        carry.length = 0;
      } else {
        cur = MedMatch{0, sp, sp, 1};
        if (sp + WANT_MIN <= tot) {
          h = med_decide(F, sp, sp + 1, clean, cw, cv, dirty);
          if (h > ld) ld = h;
          const uint32_t v = med_walk(src, sp, ld, dry, nl);
          nt++;
          const int mdist = (int)(v & 0x7fff);
          const long long m = v >> 15;
          if (mdist > 0) {
            cur.start = sp - mdist;
            cur.length = (int)(m < tot - sp ? m : tot - sp);
          }
        }
      }
      // med_insert_match's inserts, decided with the lookahead's insert
      // where they meet it (one mark: the interior, then the next match's
      // start)
      long long ia, ie;
      med_insert_range(cur, ia, ie);
      const long long nxt = cur.strstart + cur.length;
      const bool look = tot - cur.strstart > MIN_LOOKAHEAD;  // look one match ahead
      const bool walk = look && nxt + WANT_MIN <= tot;
      if (ie > ia && !(walk && ie == nxt)) {
        h = med_decide(F, ia, ie, clean, cw, cv, dirty);
        if (h > ld) ld = h;
      }
      if (look) {
        MedMatch nm{0, nxt, nxt, 1};
        if (walk) {
          h = med_decide(F, ie > ia && ie == nxt ? ia : nxt, nxt + 1, clean, cw, cv, dirty);
          if (h > ld) ld = h;
          const uint32_t v = med_walk(src, nxt, ld, dry, nl);
          nt++;
          const int mdist = (int)(v & 0x7fff);
          const long long m = v >> 15;
          if (mdist > 0) {
            nm.start = nxt - mdist;
            nm.length = (int)(m < tot - nxt ? m : tot - nxt);
            med_fizzle(cur, nm);
          }
        }
        carry = nm;
      }
      if (!dry) {
        if (cur.length < WANT_MIN) {
          for (int i = 0; i < cur.length; i++) syms[n++] = Sym{0, ldb(b + cur.strstart + i)};
        } else {
          syms[n++] = Sym{(uint16_t)(cur.strstart - cur.start), (uint16_t)cur.length};
        }
      }
      sp = cur.strstart + cur.length;
      if (!dry && n >= SYM_END - 4) {
        ns = n;
        flush_block(false, sp);
        n = ns;
      }
    }
    map_flush(cw, cv, dirty);
    ns = n;
    spos = sp;
    front = F;
    med_next_start = carry.start;
    med_next_strstart = carry.strstart;
    med_next_orgstart = carry.orgstart;
    med_next_len = carry.length;
    sl = src;
    tops += nt;
    lives += nl;
  }

  // native's serial run_medium, its inserts into head4 and prevd4 and its
  // walks over them: DS's pumps once a FULL_FLUSH has left head4 stale
  EX_DEV void run_medium(long long limit) {
    const bool early_exit = klevel < 5;
    if (!started) {
      started = true;
      spos = dict_len;
      for (long long i = 0; i + 4 <= dict_len; i++) insert4(i);
    }
    while (spos < limit) {
      warp_sync();
      MedMatch cur;
      if (!early_exit && med_next_len > 0) {
        cur = MedMatch{med_next_start, med_next_strstart, med_next_orgstart, med_next_len};
        med_next_len = 0;
      } else {
        long long hash_head = 0;
        if (spos + 4 <= total) {
          insert4(spos);
          hash_head = chain_prev4(spos);
        }
        cur = MedMatch{0, spos, spos, 1};
        if (hash_head > 0 && spos - hash_head <= MAX_DIST) {
          int mdist = 0;
          const int ml = longest4(spos, hash_head, mdist);
          if (mdist > 0 && ml >= WANT_MIN) {
            cur.start = spos - mdist;
            cur.length = ml;
          }
          if (cur.start >= cur.strstart) cur.length = 1;
        }
      }
      med_insert_match(cur);
      // look one match ahead and trim the overlap
      if (!early_exit && total - cur.strstart > MIN_LOOKAHEAD) {
        const long long nxt = cur.strstart + cur.length;
        long long hh = 0;
        if (nxt + 4 <= total) {
          insert4(nxt);
          hh = chain_prev4(nxt);
        }
        MedMatch nm{0, nxt, nxt, 1};
        if (hh > 0 && nxt - hh <= MAX_DIST) {
          int mdist = 0;
          const int ml = longest4(nxt, hh, mdist);
          if (mdist > 0 && ml >= WANT_MIN) {
            nm.start = nxt - mdist;
            nm.length = ml;
          }
          if (nm.start >= nm.strstart) nm.length = 1;
          if (nm.length >= WANT_MIN) med_fizzle(cur, nm);
        }
        med_next_start = nm.start;
        med_next_strstart = nm.strstart;
        med_next_orgstart = nm.orgstart;
        med_next_len = nm.length;
      } else {
        med_next_len = 0;
      }
      if (cur.length < WANT_MIN) {
        for (int i = 0; i < cur.length; i++) push(0, base[cur.strstart + i]);
      } else {
        push((int)(cur.strstart - cur.start), cur.length);
      }
      spos = cur.strstart + cur.length;
      if (ns >= SYM_END - 4) flush_block(false, spos);
    }
  }

  // ---- QUICK (level 10): adaptive trees a 48 KiB segment ----------------

  EX_DEV void run_quick(bool last) {
    for (long long i = 0; i + 4 <= dict_len; i++) insert4(i);
    long long pos = dict_len;
    if (pos >= total) {  // empty input: one empty static block
      bw.put((1u << 1) + (last ? 1u : 0u), 3);
      bw.put64(kT.s_llc[256], kT.s_lll[256]);
      return;
    }
    bool have_prev = false, final_emitted = false;
    while (pos < total) {
      const long long seg_start = pos;
      const long long seg_end = pos + QSEG < total ? pos + QSEG : total;
      const bool seg_last_possible = last && seg_end == total;
      const uint64_t sb = bw.buf;
      const int sc = bw.cnt;
      const long long sw = bw.wpos;
      const uint16_t *llc_c, *dc_c;
      const uint8_t *lll_c, *dl_c;
      if (have_prev) {
        for (int i = 0; i < L_CODES; i++) w->llf[i] = w->llf_prev[i] + 1;
        for (int i = 0; i < D_CODES; i++) w->df[i] = w->df_prev[i] + 1;
        int l_max, d_max, max_blindex;
        uint64_t opt_len, static_len;
        build_trees(&l_max, &d_max, &max_blindex, &opt_len, &static_len);
        send_header(seg_last_possible, l_max, d_max, max_blindex);
        llc_c = w->llc;
        lll_c = w->lll;
        dc_c = w->dc;
        dl_c = w->dl;
      } else {
        bw.put((1u << 1) + (seg_last_possible ? 1u : 0u), 3);
        llc_c = kT.s_llc;
        lll_c = kT.s_lll;
        dc_c = kT.s_dc;
        dl_c = kT.s_dl;
      }
      fuse_lengths(llc_c, lll_c);
      for (int i = 0; i < L_CODES; i++) w->llf_cur[i] = 0;
      for (int i = 0; i < D_CODES; i++) w->df_cur[i] = 0;
      while (pos < seg_end) {
        warp_sync();
        if (pos + 4 <= total) {
          insert4(pos);
          const long long cand = chain_prev4(pos);
          if (cand > 0 && pos - cand <= MAX_DIST) {
            int ml = pos + MAX_MATCH <= total ? match258(base + pos, base + cand, lane)
                                             : match258_z(base, cand, pos, total, lane);
            if (ml > (int)(total - pos)) ml = (int)(total - pos);
            if (ml >= 4) {
              const int dist = (int)(pos - cand);
              put_match(ml, dist, dc_c, dl_c);
              w->llf_cur[257 + kT.len_code[ml - 3]]++;
              w->df_cur[dist_to_code(dist)]++;
              pos += ml;
              continue;
            }
          }
        }
        const uint8_t c = base[pos];
        bw.put64(llc_c[c], lll_c[c]);
        w->llf_cur[c]++;
        pos++;
      }
      bw.put64(llc_c[256], lll_c[256]);  // EOB
      w->llf_cur[256]++;
      // the whole-byte cost rule: rewind to stored when the block expanded
      const long long seg_bytes = pos - seg_start;  // a match may overshoot seg_end
      const long long bits_used = (bw.wpos * 8 + bw.cnt) - (sw * 8 + sc);
      const long long nstored = (seg_bytes + 65534) / 65535;
      const long long stored_bits = 7 + nstored * 40 + seg_bytes * 8;
      const bool is_seg_last = last && pos >= total;
      if (bits_used <= stored_bits) {
        final_emitted |= seg_last_possible;
      } else {
        warp_sync();
        bw.buf = sb;
        bw.cnt = sc;
        bw.wpos = sw;
        long long p = seg_start;
        while (p < pos) {
          const long long take = pos - p < 65535 ? pos - p : 65535;
          const bool lb = is_seg_last && p + take == pos;
          bw.put(lb ? 1u : 0u, 3);  // BFINAL, BTYPE 00
          bw.align();
          bw.byte((uint8_t)(take & 0xFF));
          bw.byte((uint8_t)(take >> 8));
          bw.byte((uint8_t)(~take & 0xFF));
          bw.byte((uint8_t)((~take >> 8) & 0xFF));
          bw.bytes(base + p, take);
          p += take;
          final_emitted |= lb;
        }
      }
      for (int i = 0; i < L_CODES; i++) w->llf_prev[i] = w->llf_cur[i];
      for (int i = 0; i < D_CODES; i++) w->df_prev[i] = w->df_cur[i];
      have_prev = true;
    }
    if (last && !final_emitted) {
      // a match overshot its segment to the end of the input after the
      // header had BFINAL 0: an empty final static block closes the stream
      bw.put((1u << 1) + 1u, 3);
      bw.put64(kT.s_llc[256], kT.s_lll[256]);
    }
  }

  EX_DEV void seam() {  // byte-align with an empty stored block
    bw.put(0, 1);
    bw.put(0, 2);
    bw.align();
    bw.byte(0x00);
    bw.byte(0x00);
    bw.byte(0xff);
    bw.byte(0xff);
  }

  // level 0 and QUICK (levels 1-9 and MEDIUM take the pieces' resolve and
  // chase)
  EX_DEV void run(bool final_flag) {
    if (level == QUICK_LEVEL) {
      run_quick(final_flag);
      if (!final_flag)
        seam();
      else
        bw.align();
      return;
    }
    // level 0: the ample-output stored schedule
    if (final_flag) {
      long long pos = dict_len;
      for (;;) {
        const long long take = total - pos < 65535 ? total - pos : 65535;
        const bool lastb = take == total - pos;
        emit_stored(pos, take, lastb);
        pos += take;
        if (lastb) break;
      }
    } else {
      emit_stored(dict_len, n, false);
      bw.align();
      seam();
    }
  }
};

// one chunk: m = its meta row; returns its length, *status 0 or kOverflow
EX_DEV long long deflate_one(const uint8_t* in, const long long* m, int level, uint8_t* out,
                             Work* w, Work4* w4, int lane, int lanes, int* status) {
  const long long start = m[0], n = m[1], dict_len = m[2];
  const bool final_flag = m[3] != 0;
  for (int i = lane; i < HASH_SIZE; i += lanes) w->head[i] = 0;
  for (int i = lane; i < WSIZE; i += lanes) w->prevd[i] = 0;
  if (w4) {
    for (int i = lane; i < (1 << 16); i += lanes) w4->head4[i] = 0;
    for (int i = lane; i < WSIZE; i += lanes) w4->prevd4[i] = 0;
  }
  warp_sync();
  Deflater d;
  d.base = in + start - dict_len;
  d.dict_len = dict_len;
  d.n = n;
  d.total = dict_len + n;
  d.level = level;
  d.klevel = level >= MEDIUM_BASE && level <= MEDIUM_BASE + 2 ? level - MEDIUM_BASE + 5
             : level >= 0 && level <= 9                         ? level
                                                                : 6;
  d.lane = lane;
  d.w = w;
  d.w4 = w4;
  d.bw = BitW{out + m[4], m[5], 0, 0, 0, lane};
  d.ns = 0;
  d.block_start = dict_len;
  d.match_length = d.prev_length = MIN_MATCH - 1;
  d.match_start = d.prev_start = 0;
  d.match_available = false;
  d.spos = 0;
  d.sh = 0;
  d.shv = false;
  d.started = false;
  d.med_next_start = d.med_next_strstart = d.med_next_orgstart = 0;
  d.med_next_len = 0;
  d.hist = nullptr;
  d.ewords = nullptr;
  d.map = nullptr;
  d.ldh = nullptr;
  d.map_b0 = d.tops = d.lives = 0;
  d.four = false;
  d.front = 0;
  d.clk_flush = d.clk_emit = 0;
  d.run(final_flag);
  warp_sync();
  *status = d.bw.wpos > d.bw.cap ? kOverflow : 0;
  return d.bw.wpos;
}

EX_HD bool needs_work4(int level) {
  return level == QUICK_LEVEL || (level >= MEDIUM_BASE && level <= MEDIUM_BASE + 2);
}

// ---------------------------------------------------------------------------
// DS: the Deflater paused and resumed, native's DefStream::pump
// ---------------------------------------------------------------------------

// DS's record, int64 a field (the wrapper's D_* names): the scan state
// between pumps, the flush and the room of this pump, its results, and
// MEDIUM's pre-found next match
enum {
  D_TOTAL, D_SPOS, D_BLOCK_START, D_NS, D_MATCH_LENGTH, D_PREV_LENGTH, D_MATCH_START,
  D_PREV_START, D_MATCH_AVAILABLE, D_SH, D_SHV, D_STARTED, D_BW_BUF, D_BW_CNT,
  D_INSERT_PENDING, D_LEVEL, D_FLUSH, D_OUT_CAP, D_OUT_LEN, D_STATUS, D_FINISHED,
  D_MED_NEXT_START, D_MED_NEXT_STRSTART, D_MED_NEXT_ORGSTART, D_MED_NEXT_LEN,
  D_INS_LO, D_INS_HI,  // levels 1-9: the positions [lo, hi) the pump inserted, for ds_tables
                       // (MEDIUM: hi, the parse's frontier, carries to the next pump)
  D_MED_STALE,  // MEDIUM: a FULL_FLUSH left head4 stale; the pumps run the serial inserts
  kDRec = 28
};
constexpr int kMisuse = -2;

// one pump of a stream: `data` holds positions [0, rec[D_TOTAL]) (the
// window, the unflushed block and this pump's input; position 0 is NIL),
// `w` the handle's Work (hash chains, the block's symbols; at MEDIUM
// followed by Work4, the 4-byte-hash chains), `out` the pump's room.
// Flush 0 none, 2 sync, 3 full, 4 finish. Levels 1-9 and MEDIUM4-6
// (11-13), as native's handle takes them.
// At levels 1-9 `slots` holds the resolve's slots of positions [spos,
// spos + n_slots) and `deltas` the static chains' deltas from the pump's
// first insert (D_INS_LO); the chase leaves the inserted range's end in
// D_INS_HI for ds_tables. At levels 1-3 and MEDIUM `deltas` are the chains
// the slots' walks took (the assumed map's positions left out; `span` of
// them), `map` the skip map from D_INS_LO rounded down to 32 (the map the
// slots assumed; the chase leaves the parse's own in it), and `dlist` (as
// deltas) and `ldh` int32 [32768] the chase's scratch; stats (null, or
// int64 [2]) adds the loop tops and the live walks. MEDIUM's first insert
// is the last pump's frontier (D_INS_HI); once a FULL_FLUSH has left head4
// stale (D_MED_STALE), a pump takes no slots and runs native's serial
// inserts and walks (run_medium): a stale head can put a position of
// another hash, or one never inserted, on a chain, which the static chains
// do not model.
EX_DEV void ds_pump(long long* r, const uint8_t* data, Work* w, uint8_t* out, int lane,
                    int lanes, const Slot* slots, long long n_slots, const uint16_t* deltas,
                    uint16_t* dlist, long long span, uint32_t* map, int32_t* ldh, Slot* stage,
                    uint32_t* hist, uint64_t* ewords, long long* clk, long long* stats) {
  const int level = (int)r[D_LEVEL], flush = (int)r[D_FLUSH];
  const bool medium = medium_level(level);
  if (r[D_FINISHED] || (!medium && (level < 1 || level > 9))) {  // native's -2
    warp_sync();
    if (lane == 0) {
      r[D_STATUS] = kMisuse;
      r[D_OUT_LEN] = 0;
      r[D_INS_LO] = r[D_INS_HI] = 0;
    }
    return;
  }
  const bool serial = medium && r[D_MED_STALE] != 0;  // MEDIUM's serial inserts
  const bool fixed = !serial;                          // the slots' chase
#ifdef __CUDACC__
  const long long clk0 = clock64();
#endif
  Deflater d;
  d.base = data;
  d.dict_len = 0;
  d.total = d.n = r[D_TOTAL];
  d.level = level;
  d.klevel = knob_level(level);
  d.lane = lane;
  d.w = w;
  d.w4 = medium ? (Work4*)((uint8_t*)w + kWorkBytes) : nullptr;
  d.bw = BitW{out, r[D_OUT_CAP], 0, (uint64_t)r[D_BW_BUF], (int)r[D_BW_CNT], lane};
  d.ns = r[D_NS];
  d.block_start = r[D_BLOCK_START];
  d.match_length = (int)r[D_MATCH_LENGTH];
  d.prev_length = (int)r[D_PREV_LENGTH];
  d.match_start = r[D_MATCH_START];
  d.prev_start = r[D_PREV_START];
  d.match_available = r[D_MATCH_AVAILABLE] != 0;
  d.spos = r[D_SPOS];
  d.sh = (uint32_t)r[D_SH];
  d.shv = r[D_SHV] != 0;
  d.started = r[D_STARTED] != 0;
  d.med_next_start = r[D_MED_NEXT_START];
  d.med_next_strstart = r[D_MED_NEXT_STRSTART];
  d.med_next_orgstart = r[D_MED_NEXT_ORGSTART];
  d.med_next_len = (int)r[D_MED_NEXT_LEN];
  d.hist = hist;
  d.ewords = ewords;
  d.map = map;
  d.ldh = ldh;
  d.four = medium;
  d.front = d.started ? r[D_INS_HI] : 0;
  d.tops = d.lives = 0;
  d.clk_flush = d.clk_emit = 0;
  long long total = d.total;
  long long insert_pending = r[D_INSERT_PENDING];
  d.start_scan();
  const long long ins_lo = medium ? d.front : d.spos - insert_pending;
  d.map_b0 = ins_lo & ~31LL;
  if (fixed) {
    d.ch = Chains{deltas, ins_lo, medium ? d.w4->prevd4 : w->prevd};
    d.sl = SlotSrc{slots, d.spos, n_slots, stage, -1};
    d.dlist = dlist;
    d.dlist_c0 = ins_lo;
    d.dlist_c1 = ins_lo + span;
  }
  // zlib's `insert`: the <= 2 tail positions a flush could not hash enter
  // the chains once the new input completes their strings (native
  // retro_insert, fill_window's role); the static chains hold them already
  const long long lookahead = total - d.spos;
  if (insert_pending && lookahead + insert_pending >= MIN_MATCH) {
    while (insert_pending) {
      insert_pending--;
      if (lookahead + insert_pending < MIN_MATCH) break;
    }
  }
  const long long limit =
      flush ? total : (total >= MIN_LOOKAHEAD ? total - (MIN_LOOKAHEAD - 1) : 0);
  if (serial)
    d.run_medium(limit);
  else if (medium)
    d.run_medium_slots(limit, false, map_words(d.map_b0, total));
  else if (kT.slow[level])
    d.run_slow(limit);
  else
    d.run_greedy(limit);
  // the inserted positions end where the scan stopped, short of the last
  // two (their strings end past the data), never below the first insert;
  // MEDIUM's at the parse's frontier
  long long ins_hi = d.spos < total - (MIN_MATCH - 1) ? d.spos : total - (MIN_MATCH - 1);
  if (medium) ins_hi = d.front;
  if (ins_hi < ins_lo) ins_hi = ins_lo;
  bool finished = false;
  bool stale = serial;
  if (flush) {
    if (!medium) d.emit_trailing_literal();
    insert_pending = d.spos < MIN_MATCH - 1 ? d.spos : MIN_MATCH - 1;
    if (flush == 4) {
      d.flush_block(true, total);
      d.bw.align();
      finished = true;
    } else {
      if (d.ns != 0 || d.block_start < total) d.flush_block(false, total);
      d.seam();
      // FULL_FLUSH: the 3-byte hash cleared, the window restarts; as
      // native, MEDIUM's head4 and next match stay (a stale head's delta
      // wraps in its u16 slot, and every candidate's bytes are compared)
      if (flush == 3) {
        // levels 1-9: ds_tables clears the heads after it writes the chains
        if (medium) {
          for (int i = lane; i < HASH_SIZE; i += lanes) w->head[i] = 0;
          stale = true;
        }
        total = 0;
        d.spos = 0;
        d.block_start = 0;
        d.shv = false;
        insert_pending = 0;
      }
    }
  }
  warp_sync();
  if (lane == 0) {
    r[D_TOTAL] = total;
    r[D_SPOS] = d.spos;
    r[D_BLOCK_START] = d.block_start;
    r[D_NS] = d.ns;
    r[D_MATCH_LENGTH] = d.match_length;
    r[D_PREV_LENGTH] = d.prev_length;
    r[D_MATCH_START] = d.match_start;
    r[D_PREV_START] = d.prev_start;
    r[D_MATCH_AVAILABLE] = d.match_available ? 1 : 0;
    r[D_SH] = d.sh;
    r[D_SHV] = d.shv ? 1 : 0;
    r[D_STARTED] = d.started ? 1 : 0;
    r[D_BW_BUF] = (long long)d.bw.buf;
    r[D_BW_CNT] = d.bw.cnt;
    r[D_INSERT_PENDING] = insert_pending;
    r[D_OUT_LEN] = d.bw.wpos;
    r[D_STATUS] = d.bw.wpos > d.bw.cap ? kOverflow : 0;
    r[D_FINISHED] = finished ? 1 : 0;
    r[D_MED_NEXT_START] = d.med_next_start;
    r[D_MED_NEXT_STRSTART] = d.med_next_strstart;
    r[D_MED_NEXT_ORGSTART] = d.med_next_orgstart;
    r[D_MED_NEXT_LEN] = d.med_next_len;
    r[D_INS_LO] = fixed ? ins_lo : 0;
    r[D_INS_HI] = fixed ? ins_hi : 0;
    r[D_MED_STALE] = stale ? 1 : 0;
    if (stats) {
      stats[0] += d.tops;
      stats[1] += d.lives;
    }
#ifdef __CUDACC__
    if (clk) {
      clk[0] = clock64() - clk0;
      clk[1] = d.clk_flush;
      clk[2] = d.clk_emit;
    }
#endif
  }
#ifndef __CUDACC__
  (void)clk;
#endif
}

// after a DS pump at levels 1-9 and MEDIUM (positions [D_INS_LO, D_INS_HI) inserted
// but those the parse's map `sk` skips, deltas from D_INS_LO over the
// inserted positions alone): the handle's head and prevd as zlib's serial
// inserts leave them. head takes each inserted position by atomicMax (a
// head is an older position); a ring slot takes the delta of the last
// inserted position it holds and keeps its value where the pump inserted
// none (a skipped position's slot is untouched); FULL_FLUSH clears the
// heads, after the inserts, as zlib does.
// MEDIUM: head4 and prevd4 (Work4, after Work), FULL_FLUSH clearing
// neither, as native.
EX_DEV void ds_tables_range(const long long* r, const uint8_t* data, Work* w,
                            const uint16_t* deltas, long long i0, long long step, const Skip& sk) {
  if (r[D_STATUS] == kMisuse) return;
  const long long lo = r[D_INS_LO], hi = r[D_INS_HI];
  const bool four = medium_level((int)r[D_LEVEL]);
  const bool clear = r[D_FLUSH] == 3 && !four;
  Work4* w4 = (Work4*)((uint8_t*)w + kWorkBytes);
  int32_t* head = four ? w4->head4 : w->head;
  uint16_t* prevd = four ? w4->prevd4 : w->prevd;
  for (long long p = lo + i0; p < hi; p += step) {
    if (sk.on(p)) continue;
    if (!clear) atomic_max_i32(head + (four ? hash4_at(data, p) : hash_at(data, p)), (int32_t)p);
    bool latest = true;
    for (long long q = p + WSIZE; q < hi && latest; q += WSIZE) latest = sk.on(q);
    if (latest) prevd[p & (WSIZE - 1)] = deltas[p - lo];
  }
}

// FULL_FLUSH at levels 1-9: the heads cleared once ds_tables_range has
// written the chains (it writes no head then)
EX_DEV void ds_tables_clear(const long long* r, Work* w, long long i0, long long step) {
  if (r[D_STATUS] == kMisuse || r[D_FLUSH] != 3) return;
  for (long long h = i0; h < HASH_SIZE; h += step) w->head[h] = 0;
}

// a DS pump's ranges at levels 1-9 and MEDIUM, from its record before the
// pump: g[0] the first position it inserts (spos less zlib's pending
// `insert`; MEDIUM's frontier), g[1] the end of the positions it can
// insert (the deltas cover [g[0], g[1])), g[2] spos and g[3] the scan's
// limit (the slots cover [g[2], slot_end), at MEDIUM past the limit)
EX_HD void ds_ranges(const long long* r, long long* g) {
  const long long total = r[D_TOTAL];
  const bool medium = medium_level((int)r[D_LEVEL]);
  const long long s = r[D_STARTED] ? r[D_SPOS] : 0;
  const long long a = !r[D_STARTED] ? 0 : medium ? r[D_INS_HI] : s - r[D_INSERT_PENDING];
  const long long limit =
      r[D_FLUSH] ? total : (total >= MIN_LOOKAHEAD ? total - (MIN_LOOKAHEAD - 1) : 0);
  const long long we = limit > s ? limit : s;
  // the scan stops before limit + MAX_MATCH - 1; no insert reaches total - 2
  // (MEDIUM's, whose hash4 reads 4 bytes, total - 3)
  long long c1 = limit + MAX_MATCH > s ? limit + MAX_MATCH : s;
  const long long end = total - (medium ? WANT_MIN - 1 : MIN_MATCH - 1);
  if (c1 > end) c1 = end;
  if (c1 < a) c1 = a;
  g[0] = a;
  g[1] = c1;
  g[2] = s;
  g[3] = we;
}

// levels 1-3, between two rounds of the resolve: the dry parse of a piece.
// zlib's greedy parse follows the piece's slots unchecked (p += M, or p++)
// from the chase's position (the record's spos for EX, the piece's start
// for DS, whose `recs` is null) to the piece's end, and writes the map the
// next round assumes from start to the end of the word holding min(e +
// MAX_MATCH, total) - 1: a long match's interior, and every interior of a
// match ending within MIN_MATCH of total, set; the rest clear. The bits
// below start (the parse's own) stay. The lanes clear the map; the parse
// reads the slots staged as the chase does and gathers a word's bits in a
// register, stored once the parse leaves the word.
EX_DEV void dry_medium(const uint8_t* in, const long long* pr, int level, const long long* recs,
                       const Slot* slots, uint32_t* bits, long long bit_stride, Slot* stage,
                       int lane);

EX_DEV void dry_piece(const uint8_t* in, const long long* pr, int level, const long long* recs,
                      const Slot* slots, uint32_t* bits, long long bit_stride, Slot* stage,
                      int lane, int lanes) {
  if (medium_level(level)) {
    dry_medium(in, pr, level, recs, slots, bits, bit_stride, stage, lane);
    return;
  }
  const long long total = pr[P_TOTAL], b0 = pr[P_LO] & ~31LL, e = pr[P_E];
  uint32_t* map = bits + pr[P_WORK] * bit_stride;
  long long start = pr[P_S];
  if (recs && recs[pr[P_WORK] * kDRec + D_SPOS] > start) start = recs[pr[P_WORK] * kDRec + D_SPOS];
  const long long stop = e + MAX_MATCH < total ? e + MAX_MATCH : total;
  if (start >= stop) return;
  long long aw = (start - b0) >> 5;  // the word in acc
  uint32_t acc = map[aw] & ((1u << ((start - b0) & 31)) - 1u);
  warp_sync();
  for (long long w = aw + lane; w <= (stop - 1 - b0) >> 5; w += lanes) map[w] = 0u;
  warp_sync();
  const int lazy = kT.lazy[level];
  SlotSrc src{slots + pr[P_SOFF], pr[P_S], e - pr[P_S], stage, -1};
  long long p = start;
  while (p < e) {
    if (p + MIN_MATCH <= total) {
      const uint32_t v = src.at(p, lane).full;
      if (v & 0x7fff) {
        const long long m = v >> 15;
        const long long end = p + (m < total - p ? m : total - p);
        if (!(end - p <= lazy && total - end >= MIN_MATCH)) {  // set [p + 1, end)
          const long long ra = p + 1 - b0, re = end - b0;
          for (long long w = ra >> 5; w <= (re - 1) >> 5; w++) {
            if (w != aw) {
              if (acc && lane == 0) map[aw] = acc;
              aw = w;
              acc = 0;
            }
            const long long wb = w << 5;
            const int lo = ra > wb ? (int)(ra - wb) : 0;
            const int hi = re < wb + 32 ? (int)(re - wb) : 32;
            acc |= (hi == 32 ? kFull : (1u << hi) - 1u) & ~((1u << lo) - 1u);
          }
        }
        p = end;
        continue;
      }
    }
    p++;
  }
  if (acc && lane == 0) map[aw] = acc;
}

// MEDIUM, between two rounds of the resolve: the dry parse of a piece,
// run_medium_slots with every slot taken unchecked and no output, resumed
// from the record (EX's chunk's, or DS's; a record not started starts at
// the piece's P_S, which is then the chunk's dict_len or DS's 0) to the
// piece's scan end. Its decisions overwrite the map from the record's
// frontier on; the bits past the last one keep the round's.
EX_DEV void dry_medium(const uint8_t* in, const long long* pr, int level, const long long* recs,
                       const Slot* slots, uint32_t* bits, long long bit_stride, Slot* stage,
                       int lane) {
  const long long* r = recs + (size_t)pr[P_WORK] * kDRec;
  Deflater d;
  d.base = in + pr[P_BASE];
  d.total = pr[P_TOTAL];
  d.dict_len = pr[P_S];
  d.n = d.total - d.dict_len;
  d.level = level;
  d.klevel = knob_level(level);
  d.lane = lane;
  d.w = nullptr;
  d.w4 = nullptr;
  d.four = true;
  d.started = r[D_STARTED] != 0;
  d.spos = r[D_SPOS];
  d.front = r[D_INS_HI];
  d.med_next_start = r[D_MED_NEXT_START];
  d.med_next_strstart = r[D_MED_NEXT_STRSTART];
  d.med_next_orgstart = r[D_MED_NEXT_ORGSTART];
  d.med_next_len = d.started ? (int)r[D_MED_NEXT_LEN] : 0;
  d.map = bits + pr[P_WORK] * bit_stride;
  d.map_b0 = pr[P_LO] & ~31LL;
  d.ldh = nullptr;
  d.dlist = nullptr;
  d.tops = d.lives = 0;
  d.sl = SlotSrc{slots + pr[P_SOFF], pr[P_S], slot_end(pr, true) - pr[P_S], stage, -1};
  d.run_medium_slots(pr[P_E], true, bit_stride ? bit_stride : map_words(d.map_b0, d.total));
}

// EX at levels 1-9 and MEDIUM: one piece of one chunk, resumed from the
// chunk's record (a first piece starts the Deflater as deflate_one does;
// MEDIUM's carried next match and frontier in the record too) and chased
// to the piece's end, or to the chunk's and then ended as run() ends it; at
// levels 1-3 and MEDIUM `deltas` are the chains the slots' walks took, `dlist` (as
// deltas) and ldh (in the chunk's Work head, which the static chains
// leave unused) the chase's scratch, the chunk's skip
// map is read and left in `bits` (bit_stride words a chunk), and stats
// (null, or int64 [2]) adds the loop tops and the live walks
EX_DEV void chase_piece(const uint8_t* in, const long long* meta, const long long* pr, int level,
                        uint8_t* out, long long* lens, int* status, long long* recs,
                        uint8_t* scratch, long long stride, const Slot* slots,
                        const uint16_t* deltas, uint16_t* dlist, uint32_t* bits,
                        long long bit_stride, Slot* stage, uint32_t* hist,
                        uint64_t* ewords,
                        int lane, long long* clk, long long* stats) {
#ifdef __CUDACC__
  const long long clk0 = clock64();
#endif
  const long long k = pr[P_CHUNK];
  const long long* m = meta + (size_t)k * kMeta;
  const long long start = m[0], n = m[1], dict_len = m[2];
  long long* r = recs + (size_t)pr[P_WORK] * kDRec;
  const bool medium = medium_level(level);
  Deflater d;
  d.base = in + start - dict_len;
  d.dict_len = dict_len;
  d.n = n;
  d.total = dict_len + n;
  d.level = level;
  d.klevel = knob_level(level);
  d.lane = lane;
  d.w = (Work*)(scratch + (size_t)pr[P_WORK] * (size_t)stride);
  d.w4 = nullptr;
  d.four = medium;
  d.med_next_start = d.med_next_strstart = d.med_next_orgstart = 0;
  d.med_next_len = 0;
  d.front = dict_len;
  if (pr[P_S] == dict_len) {  // the chunk's first piece
    d.bw = BitW{out + m[4], m[5], 0, 0, 0, lane};
    d.ns = 0;
    d.block_start = dict_len;
    d.match_length = d.prev_length = MIN_MATCH - 1;
    d.match_start = d.prev_start = 0;
    d.match_available = false;
    d.spos = 0;
    d.sh = 0;
    d.shv = false;
    d.started = false;
  } else {
    d.bw = BitW{out + m[4], m[5], r[D_OUT_LEN], (uint64_t)r[D_BW_BUF], (int)r[D_BW_CNT], lane};
    d.ns = r[D_NS];
    d.block_start = r[D_BLOCK_START];
    d.match_length = (int)r[D_MATCH_LENGTH];
    d.prev_length = (int)r[D_PREV_LENGTH];
    d.match_start = r[D_MATCH_START];
    d.prev_start = r[D_PREV_START];
    d.match_available = r[D_MATCH_AVAILABLE] != 0;
    d.spos = r[D_SPOS];
    d.sh = (uint32_t)r[D_SH];
    d.shv = r[D_SHV] != 0;
    d.started = r[D_STARTED] != 0;
    d.med_next_start = r[D_MED_NEXT_START];
    d.med_next_strstart = r[D_MED_NEXT_STRSTART];
    d.med_next_orgstart = r[D_MED_NEXT_ORGSTART];
    d.med_next_len = (int)r[D_MED_NEXT_LEN];
    d.front = r[D_INS_HI];
  }
  d.hist = hist;
  d.ewords = ewords;
  d.map = bits ? bits + pr[P_WORK] * bit_stride : nullptr;
  d.map_b0 = pr[P_LO] & ~31LL;
  d.ldh = d.w->head;
  d.tops = d.lives = 0;
  d.clk_flush = d.clk_emit = 0;
  d.ch = Chains{deltas + pr[P_DOFF], pr[P_C0], nullptr};
  d.dlist = dlist ? dlist + pr[P_DOFF] : nullptr;
  d.dlist_c0 = pr[P_C0];
  d.dlist_c1 = pr[P_C1];
  d.sl = SlotSrc{slots + pr[P_SOFF], pr[P_S], slot_end(pr, medium) - pr[P_S], stage, -1};
  const bool last = pr[P_LAST] != 0;
  if (medium)
    d.run_medium_slots(last ? d.total : pr[P_E], false,
                       bit_stride ? bit_stride : map_words(d.map_b0, d.total));
  else if (kT.slow[level])
    d.run_slow(last ? d.total : pr[P_E]);
  else
    d.run_greedy(last ? d.total : pr[P_E]);
  if (last) {
    d.emit_trailing_literal();
    if (m[3]) {
      d.flush_block(true, d.total);
      d.bw.align();
    } else {
      if (d.ns != 0 || d.block_start < d.total) d.flush_block(false, d.total);
      d.seam();
    }
  }
  warp_sync();
  if (lane == 0) {
    if (last) {
      lens[k] = d.bw.wpos;
      status[k] = d.bw.wpos > d.bw.cap ? kOverflow : 0;
    } else {
      r[D_SPOS] = d.spos;
      r[D_BLOCK_START] = d.block_start;
      r[D_NS] = d.ns;
      r[D_MATCH_LENGTH] = d.match_length;
      r[D_PREV_LENGTH] = d.prev_length;
      r[D_MATCH_START] = d.match_start;
      r[D_PREV_START] = d.prev_start;
      r[D_MATCH_AVAILABLE] = d.match_available ? 1 : 0;
      r[D_SH] = d.sh;
      r[D_SHV] = d.shv ? 1 : 0;
      r[D_STARTED] = d.started ? 1 : 0;
      r[D_BW_BUF] = (long long)d.bw.buf;
      r[D_BW_CNT] = d.bw.cnt;
      r[D_OUT_LEN] = d.bw.wpos;
      r[D_MED_NEXT_START] = d.med_next_start;
      r[D_MED_NEXT_STRSTART] = d.med_next_strstart;
      r[D_MED_NEXT_ORGSTART] = d.med_next_orgstart;
      r[D_MED_NEXT_LEN] = d.med_next_len;
      r[D_INS_HI] = d.front;
    }
    if (stats) {
#ifdef __CUDACC__
      atomicAdd((unsigned long long*)stats, (unsigned long long)d.tops);
      atomicAdd((unsigned long long*)stats + 1, (unsigned long long)d.lives);
#else
      stats[0] += d.tops;
      stats[1] += d.lives;
#endif
    }
#ifdef __CUDACC__
    if (clk) {
      clk[0] = clock64() - clk0;
      clk[1] = d.clk_flush;
      clk[2] = d.clk_emit;
    }
#endif
  }
#ifndef __CUDACC__
  (void)clk;
#endif
}

// a position's slot at `level`: run_slow's two walks (4-9), the greedy walk
// and its reach (1-3), MEDIUM's walk and its reach
EX_DEV Slot resolve_one(const uint8_t* base, long long total, long long p, const Chains& ch,
                        int level, int* visited) {
  if (medium_level(level))
    return resolve_greedy(base, total, p, ch, knob_level(level), WANT_MIN, visited);
  return kT.slow[level] ? resolve_at(base, total, p, ch, level, visited)
                        : resolve_greedy(base, total, p, ch, level, MIN_MATCH, visited);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
exact_deflate(const uint8_t* __restrict__ in, const long long* __restrict__ meta, int chunks,
              int level, uint8_t* __restrict__ out, long long* __restrict__ lens,
              int* __restrict__ status, uint8_t* __restrict__ scratch, long long stride) {
  const int lane = threadIdx.x;
  uint8_t* slot = scratch + (size_t)blockIdx.x * (size_t)stride;
  Work* w = (Work*)slot;
  Work4* w4 = needs_work4(level) ? (Work4*)(slot + kWorkBytes) : nullptr;
  for (int k = blockIdx.x; k < chunks; k += gridDim.x) {
    int st = 0;
    const long long len = deflate_one(in, meta + (size_t)k * kMeta, level, out, w, w4, lane, 32, &st);
    if (lane == 0) {
      lens[k] = len;
      status[k] = st;
    }
    __syncwarp();
  }
}

// DS: one pump of one handle, one warp
__global__ void __launch_bounds__(32)
dstream_pump(long long* __restrict__ rec, const uint8_t* __restrict__ data,
             uint8_t* __restrict__ work, uint8_t* __restrict__ out, const Slot* __restrict__ slots,
             long long n_slots, const uint16_t* __restrict__ deltas,
             uint16_t* __restrict__ dlist, long long span, uint32_t* __restrict__ bits,
             long long* __restrict__ clk, long long* __restrict__ stats) {
  extern __shared__ int32_t ldh[];  // levels 1-3 and MEDIUM: HASH_SIZE entries
  __shared__ Slot stage[2 * kStage];
  __shared__ uint32_t hist[L_CODES + D_CODES];
  __shared__ uint64_t ewords[kEmitWords];
  ds_pump(rec, data, (Work*)work, out, threadIdx.x, 32, slots, n_slots, deltas, dlist, span, bits,
          ldh, stage, hist, ewords, clk, stats);
}

// the resolve, part 1: a tile of a piece's deltas a block; `skip` (null,
// or a skip map a piece at P_WORK * bit_stride from its P_LO rounded down
// to 32) leaves positions out of the chains; `four`: MEDIUM's hash4 chains
__global__ void __launch_bounds__(kChainThreads)
build_chains(const uint8_t* __restrict__ in, const long long* __restrict__ pieces, int P,
             const int32_t* __restrict__ head_old, uint16_t* __restrict__ deltas,
             const uint32_t* __restrict__ skip, long long bit_stride, int four) {
  extern __shared__ int32_t table[];  // HASH_SIZE last occurrences, then tile_pass's
  const long long* pr = pieces + (size_t)find_piece(pieces, P, P_CBLK, blockIdx.x) * kPiece;
  const long long t0 = pr[P_C0] + (blockIdx.x - pr[P_CBLK]) * (long long)kTile;
  const long long t1 = t0 + kTile < pr[P_C1] ? t0 + kTile : pr[P_C1];
  tile_chains(in + pr[P_BASE], pr, t0, t1, head_old, table, (uint32_t*)(table + HASH_SIZE),
              deltas, threadIdx.x, blockDim.x,
              Skip{skip ? skip + pr[P_WORK] * bit_stride : nullptr, pr[P_LO] & ~31LL}, four != 0);
}

// the resolve, part 2: a thread a position of every piece's slots [s,
// slot_end); count (null, or one uint64) sums the candidates the walks
// compare
__global__ void __launch_bounds__(kWalkThreads)
resolve_walk(const uint8_t* __restrict__ in, const long long* __restrict__ pieces, int P,
             int level, const uint16_t* __restrict__ deltas, const uint16_t* __restrict__ ring,
             Slot* __restrict__ slots, unsigned long long* __restrict__ count) {
  const long long* pr = pieces + (size_t)find_piece(pieces, P, P_WBLK, blockIdx.x) * kPiece;
  const long long p = pr[P_S] + (blockIdx.x - pr[P_WBLK]) * (long long)kWalkThreads + threadIdx.x;
  int visited = 0;
  if (p < slot_end(pr, medium_level(level))) {
    const Chains ch{deltas + pr[P_DOFF], pr[P_C0], ring};
    slots[pr[P_SOFF] + p - pr[P_S]] =
        resolve_one(in + pr[P_BASE], pr[P_TOTAL], p, ch, level, &visited);
  }
  if (count) {
    const unsigned sum = __reduce_add_sync(kFull, (unsigned)visited);
    if ((threadIdx.x & 31) == 0 && sum) atomicAdd(count, (unsigned long long)sum);
  }
}

// levels 1-3 and MEDIUM: the dry parse, a piece a block of one warp
__global__ void __launch_bounds__(32)
exact_dry(const uint8_t* __restrict__ in, const long long* __restrict__ pieces, int level,
          const long long* __restrict__ recs, const Slot* __restrict__ slots,
          uint32_t* __restrict__ bits, long long bit_stride) {
  __shared__ Slot stage[2 * kStage];
  dry_piece(in, pieces + (size_t)blockIdx.x * kPiece, level, recs, slots, bits, bit_stride, stage,
            threadIdx.x, 32);
}

// EX's chase at levels 1-9 and MEDIUM: a piece a block of one warp
__global__ void __launch_bounds__(32)
exact_chase(const uint8_t* __restrict__ in, const long long* __restrict__ meta,
            const long long* __restrict__ pieces, int level, uint8_t* __restrict__ out,
            long long* __restrict__ lens, int* __restrict__ status, long long* __restrict__ recs,
            uint8_t* __restrict__ scratch, long long stride, const Slot* __restrict__ slots,
            const uint16_t* __restrict__ deltas, uint16_t* __restrict__ dlist,
            uint32_t* __restrict__ bits, long long bit_stride, long long* __restrict__ clk,
            long long* __restrict__ stats) {
  __shared__ Slot stage[2 * kStage];
  __shared__ uint32_t hist[L_CODES + D_CODES];
  __shared__ uint64_t ewords[kEmitWords];
  chase_piece(in, meta, pieces + (size_t)blockIdx.x * kPiece, level, out, lens, status, recs,
              scratch, stride, slots, deltas, dlist, bits, bit_stride, stage, hist, ewords,
              threadIdx.x, clk ? clk + 3 * (size_t)blockIdx.x : nullptr, stats);
}

// DS after a pump at levels 1-9 and MEDIUM: the handle's head and prevd
// (head4 and prevd4); `bits` (null at 4-9) the parse's skip map from
// D_INS_LO rounded down to 32
__global__ void __launch_bounds__(kTableThreads)
ds_tables(const long long* __restrict__ rec, const uint8_t* __restrict__ data,
          uint8_t* __restrict__ work, const uint16_t* __restrict__ deltas,
          const uint32_t* __restrict__ bits) {
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  ds_tables_range(rec, data, (Work*)work, deltas, i0, step, Skip{bits, rec[D_INS_LO] & ~31LL});
  ds_tables_clear(rec, (Work*)work, i0, step);
}

int g_tables_ready[64];
// each device's SMs and shared memory an SM, exact_chase's shared memory
// a block (the runtime's reserved KB included)
int g_sms[64], g_sm_smem[64], g_chase_smem;

// RFC 1951's tables and the LEVELS rows in the current device's constant
// memory, build_chains's shared memory past 48 KB and the chases' L1, once
// a device
int ensure_tables() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_tables_ready[dev]) {
    Tables t;
    make_tables(&t);
    err = cudaMemcpyToSymbol(kT, &t, sizeof(Tables));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_sm_smem[dev], cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, exact_chase);
    if (err != cudaSuccess) return (int)err;
    g_chase_smem = (int)fa.sharedSizeBytes + 1024;
    err = cudaFuncSetAttribute(build_chains, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChainSmem);
    if (err != cudaSuccess) return (int)err;
    // DS's few KB of shared memory leave L1 its most: its warp's hash
    // chains and Work are read through it (EX's chase sets its own at
    // each launch)
    err = cudaFuncSetAttribute(dstream_pump, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return (int)err;
    // levels 1-3: DS keeps each hash's last disagreement in shared memory
    err = cudaFuncSetAttribute(dstream_pump, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HASH_SIZE * (int)sizeof(int32_t));
    if (err != cudaSuccess) return (int)err;
    g_tables_ready[dev] = 1;
  }
  return 0;
}
#else
void ensure_host_tables() {
  static bool ready = false;
  if (!ready) {
    make_tables(&kT);
    ready = true;
  }
}

// the resolve on the host: every piece's deltas tile by tile (when
// `chains`; the positions `skip` names, a piece's at P_WORK * bit_stride,
// left out of the chains), then every slot (when `slots`), in order
void resolve_host(const uint8_t* in, const long long* pieces, int P, int level,
                  const int32_t* head_old, const uint16_t* ring, uint16_t* deltas, Slot* slots,
                  int32_t* table, const uint32_t* skip, long long bit_stride, bool chains) {
  for (int i = 0; chains && i < P; i++) {
    const long long* pr = pieces + (size_t)i * kPiece;
    const Skip sk{skip ? skip + pr[P_WORK] * bit_stride : nullptr, pr[P_LO] & ~31LL};
    for (long long t0 = pr[P_C0]; t0 < pr[P_C1]; t0 += kTile)
      tile_chains(in + pr[P_BASE], pr, t0, t0 + kTile < pr[P_C1] ? t0 + kTile : pr[P_C1],
                  head_old, table, nullptr, deltas, 0, 1, sk, medium_level(level));
  }
  for (int i = 0; slots && i < P; i++) {
    const long long* pr = pieces + (size_t)i * kPiece;
    const Chains ch{deltas + pr[P_DOFF], pr[P_C0], ring};
    int visited;
    for (long long p = pr[P_S]; p < slot_end(pr, medium_level(level)); p++)
      slots[pr[P_SOFF] + p - pr[P_S]] =
          resolve_one(in + pr[P_BASE], pr[P_TOTAL], p, ch, level, &visited);
  }
}

long long g_piece = 1LL << 22;  // the host build's piece, in positions
// the host build's rounds at levels 1-3 and at MEDIUM4-6, by level (the
// wrapper's ROUNDS, MEDIUM's taken whatever the slots); 1 at 4-9
constexpr int kHostRounds[4] = {0, 2, 2, 3};
constexpr int kHostMediumRounds[3] = {2, 2, 1};
int host_rounds(int level) {
  return greedy_level(level)  ? kHostRounds[level]
         : medium_level(level) ? kHostMediumRounds[level - MEDIUM_BASE]
                               : 1;
}

#endif


}  // namespace

// DS's record length in int64
extern "C" long long zrs_dstream_record_len() { return kDRec; }

// a piece row's length in int64
extern "C" long long zrs_exact_piece_len() { return kPiece; }

// the bytes of a slot of scratch a chunk needs at `level`
extern "C" long long zrs_exact_deflate_work_bytes(int level) {
  return (long long)(kWorkBytes + (needs_work4(level) ? kWork4Bytes : 0));
}

// ds_ranges of a record: int64 [4]
extern "C" void zrs_dstream_ranges(const void* rec, void* out) {
  ds_ranges((const long long*)rec, (long long*)out);
}

#ifdef __CUDACC__
// EX over `chunks` chunks of meta (int64 [chunks, 6]: start, len, dict_len,
// final, out_off, out_cap; the input bytes of a chunk are
// in[start - dict_len, start + len), its dictionary first), all at one
// level (0 or 10 QUICK; levels 1-9 and MEDIUM 11-13 take zrs_exact_resolve
// and zrs_exact_chase), on `slots` warps each with a slot of `stride` bytes
// of scratch; lens int64 [chunks], status int32 [chunks]
extern "C" int zrs_exact_deflate(const void* in, const void* meta, int chunks, int level, void* out,
                                 void* lens, void* status, void* scratch, int slots,
                                 long long stride, void* stream) {
  const int terr = ensure_tables();
  if (terr) return terr;
  if (resolved_level(level) || stride < zrs_exact_deflate_work_bytes(level))
    return (int)cudaErrorInvalidValue;
  if (chunks > 0 && slots > 0)
    exact_deflate<<<slots, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const long long*)meta, chunks, level, (uint8_t*)out,
        (long long*)lens, (int*)status, (uint8_t*)scratch, stride);
  return (int)cudaGetLastError();
}

// the resolve at levels 1-9 and MEDIUM over P pieces (int64 [P, kPiece]):
// deltas u16 (each piece's [c0, c1) at its doff), then slots (8 bytes a
// position of each piece's [s, slot_end) at its soff); chain_blocks and
// walk_blocks are the pieces' blocks in all (either 0: that part not run).
// head_old int32 [32768] (MEDIUM's head4 [65536]) and ring u16 [32768] are
// DS's handle tables (null for EX); count (null, or one uint64) takes the
// candidates the walks compare; bits (null, or the assumed skip maps of
// levels 1-3 and MEDIUM, a piece's at P_WORK * bit_stride words from its
// P_LO rounded down to 32) leaves the positions it skips out of the
// chains. build_chains, then resolve_walk (a thread a position).
extern "C" int zrs_exact_resolve(const void* in, const void* pieces, int P, int level,
                                 const void* head_old, const void* ring, void* deltas, void* slots,
                                 long long chain_blocks, long long walk_blocks, void* count,
                                 const void* bits, long long bit_stride, void* stream) {
  const int terr = ensure_tables();
  if (terr) return terr;
  if (!resolved_level(level) || P <= 0 || (bits && !mapped_level(level)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (chain_blocks > 0) {
    build_chains<<<(unsigned)chain_blocks, kChainThreads, kChainSmem, st>>>(
        (const uint8_t*)in, (const long long*)pieces, P, (const int32_t*)head_old,
        (uint16_t*)deltas, (const uint32_t*)bits, bit_stride, medium_level(level) ? 1 : 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (walk_blocks > 0)
    resolve_walk<<<(unsigned)walk_blocks, kWalkThreads, 0, st>>>(
        (const uint8_t*)in, (const long long*)pieces, P, level, (const uint16_t*)deltas,
        (const uint16_t*)ring, (Slot*)slots, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

// levels 1-3 and MEDIUM: the dry parse of P pieces after a round of the
// resolve, one block of one warp a piece; recs (EX's records; DS's own
// record at MEDIUM, null at 1-3) give each piece's start (MEDIUM: its scan
// state), and it writes the next round's map into bits; `in` the data
// (MEDIUM's fizzle compares bytes)
extern "C" int zrs_exact_dry(const void* in, const void* pieces, int P, int level,
                             const void* recs, const void* slots, void* bits,
                             long long bit_stride, void* stream) {
  const int terr = ensure_tables();
  if (terr) return terr;
  if (!mapped_level(level) || !bits || (medium_level(level) && (!recs || !in)))
    return (int)cudaErrorInvalidValue;
  if (P > 0)
    exact_dry<<<P, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const long long*)pieces, level, (const long long*)recs,
        (const Slot*)slots, (uint32_t*)bits, bit_stride);
  return (int)cudaGetLastError();
}

// EX's chase at levels 1-9 and MEDIUM: one block of one warp a piece (at
// most one piece of a chunk a launch), after the resolve of the same
// pieces. recs int64 [*, kDRec] and scratch (`stride` bytes each) hold
// each chunk's state between its pieces, at the piece's P_WORK; at levels
// 1-3 and MEDIUM `deltas`
// are the last round's chains, `dlist` (as deltas) the chase's scratch, and
// each chunk's skip map is read and left at bits + P_WORK * bit_stride; clk (null, or
// int64 [P, 3]) takes each piece's clock64 cycles: in all, in flush_block,
// and of those in emit_symbols; stats (null, or int64 [2]) adds the loop
// tops and the live walks.
extern "C" int zrs_exact_chase(const void* in, const void* meta, const void* pieces, int P,
                               int level, void* out, void* lens, void* status, void* recs,
                               void* scratch, long long stride, const void* slots,
                               const void* deltas, void* dlist, void* bits,
                               long long bit_stride, void* clk, void* stats, void* stream) {
  const int terr = ensure_tables();
  if (terr) return terr;
  if (!resolved_level(level) || stride < (long long)kWorkBytes ||
      (mapped_level(level) && (!bits || !dlist)))
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  // the shared memory the call's blocks need an SM (each a warp), the rest
  // L1, which holds each warp's Work and chains: L1's most would leave an
  // SM room for one chase
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  const long long per_sm = (P + g_sms[dev] - 1) / g_sms[dev];
  const long long pct = (100 * per_sm * g_chase_smem + g_sm_smem[dev] - 1) / g_sm_smem[dev];
  const cudaError_t cerr = cudaFuncSetAttribute(
      exact_chase, cudaFuncAttributePreferredSharedMemoryCarveout, pct < 100 ? (int)pct : 100);
  if (cerr != cudaSuccess) return (int)cerr;
  exact_chase<<<P, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const long long*)meta, (const long long*)pieces, level, (uint8_t*)out,
      (long long*)lens, (int*)status, (long long*)recs, (uint8_t*)scratch, stride,
      (const Slot*)slots, (const uint16_t*)deltas, (uint16_t*)dlist, (uint32_t*)bits, bit_stride,
      (long long*)clk, (long long*)stats);
  return (int)cudaGetLastError();
}

// DS over one handle: rec int64 [kDRec], data uint8 (rec[D_TOTAL] bytes),
// work uint8 [zrs_exact_deflate_work_bytes(level)] (Work, head int32[32768]
// first; at MEDIUM then Work4), out uint8 (rec[D_OUT_CAP] bytes of room).
// Levels 1-9 and MEDIUM (but a stale one, D_MED_STALE) also take the
// resolve's slots (n_slots of them, from spos) and deltas (from ds_ranges'
// first insert, `span` of them), and after the chase ds_tables writes the
// handle's head and prevd (MEDIUM's head4 and prevd4). At levels 1-3 and
// MEDIUM `deltas` are the last round's chains, `bits` the skip map the slots
// assumed (from the first insert rounded down to 32), which the chase
// leaves holding the parse's own, and `dlist` (as deltas) the chase's
// scratch; after the chase build_chains writes dlist
// over the positions the parse inserted (the pump's piece row `pieces`,
// chain_blocks blocks) for ds_tables. clk (null, or int64 [3]) takes the
// chase's clock64 cycles: in all, in flush_block, and of those in
// emit_symbols; stats (null, or int64 [2]) adds the loop tops and the
// live walks; `level` the record's (the host's copy: MEDIUM's chains key
// by hash4).
extern "C" int zrs_dstream_pump(void* rec, const void* data, void* work, void* out,
                                const void* slots, long long n_slots, const void* deltas,
                                void* dlist, long long span, const void* pieces,
                                long long chain_blocks, void* bits, void* clk, void* stats,
                                int level, void* stream) {
  const int terr = ensure_tables();
  if (terr) return terr;
  const cudaStream_t st = (cudaStream_t)stream;
  dstream_pump<<<1, 32, bits ? HASH_SIZE * sizeof(int32_t) : 0, st>>>(
      (long long*)rec, (const uint8_t*)data, (uint8_t*)work, (uint8_t*)out, (const Slot*)slots,
      n_slots, (const uint16_t*)deltas, (uint16_t*)dlist, span, (uint32_t*)bits,
      (long long*)clk, (long long*)stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !deltas) return (int)err;
  const void* tables = deltas;
  if (bits && dlist && pieces && chain_blocks > 0) {
    const bool four = medium_level(level);
    build_chains<<<(unsigned)chain_blocks, kChainThreads, kChainSmem, st>>>(
        (const uint8_t*)data, (const long long*)pieces, 1,
        (const int32_t*)((const uint8_t*)work + (four ? kWorkBytes : 0)), (uint16_t*)dlist,
        (const uint32_t*)bits, 0, four ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tables = dlist;
  }
  long long blocks = (span + kTableThreads - 1) / kTableThreads;
  blocks = blocks < 1 ? 1 : blocks > 1024 ? 1024 : blocks;
  ds_tables<<<(unsigned)blocks, kTableThreads, 0, st>>>((const long long*)rec,
                                                        (const uint8_t*)data, (uint8_t*)work,
                                                        (const uint16_t*)tables,
                                                        (const uint32_t*)bits);
  return (int)cudaGetLastError();
}
#else
// the resolve on the host (the same arguments as zrs_exact_resolve but the
// block counts, the count and the stream; chains 0 keeps the deltas of an
// earlier build, slots null builds the chains alone)
extern "C" int zrs_exact_resolve_host(const void* in, const void* pieces, int P, int level,
                                      const void* head_old, const void* ring, void* deltas,
                                      void* slots, const void* bits, long long bit_stride,
                                      int chains) {
  ensure_host_tables();
  if (!resolved_level(level) || (bits && !mapped_level(level))) return 1;
  int32_t* table = (int32_t*)std::malloc((1 << 16) * sizeof(int32_t));
  if (!table) return 1;
  resolve_host((const uint8_t*)in, (const long long*)pieces, P, level, (const int32_t*)head_old,
               (const uint16_t*)ring, (uint16_t*)deltas, (Slot*)slots, table,
               (const uint32_t*)bits, bit_stride, chains != 0);
  std::free(table);
  return 0;
}

// the dry parse on the host, the pieces in order (zrs_exact_dry's arguments
// but the stream)
extern "C" int zrs_exact_dry_host(const void* in, const void* pieces, int P, int level,
                                  const void* recs, const void* slots, void* bits,
                                  long long bit_stride) {
  ensure_host_tables();
  if (!mapped_level(level) || !bits || (medium_level(level) && (!recs || !in))) return 1;
  for (int i = 0; i < P; i++)
    dry_piece((const uint8_t*)in, (const long long*)pieces + (size_t)i * kPiece, level,
              (const long long*)recs, (const Slot*)slots, (uint32_t*)bits, bit_stride, nullptr,
              0, 1);
  return 0;
}

// EX's chase on the host, the pieces in order (zrs_exact_chase's arguments
// but clk and the stream)
extern "C" int zrs_exact_chase_host(const void* in, const void* meta, const void* pieces, int P,
                                    int level, void* out, void* lens, void* status, void* recs,
                                    void* scratch, long long stride, const void* slots,
                                    const void* deltas, void* dlist, void* bits,
                                    long long bit_stride, void* stats) {
  ensure_host_tables();
  if (!resolved_level(level) || stride < (long long)kWorkBytes ||
      (mapped_level(level) && (!bits || !dlist)))
    return 1;
  for (int i = 0; i < P; i++)
    chase_piece((const uint8_t*)in, (const long long*)meta, (const long long*)pieces + (size_t)i * kPiece,
                level, (uint8_t*)out, (long long*)lens, (int*)status, (long long*)recs,
                (uint8_t*)scratch, stride, (const Slot*)slots, (const uint16_t*)deltas,
                (uint16_t*)dlist, (uint32_t*)bits, bit_stride, nullptr, nullptr, nullptr, 0,
                nullptr, (long long*)stats);
  return 0;
}

// the host build's piece, in positions (the tests' way to many pieces)
extern "C" void zrs_exact_set_piece(long long positions) { g_piece = positions; }

// levels 1-9 and MEDIUM on the host, a chunk at a time, a piece of g_piece
// positions at a time, each resolved and chased as on the card; at levels
// 1-3 and MEDIUM `rounds` rounds of the resolve over chains built under the
// map (a dry parse between two), the chunk's first round
// assuming `seed` (uint32 [chunks, seed_words]: chunk k's map of its
// window-relative positions, the dictionary's taken as clear, but at
// MEDIUM its last three, which native never hashes; null, or words past
// seed_words, assume none skipped); truth (null, or as seed) takes each
// chunk's map of the parse, stats (null, or int64 [2]) as
// zrs_exact_chase's
extern "C" int zrs_exact_greedy_host(const void* in, const void* meta, int chunks, int level,
                                     void* out, void* lens, void* status, const void* seed,
                                     long long seed_words, int rounds, void* truth,
                                     void* stats) {
  ensure_host_tables();
  if (!resolved_level(level) || rounds < 1) return 1;
  const bool greedy = mapped_level(level), medium = medium_level(level);
  uint8_t* scratch = (uint8_t*)std::malloc(kWorkBytes);
  if (!scratch) return 1;
  const long long* mt = (const long long*)meta;
  int rc = 0;
  for (int k = 0; k < chunks && !rc; k++) {
    const long long start = mt[k * kMeta], dict_len = mt[k * kMeta + 2];
    const long long total = dict_len + mt[k * kMeta + 1];
    const long long words = map_words(0, total);
    uint32_t* map = greedy ? (uint32_t*)std::calloc((size_t)words, 4) : nullptr;
    if (greedy && !map) {
      rc = 1;
      break;
    }
    if (map && seed) {  // the dictionary is in the chains whatever the seed says
      std::memcpy(map, (const uint32_t*)seed + (size_t)k * seed_words,
                  (size_t)(words < seed_words ? words : seed_words) * 4);
      for (long long q = 0; q < dict_len; q++) map[q >> 5] &= ~(1u << (q & 31));
    }
    if (medium)  // native hashes no dictionary position whose string passes it
      for (long long q = dict_len > 3 ? dict_len - 3 : 0; q < dict_len; q++)
        map[q >> 5] |= 1u << (q & 31);
    long long rec[kDRec] = {0};
    for (long long s = dict_len;; s += g_piece) {
      const long long e = s + g_piece < total ? s + g_piece : total;
      long long pr[kPiece] = {0};
      pr[P_BASE] = start - dict_len;
      pr[P_TOTAL] = total;
      pr[P_C0] = s > WSIZE ? s - WSIZE : 0;
      const long long c1 = medium ? e + MAX_MATCH : e, end = total - (medium ? 3 : 2);
      pr[P_C1] = c1 < end ? c1 : end;
      if (pr[P_C1] < pr[P_C0]) pr[P_C1] = pr[P_C0];
      pr[P_S] = s;
      pr[P_E] = e;
      pr[P_CHUNK] = k;
      pr[P_LAST] = e == total;
      const size_t nd = (size_t)(pr[P_C1] - pr[P_C0] + 1);
      uint16_t* deltas = (uint16_t*)std::malloc(nd * 2);
      uint16_t* dlist = greedy ? (uint16_t*)std::malloc(nd * 2) : nullptr;
      Slot* slots = (Slot*)std::malloc((size_t)(slot_end(pr, medium) - s + 1) * sizeof(Slot));
      if (!deltas || !slots || (greedy && !dlist)) {
        rc = 1;
      } else {
        for (int r = 0; r < (greedy ? rounds : 1); r++) {
          if (r) zrs_exact_dry_host(in, pr, 1, level, rec, slots, map, 0);
          zrs_exact_resolve_host(in, pr, 1, level, nullptr, nullptr, deltas, slots, map, 0, 1);
        }
        zrs_exact_chase_host(in, meta, pr, 1, level, out, lens, status, rec, scratch, kWorkBytes,
                             slots, deltas, dlist, map, 0, stats);
      }
      std::free(deltas);
      std::free(dlist);
      std::free(slots);
      if (rc || e == total) break;
    }
    if (map && truth)
      std::memcpy((uint32_t*)truth + (size_t)k * seed_words, map,
                  (size_t)(words < seed_words ? words : seed_words) * 4);
    std::free(map);
  }
  std::free(scratch);
  return rc;
}

// EX on the host with one lane: the CPU tests' way into this file's control
// flow; levels 1-9 and MEDIUM as zrs_exact_greedy_host (levels 1-3 and
// MEDIUM host_rounds rounds from a map of no skipped position), the others
// a chunk at a time
extern "C" int zrs_exact_deflate_host(const void* in, const void* meta, int chunks, int level,
                                      void* out, void* lens, void* status) {
  ensure_host_tables();
  if (resolved_level(level))
    return zrs_exact_greedy_host(in, meta, chunks, level, out, lens, status, nullptr, 0,
                                 host_rounds(level), nullptr, nullptr);
  uint8_t* slot = (uint8_t*)std::malloc(kWorkBytes + kWork4Bytes);
  if (!slot) return 1;
  Work* w = (Work*)slot;
  Work4* w4 = needs_work4(level) ? (Work4*)(slot + kWorkBytes) : nullptr;
  const long long* mt = (const long long*)meta;
  for (int k = 0; k < chunks; k++)
    ((long long*)lens)[k] = deflate_one((const uint8_t*)in, mt + (size_t)k * kMeta, level,
                                        (uint8_t*)out, w, w4, 0, 1, (int*)status + k);
  std::free(slot);
  return 0;
}

// DS on the host with one lane; levels 1-9 the resolve of ds_ranges (at
// 1-3 and MEDIUM host_rounds rounds over chains built under the map, a dry parse
// between two, from a map of no skipped position), the chase, then at 1-3
// the chains of the inserted positions, and ds_tables, as on the card
extern "C" int zrs_dstream_pump_host(void* rec, const void* data, void* work, void* out) {
  ensure_host_tables();
  long long* r = (long long*)rec;
  Work* w = (Work*)work;
  const int level = (int)r[D_LEVEL];
  const bool medium = medium_level(level);
  if (!resolved_level(level) || (medium && r[D_MED_STALE])) {
    ds_pump(r, (const uint8_t*)data, w, (uint8_t*)out, 0, 1, nullptr, 0, nullptr, nullptr, 0,
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    return 0;
  }
  const bool greedy = mapped_level(level);
  // MEDIUM's chains: head4 and prevd4 (Work4, after Work)
  Work4* w4 = (Work4*)((uint8_t*)work + kWorkBytes);
  const int32_t* head = medium ? w4->head4 : w->head;
  const uint16_t* ring = medium ? w4->prevd4 : w->prevd;
  long long g[4];
  ds_ranges(r, g);
  long long pr[kPiece] = {0};
  pr[P_TOTAL] = r[D_TOTAL];
  pr[P_LO] = pr[P_C0] = g[0];
  pr[P_C1] = g[1];
  pr[P_S] = g[2];
  pr[P_E] = g[3];
  const long long b0 = g[0] & ~31LL, n_slots = slot_end(pr, medium) - g[2];
  const size_t nd = (size_t)(g[1] - g[0] + 1);
  uint16_t* deltas = (uint16_t*)std::malloc(nd * 2);
  uint16_t* dlist = greedy ? (uint16_t*)std::malloc(nd * 2) : nullptr;
  Slot* slots = (Slot*)std::malloc((size_t)(n_slots + 1) * sizeof(Slot));
  uint32_t* map = greedy ? (uint32_t*)std::calloc((size_t)map_words(b0, pr[P_TOTAL]), 4) : nullptr;
  int32_t* ldh = (int32_t*)std::malloc(HASH_SIZE * sizeof(int32_t));
  int rc = 1;
  if (deltas && slots && ldh && (!greedy || (map && dlist))) {
    for (int i = 0; i < host_rounds(level); i++) {
      if (i) zrs_exact_dry_host(data, pr, 1, level, medium ? r : nullptr, slots, map, 0);
      zrs_exact_resolve_host(data, pr, 1, level, head, ring, deltas, slots, map, 0, 1);
    }
    ds_pump(r, (const uint8_t*)data, w, (uint8_t*)out, 0, 1, slots, n_slots, deltas, dlist,
            g[1] - g[0], map, ldh, nullptr, nullptr, nullptr, nullptr, nullptr);
    if (greedy && r[D_STATUS] != kMisuse)
      zrs_exact_resolve_host(data, pr, 1, level, head, nullptr, dlist, nullptr, map, 0, 1);
    ds_tables_range(r, (const uint8_t*)data, w, greedy ? dlist : deltas, 0, 1, Skip{map, b0});
    ds_tables_clear(r, w, 0, 1);
    rc = 0;
  }
  std::free(deltas);
  std::free(dlist);
  std::free(slots);
  std::free(map);
  std::free(ldh);
  return rc;
}
#endif
