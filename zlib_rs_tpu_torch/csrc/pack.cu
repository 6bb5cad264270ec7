// K3: LSB-first Huffman bit packing of one chunk's parse, one block per
// chunk.
//
// Replaces zlib_rs_tpu/ops/pallas/deflate_kernel.py:freq_pack_chunks_pallas
// (body _pack_kernel via _make_pack_kernel(with_seeds)). From the compact
// match stream (literals are the gaps between matches) it packs, in order:
// each gap literal's code, each match's length code + extra bits and
// distance code + extra bits, then EOB, with the per-chunk tables
// (code | nbits << 16). It zeroes the slack word after the last word (the
// host splicer reads one byte past the end), records decode seeds
// (body bit offset, output offset) of the first token at or after every
// `stride` output bytes, filling unreached seeds with end-of-body, and
// echoes the tables it consumed so that the header is built from exactly
// these tables.
//
// Why a block can pack a chunk. A token's bits depend only on its own
// position: a literal's code, or a match's length and distance fields.
// Where they go is the sum of the bits of every token before it, a prefix
// sum. So the span [start, n_valid) is cut into tiles of kTile positions
// (one tile holds a 32 KiB chunk's span), a tile into one segment of kSeg
// positions a thread, and for each tile:
//   1. Classify. Every position's code goes to shared memory: its byte,
//      then, for each match k < nmatch that starts in the tile, its length
//      and distance symbols (match_code) at its start. Each match also
//      raises its segment's cover end (start + length) by a shared atomic
//      max. The scans (K2, K8, K10, K12) emit matches in increasing,
//      non-overlapping order, and this design relies on it: a tile's
//      matches are one run of k, which each thread walks in steps of the
//      block width until a start lies past the tile.
//   2. Count. An exclusive max scan of the cover ends gives each segment
//      the end of the matches before it; a position below the running end
//      lies inside a match. Each thread sums its segment's bits (a
//      literal's code; a match start's length and distance fields), and an
//      exclusive sum scan gives each segment its first bit.
//   3. Emit. Each thread packs its segment with a 64-bit accumulator into
//      a zeroed word buffer in shared memory. Words wholly inside the
//      segment are stored plainly, the first and the last, which
//      neighbouring segments share, by shared atomicOr. Word 0 of the
//      buffer starts as the previous tile's partial last word. Then the
//      tile's words are copied out coalesced.
// The words are the serial order's bit for bit: the same fields at the
// same offsets, ORed into zeroed words, as the plain version
// (deflate_kernel.pack_plain) computes them in vector form.
//
// Seeds. Seed j is the first token at or after t_j = start + j * stride.
// The thread whose segment holds t_j writes it: the first token of its
// segment at or after t_j, or, when the rest of the segment lies inside a
// match, the token at that match's end, whose bit offset is the segment's
// last (no token lies between). A seed past the chunk's last token gets
// end of body once the total is known.
//
// Words at or past oww are dropped, and st[1] (bad) is set when the last
// bit lies past word oww - 1, as the plain version's clamp does.
//
// Bound on the H100: bytes (the span's words, the match stream and the
// tables read once, the packed words written once). Each block makes two
// short walks over shared memory and two block scans a tile; 128 chunks a
// launch are one block an SM, one wave.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
// 1024 threads of 32 positions: a tile is a 32 KiB chunk's whole span, the
// 128 chunks of a launch are one block an SM (the shared memory below
// allows one), and a block's 32 warps keep its SM busy
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 32;                // positions a thread
constexpr int kBatch = 4;               // matches a thread loads at once
constexpr int kTile = kThreads * kSeg;  // positions a tile
// a position costs at most 16 bits (a literal's code is at most 15, a
// match of at least 3 positions at most 48), plus the partial word the
// previous tile left and one word of slack
constexpr int kStageWords = kTile / 2 + 8;
// codes, one pad word after every 32 so that the 32 lanes of a warp, each
// on its own segment, read 32 banks; then the word buffer
constexpr int kCodeWords = kTile + kTile / 32;
constexpr int kSmem = (kCodeWords + kStageWords) * 4;
constexpr uint32_t kMatch = 0x80000000u;

__device__ __forceinline__ int bit_length(uint32_t x) { return 32 - __clz(x); }

// where position i of a tile keeps its code
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// Exclusive scan of one int a thread, in thread order, under max (values
// are at least 0, the identity) or +; *total gets the whole reduction.
// Every thread of the block calls it.
template <bool kMax>
__device__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x = kMax ? max(x, y) : x + y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = tmp[lane];
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s = kMax ? max(s, y) : s + y;
    }
    tmp[lane] = s;
  }
  __syncthreads();
  int ex = __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (lane == 0) ex = 0;
  const int before = warp ? tmp[warp - 1] : 0;
  *total = tmp[kWarps - 1];
  __syncthreads();  // tmp is reused by the next scan
  return kMax ? max(before, ex) : before + ex;
}

// Counts a segment's bits.
struct Count {
  int bits = 0;
  __device__ __forceinline__ void token(int) {}
  __device__ __forceinline__ void put(uint32_t, int nb) { bits += nb; }
};

// Packs a segment into the tile's word buffer from bit `rel` on, and
// writes the seeds whose targets its tokens reach.
template <bool kSeeds>
struct Emit {
  uint32_t* stage;
  int widx;       // the buffer word being filled
  uint64_t acc;   // its bits, LSB first, and the next word's
  int n;          // bits held in acc, the first (rel & 31) of them zero
  bool shared;    // widx is the segment's first word, and a neighbour's
  int bit;        // absolute bit offset of the next field
  int last;       // the last token's position, -1 before any
  // seeds: j runs over the targets inside the segment
  int j, jend, start, stride;
  int32_t *sb, *so;

  __device__ __forceinline__ void token(int p) {
    last = p;
    if constexpr (kSeeds) {
      while (j < jend && start + j * stride <= p) {
        sb[j] = bit;
        so[j] = p - start;
        ++j;
      }
    }
  }
  __device__ __forceinline__ void put(uint32_t v, int nb) {
    acc |= (uint64_t)v << n;
    n += nb;
    bit += nb;
    if (n >= 32) {
      if (widx < kStageWords) {
        if (shared)
          atomicOr(stage + widx, (uint32_t)acc);
        else
          stage[widx] = (uint32_t)acc;
      }
      shared = false;
      ++widx;
      acc >>= 32;
      n -= 32;
    }
  }
  __device__ __forceinline__ void finish() {
    if (n > 0 && widx < kStageWords) atomicOr(stage + widx, (uint32_t)acc);
  }
};

// A match's code in the tile: kMatch | lc | lev << 5 | dc << 10 | dev << 15,
// its length symbol (code 0..28 and extra value) and its distance symbol
// (code 0..29 and extra value), from mld = (len - 3) << 15 | (dist - 1).
__device__ __forceinline__ uint32_t match_code(uint32_t x) {
  const int v = (int)(x >> 15);
  int lc, lev = 0;
  if (v < 8) {
    lc = v;
  } else if (v == 255) {
    lc = 28;
  } else {
    const int e = bit_length((uint32_t)v) - 3;
    lc = min(4 + 4 * e + ((v >> e) & 3), 30);
    lev = v & ((1 << e) - 1);
  }
  const int d = (int)(x & 0x7FFFu);
  int dc, dev = 0;
  if (d < 4) {
    dc = d;
  } else {
    const int e = bit_length((uint32_t)d) - 2;
    dc = 2 * (e + 1) + ((d >> e) & 1);
    dev = d & ((1 << e) - 1);
  }
  return kMatch | (uint32_t)lc | (uint32_t)lev << 5 | (uint32_t)dc << 10 | (uint32_t)dev << 15;
}

// The tokens of positions [i0, i1) of a tile whose position 0 is t0, with
// `cover` the end of the matches before them; returns the end after them.
// A literal, a match and a position inside a match take the same steps
// (two fields, zero bits where there is none), so the lanes of a warp stay
// in step.
template <class Sink>
__device__ __forceinline__ int walk(const uint32_t* codes, int i0, int i1, int t0, int cover,
                                    const uint32_t* ll, const uint32_t* dd, Sink& sink) {
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const uint32_t c = codes[slot(i)];
    const int p = t0 + i;
    const bool m = (c & kMatch) != 0;
    const bool tok = m || p >= cover;
    const int lc = m ? (int)(c & 31u) : 0, lev = m ? (int)((c >> 5) & 31u) : 0;
    const int dc = (int)((c >> 10) & 31u), dev = m ? (int)((c >> 15) & 0x1FFFu) : 0;
    const int leb = lc < 8 || lc == 28 ? 0 : (lc - 4) >> 2;
    const int deb = m && dc >= 4 ? (dc >> 1) - 1 : 0;
    const uint32_t e1 = ll[m ? 257 + lc : (int)(c & 0xFFu)];
    const uint32_t e2 = dd[m ? dc : 0];
    if (tok) sink.token(p);
    sink.put(tok ? (e1 & 0xFFFFu) | ((uint32_t)lev << (e1 >> 16)) : 0u,
             tok ? (int)(e1 >> 16) + leb : 0);
    sink.put(m ? (e2 & 0xFFFFu) | ((uint32_t)dev << (e2 >> 16)) : 0u,
             m ? (int)(e2 >> 16) + deb : 0);
    if (m) {
      const int base = lc < 8 ? lc : (lc == 28 ? 255 : (4 + ((lc - 4) & 3)) << leb);
      cover = max(cover, p + base + lev + kMinMatch);
    }
  }
  return cover;
}

template <bool kSeeds>
__global__ void __launch_bounds__(kThreads, 1)
pack(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ mpos,
     const uint32_t* __restrict__ mld, int C, const int32_t* __restrict__ meta,
     const uint32_t* __restrict__ lltab, const uint32_t* __restrict__ dtab,
     uint32_t* __restrict__ owords, int oww, int32_t* __restrict__ st,
     int32_t* __restrict__ sbit, int32_t* __restrict__ sout, int ns,
     uint32_t* __restrict__ echo) {
  extern __shared__ uint32_t smem[];
  uint32_t* codes = smem;
  uint32_t* stage = smem + kCodeWords;
  __shared__ uint32_t ll[288];
  __shared__ uint32_t dd[32];
  __shared__ int seg_end[kThreads];
  __shared__ int tmp[kWarps];
  __shared__ int s_kmin, s_pre, s_last;
  const int row = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < 288; i += kThreads) {
    ll[i] = lltab[(long long)row * 288 + i];
    echo[(long long)row * 320 + i] = ll[i];
  }
  if (tid < 32) {
    dd[tid] = dtab[(long long)row * 32 + tid];
    echo[(long long)row * 320 + 288 + tid] = dd[tid];
  }
  if (tid == 0) s_last = -1;

  const uint32_t* w = words + (long long)row * W;
  const int32_t* mp = mpos + (long long)row * C;
  const uint32_t* md = mld + (long long)row * C;
  const int32_t* m = meta + (long long)row * 8;
  const int n_valid = m[0], start = m[1];
  const int nmatch = min(m[2], C);
  const int n_seeds = min(m[3], ns), stride = max(m[4], 1);
  uint32_t* out = owords + (long long)row * oww;
  int32_t* sb = sbit + (long long)row * ns;
  int32_t* so = sout + (long long)row * ns;

  // block-uniform state carried from tile to tile
  int bit0 = 0;        // the tile's first bit
  int cover = 0;       // the end of the matches before the tile
  int k0 = 0;          // the first match not yet placed
  uint32_t carry = 0;  // the partial word before bit0
  __syncthreads();
  for (int t0 = start; t0 < n_valid; t0 += kTile) {
    const int n = min(kTile, n_valid - t0);
    for (int wi = (t0 >> 2) + tid; wi < (t0 + n + 3) >> 2; wi += kThreads) {
      const uint32_t x = __ldg(w + min(wi, W - 1));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * wi + b - t0;
        if (i >= 0 && i < n) codes[slot(i)] = (x >> (8 * b)) & 0xFFu;
      }
    }
    for (int i = tid; i < kStageWords; i += kThreads) stage[i] = i ? 0u : carry;
    seg_end[tid] = 0;
    if (tid == 0) {
      s_kmin = nmatch;
      s_pre = 0;
    }
    __syncthreads();
    // 1. classify: each match of the tile at its start, kBatch matches a
    // thread loaded at once
    for (int k = k0 + tid; k < nmatch; k += kBatch * kThreads) {
      int mpk[kBatch];
      uint32_t mdk[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kk = min(k + j * kThreads, nmatch - 1);
        mpk[j] = mp[kk];
        mdk[j] = md[kk];
      }
      bool past = false;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int kk = k + j * kThreads, p = mpk[j];
        if (past || kk >= nmatch) break;
        if (p >= t0 + n) {
          atomicMin(&s_kmin, kk);
          past = true;
          break;
        }
        const int end = p + (int)(mdk[j] >> 15) + kMinMatch;
        if (p >= t0) {
          codes[slot(p - t0)] = match_code(mdk[j]);
          atomicMax(&seg_end[(p - t0) / kSeg], end);
        } else {
          atomicMax(&s_pre, end);  // a match before `start` covers the span's head
        }
      }
      if (past) break;
    }
    __syncthreads();
    cover = max(cover, s_pre);
    // 2. count
    const int i0 = tid * kSeg, i1 = min(i0 + kSeg, n);
    int tile_end;
    const int cov = max(cover, block_scan<true>(seg_end[tid], tmp, &tile_end));
    Count cnt;
    walk(codes, i0, i1, t0, cov, ll, dd, cnt);
    int tile_bits;
    const int off = block_scan<false>(cnt.bits, tmp, &tile_bits);
    // 3. emit
    const int rel = (bit0 & 31) + off;
    Emit<kSeeds> em{stage, rel >> 5, 0, rel & 31, (rel & 31) != 0, bit0 + off, -1,
                    0, 0, start, stride, sb, so};
    if constexpr (kSeeds) {
      // targets in [t0 + i0, t0 + i1): j from ceil((t0 + i0 - start) / stride)
      const int lo = t0 + i0 - start, hi = t0 + max(i1, i0) - start;
      em.j = min((lo + stride - 1) / stride, n_seeds);
      em.jend = min((hi + stride - 1) / stride, n_seeds);
    }
    const int cov_out = walk(codes, i0, i1, t0, cov, ll, dd, em);
    em.finish();
    if constexpr (kSeeds) {
      if (cov_out < n_valid) {  // the rest of the segment lies inside a match
        for (; em.j < em.jend; ++em.j) {
          sb[em.j] = em.bit;
          so[em.j] = cov_out - start;
        }
      }
    }
    if (em.last >= 0) atomicMax(&s_last, em.last);
    __syncthreads();
    const int end_bit = (bit0 & 31) + tile_bits;
    const int nw = min((end_bit + 31) >> 5, kStageWords);
    for (int i = tid; i < nw; i += kThreads) {
      const long long gw = (long long)(bit0 >> 5) + i;
      if (gw < oww) out[gw] = stage[i];
    }
    carry = (end_bit & 31) && (end_bit >> 5) < kStageWords ? stage[end_bit >> 5] : 0u;
    bit0 += tile_bits;
    cover = max(cover, tile_end);
    k0 = s_kmin;
    __syncthreads();
  }

  const uint32_t eob = ll[256];
  const int total = bit0 + (int)(eob >> 16);
  if (tid == 0) {
    // EOB after the last token, then zeroes through the slack word
    const uint64_t v = (uint64_t)carry | ((uint64_t)(eob & 0xFFFFu) << (bit0 & 31));
    const int w0 = bit0 >> 5;
    for (int i = w0; i <= (total >> 5) + 1; ++i) {
      const uint32_t x = i == w0 ? (uint32_t)v : (i == w0 + 1 ? (uint32_t)(v >> 32) : 0u);
      if (i < oww) out[i] = x;
    }
    int32_t* o = st + (long long)row * 8;
    o[0] = total;
    o[1] = (total >> 5) > oww - 1 ? 1 : 0;
    for (int k = 2; k < 8; ++k) o[k] = 0;
  }
  if constexpr (kSeeds) {
    const int last = s_last;
    for (int j = tid; j < n_seeds; j += kThreads) {
      if ((long long)start + (long long)j * stride > last) {  // unreached: end of body
        sb[j] = total;
        so[j] = n_valid - start;
      }
    }
  }
}

template <bool kSeeds>
int launch(const void* words, int W, const void* mpos, const void* mld, int C,
           const void* meta, const void* lltab, const void* dtab, void* owords, int oww,
           void* st, void* sbit, void* sout, int ns, void* echo, int batch, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(pack<kSeeds>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  pack<kSeeds><<<batch, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, W, (const int32_t*)mpos, (const uint32_t*)mld, C,
      (const int32_t*)meta, (const uint32_t*)lltab, (const uint32_t*)dtab,
      (uint32_t*)owords, oww, (int32_t*)st, (int32_t*)sbit, (int32_t*)sout, ns,
      (uint32_t*)echo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zrs_pack(const void* words, int W, const void* mpos,
                        const void* mld, int C, const void* meta,
                        const void* lltab, const void* dtab, void* owords,
                        int oww, void* st, void* sbit, void* sout, int ns,
                        void* echo, int with_seeds, int batch, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (with_seeds)
    return launch<true>(words, W, mpos, mld, C, meta, lltab, dtab, owords, oww, st, sbit,
                        sout, ns, echo, batch, stream);
  return launch<false>(words, W, mpos, mld, C, meta, lltab, dtab, owords, oww, st, sbit,
                       sout, ns, echo, batch, stream);
}
