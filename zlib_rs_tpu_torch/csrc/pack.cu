// K3: LSB-first Huffman bit packing of one chunk's parse, one chunk per
// block.
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
// Bound on the H100: the token loop is serial per chunk (each token's bit
// offset depends on all before it); the byte floor (words, match stream
// and tables read once, packed words written once) is far below it.
//
// Design: one thread per chunk keeps a 32-bit accumulator in registers
// and stores each filled word once; the block's warp first stages the two
// code tables in shared memory and writes the echo. `v >> (32 - cnt)` is
// undefined in C at cnt == 0, so the spill branches first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kThreads = 32;

struct Bits {
  uint32_t acc;
  int cnt;
  int owi;
  bool bad;
};

__device__ __forceinline__ void put(Bits& s, uint32_t* __restrict__ out,
                                    int deadw, uint32_t v, int nb) {
  s.acc |= v << s.cnt;
  const int ncnt = s.cnt + nb;
  if (ncnt >= 32) {
    out[min(s.owi, deadw)] = s.acc;
    s.bad |= s.owi >= deadw;
    s.acc = s.cnt == 0 ? 0u : v >> (32 - s.cnt);
    s.cnt = ncnt - 32;
    s.owi += 1;
  } else {
    s.cnt = ncnt;
  }
}

__device__ __forceinline__ int bit_length(uint32_t x) { return 32 - __clz(x); }

template <bool kSeeds>
__global__ void pack(const uint32_t* __restrict__ words, int W,
                     const int32_t* __restrict__ mpos,
                     const uint32_t* __restrict__ mld, int C,
                     const int32_t* __restrict__ meta,
                     const uint32_t* __restrict__ lltab,
                     const uint32_t* __restrict__ dtab,
                     uint32_t* __restrict__ owords, int oww,
                     int32_t* __restrict__ st, int32_t* __restrict__ sbit,
                     int32_t* __restrict__ sout, int ns,
                     uint32_t* __restrict__ echo) {
  __shared__ uint32_t ll[288];
  __shared__ uint32_t dd[32];
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < 288; i += kThreads) {
    ll[i] = lltab[(long long)row * 288 + i];
    echo[(long long)row * 320 + i] = ll[i];
  }
  if (threadIdx.x < 32) {
    dd[threadIdx.x] = dtab[(long long)row * 32 + threadIdx.x];
    echo[(long long)row * 320 + 288 + threadIdx.x] = dd[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const uint32_t* w = words + (long long)row * W;
  const int32_t* mp = mpos + (long long)row * C;
  const uint32_t* md = mld + (long long)row * C;
  const int32_t* m = meta + (long long)row * 8;
  const int n_valid = m[0], start = m[1], nmatch = m[2];
  const int n_seeds = m[3], stride = m[4];
  uint32_t* out = owords + (long long)row * oww;
  int32_t* sb = sbit + (long long)row * ns;
  int32_t* so = sout + (long long)row * ns;
  const int deadw = oww - 1;

  Bits s{0u, 0, 0, false};
  int sidx = 0;
  // every seed target the token at p satisfies gets this token's offsets
  auto seed_check = [&](int p) {
    if constexpr (kSeeds) {
      while (sidx < n_seeds && p >= start + sidx * stride) {
        const int slot = min(sidx, ns - 1);
        sb[slot] = s.owi * 32 + s.cnt;
        so[slot] = p - start;
        ++sidx;
      }
    }
  };
  auto lits = [&](int frm, int to) {
    for (int p = frm; p < to; ++p) {
      seed_check(p);
      const uint32_t e = ll[(__ldg(w + (p >> 2)) >> ((p & 3) << 3)) & 0xFFu];
      put(s, out, deadw, e & 0xFFFFu, (int)(e >> 16));
    }
  };

  int pos = start;
  for (int k = 0; k < nmatch; ++k) {
    const int p = mp[k];
    const uint32_t x = md[k];
    const int ml = (int)(x >> 15) + kMinMatch;
    const int dist = (int)(x & 0x7FFFu) + 1;
    lits(pos, p);
    seed_check(p);
    // length symbol: code 0..28, extra bits and value
    const int v = ml - kMinMatch;
    int lc, leb = 0, lev = 0;
    if (v < 8) {
      lc = v;
    } else if (v == 255) {
      lc = 28;
    } else {
      const int e = bit_length((uint32_t)v) - 3;
      lc = 4 + 4 * e + ((v >> e) & 3);
      leb = e;
      lev = v & ((1 << e) - 1);
    }
    const uint32_t le = ll[257 + lc];
    put(s, out, deadw, (le & 0xFFFFu) | ((uint32_t)lev << (le >> 16)),
        (int)(le >> 16) + leb);
    // distance symbol: code 0..29, extra bits and value
    const int d = dist - 1;
    int dc, deb = 0, dev = 0;
    if (d < 4) {
      dc = d;
    } else {
      const int e = bit_length((uint32_t)d) - 2;
      dc = 2 * (e + 1) + ((d >> e) & 1);
      deb = e;
      dev = d & ((1 << e) - 1);
    }
    const uint32_t de = dd[dc];
    put(s, out, deadw, (de & 0xFFFFu) | ((uint32_t)dev << (de >> 16)),
        (int)(de >> 16) + deb);
    pos = p + ml;
  }
  lits(pos, n_valid);
  const uint32_t eob = ll[256];
  put(s, out, deadw, eob & 0xFFFFu, (int)(eob >> 16));
  // flush the partial word, then zero the slack word after it
  out[min(s.owi, deadw)] = s.acc;
  out[min(s.owi + 1, deadw)] = 0u;
  const int total = s.owi * 32 + s.cnt;
  if (kSeeds) {
    for (int k = sidx; k < n_seeds; ++k) {  // unreached: end of body
      const int slot = min(k, ns - 1);
      sb[slot] = total;
      so[slot] = n_valid - start;
    }
  }
  int32_t* o = st + (long long)row * 8;
  o[0] = total;
  o[1] = s.bad ? 1 : 0;
  for (int k = 2; k < 8; ++k) o[k] = 0;
}

}  // namespace

extern "C" int zrs_pack(const void* words, int W, const void* mpos,
                        const void* mld, int C, const void* meta,
                        const void* lltab, const void* dtab, void* owords,
                        int oww, void* st, void* sbit, void* sout, int ns,
                        void* echo, int with_seeds, int batch, void* stream) {
  if (batch > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (with_seeds) {
      pack<true><<<batch, kThreads, 0, s>>>(
          (const uint32_t*)words, W, (const int32_t*)mpos,
          (const uint32_t*)mld, C, (const int32_t*)meta,
          (const uint32_t*)lltab, (const uint32_t*)dtab, (uint32_t*)owords,
          oww, (int32_t*)st, (int32_t*)sbit, (int32_t*)sout, ns,
          (uint32_t*)echo);
    } else {
      pack<false><<<batch, kThreads, 0, s>>>(
          (const uint32_t*)words, W, (const int32_t*)mpos,
          (const uint32_t*)mld, C, (const int32_t*)meta,
          (const uint32_t*)lltab, (const uint32_t*)dtab, (uint32_t*)owords,
          oww, (int32_t*)st, (int32_t*)sbit, (int32_t*)sout, ns,
          (uint32_t*)echo);
    }
  }
  return (int)cudaGetLastError();
}
