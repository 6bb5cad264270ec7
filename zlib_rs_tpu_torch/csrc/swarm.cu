// The seeded swarm engine's walkers: a thread a walker, each decoding its
// span of one chunk's coded block to its own end, in one launch.
//
// Replaces no pallas_call: the reference's engine is XLA code,
// zlib_rs_tpu/parallel/swarm_inflate.py:decode_seeded (a loop of steps over
// all walkers at once). Its torch port, swarm_inflate.walk_plain, is this
// kernel's plain version; the tapes, end positions, remaining spans and bad
// flags are the same element for element on every input, corrupt ones
// included.
//
// A walker starts at its seed's bit cursor with its span of output bytes
// to cover. A step decodes one literal or length/distance pair from the
// chunk's flat 2^15-entry tables (built on the device before the launch)
// and writes one token; a walker stops when its span is covered or a
// step goes bad (an invalid code, an end-of-block inside the span, a bad
// distance code, or a token past the span). In the reference a stopped
// walker writes null tokens and never moves again, so it can stop alone:
// the rows past its stop stay the zeros the wrapper wrote.
//
// Bound on the H100. The bytes are the bodies and tables in and the tapes
// out, microseconds at 3.35 TB/s. It is not the floor: each walker is a
// serial chain of two dependent table reads a step; walkers are
// independent, so the chains of a batch's thousands of walkers overlap.
//
// Design. A thread holds its walker's state in registers and reads, a step,
// the 12 bytes at its cursor (clamped as the reference clamps them: the
// byte offset to [0, L - 9], zeros past the row) as a 64-bit window, then
// the literal/length entry and the distance entry of its chunk's tables
// through the L1 and L2 caches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFlatBits = 15;
constexpr int kLut = 1 << kFlatBits;

enum Kind { KIND_LIT = 0, KIND_MATCH = 1, KIND_EOB = 2, KIND_INVALID = 4 };
enum Tok { TOK_NULL = 0, TOK_LIT = 1, TOK_MATCH = 2 };

__global__ void __launch_bounds__(kThreads)
swarm_walk(const uint8_t* __restrict__ comp, int batch, long long L, int seeds,
           const int32_t* __restrict__ ll_lut, const int32_t* __restrict__ d_lut,
           const long long* __restrict__ seed_bit, const long long* __restrict__ seed_span,
           int cap, uint8_t* __restrict__ tok_kind, int32_t* __restrict__ tok_a,
           int32_t* __restrict__ tok_b, long long* __restrict__ end_bit,
           long long* __restrict__ remaining_out, uint8_t* __restrict__ bad_out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)batch * seeds) return;
  const long long lane = w / seeds;
  const uint8_t* row = comp + lane * L;
  const int32_t* ll = ll_lut + lane * kLut;
  const int32_t* dl = d_lut + lane * kLut;
  uint8_t* tk = tok_kind + w * cap;
  int32_t* ta = tok_a + w * cap;
  int32_t* tb = tok_b + w * cap;
  long long bitpos = seed_bit[w];
  long long remaining = seed_span[w];
  bool bad = false;
  for (int it = 0; it < cap && remaining > 0 && !bad; ++it) {
    long long off = bitpos >> 3;
    off = off < 0 ? 0 : (off > L - 9 ? L - 9 : off);
    uint64_t x = 0;
    uint32_t y = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) x |= (uint64_t)row[off + k] << (8 * k);
#pragma unroll
    for (int k = 8; k < 12; ++k) {
      uint32_t b = off + k < L ? row[off + k] : 0;
      y |= b << (8 * (k - 8));
    }
    const int sh = (int)(bitpos & 7);
    const uint64_t v = sh ? (x >> sh) | ((uint64_t)y << (64 - sh)) : x;
    const uint32_t e = (uint32_t)ll[v & (kLut - 1)];
    const int kind = (int)(e >> 28);
    const int aux = (int)((e >> 22) & 0x3F);
    const int nb = (int)((e >> 16) & 0x3F);
    const int payload = (int)(e & 0xFFFF);
    const long long length = payload + (long long)((v >> nb) & ((1u << aux) - 1));
    const int p2 = nb + aux;
    const uint32_t win2 = (uint32_t)(v >> p2);
    const uint32_t de = (uint32_t)dl[win2 & (kLut - 1)];
    const int dkind = (int)(de >> 28);
    const int daux = (int)((de >> 22) & 0x3F);
    const int dnb = (int)((de >> 16) & 0x3F);
    const long long dist = (long long)(de & 0xFFFF) + ((win2 >> dnb) & ((1u << daux) - 1));
    const bool is_lit = kind == KIND_LIT;
    const bool is_match = kind == KIND_MATCH && dkind == KIND_MATCH;
    const long long cover = is_lit ? 1 : (is_match ? length : 0);
    const bool is_bad = kind == KIND_INVALID || kind == KIND_EOB ||
                        (kind == KIND_MATCH && dkind != KIND_MATCH) || cover > remaining;
    if (is_bad) {
      bad = true;  // the row stays a null token
    } else {
      tk[it] = is_lit ? TOK_LIT : (is_match ? TOK_MATCH : TOK_NULL);
      ta[it] = (int32_t)cover;
      tb[it] = (int32_t)(is_lit ? payload : dist);
      bitpos += is_lit ? nb : (is_match ? nb + aux + dnb + daux : 0);
      remaining -= cover;
    }
  }
  end_bit[w] = bitpos;
  remaining_out[w] = remaining;
  bad_out[w] = bad;
}

}  // namespace

// comp uint8 [B, L] (L >= 12), ll_lut and d_lut int32 [B, 2^15], seed_bit
// and seed_span int64 [B, S]; tok_kind uint8, tok_a and tok_b int32 [B * S,
// cap] walker-major (zeroed by the caller), end_bit and remaining int64
// [B * S], bad uint8 [B * S].
extern "C" int zrs_swarm_walk(const void* comp, int batch, long long L, int seeds,
                              const void* ll_lut, const void* d_lut, const void* seed_bit,
                              const void* seed_span, int cap, void* tok_kind, void* tok_a,
                              void* tok_b, void* end_bit, void* remaining, void* bad,
                              void* stream) {
  if (L < 12) return (int)cudaErrorInvalidValue;
  const long long walkers = (long long)batch * seeds;
  if (walkers > 0) {
    const unsigned blocks = (unsigned)((walkers + kThreads - 1) / kThreads);
    swarm_walk<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, batch, L, seeds, (const int32_t*)ll_lut, (const int32_t*)d_lut,
        (const long long*)seed_bit, (const long long*)seed_span, cap, (uint8_t*)tok_kind,
        (int32_t*)tok_a, (int32_t*)tok_b, (long long*)end_bit, (long long*)remaining,
        (uint8_t*)bad);
  }
  return (int)cudaGetLastError();
}
