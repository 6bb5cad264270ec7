// K11b: the single-plane token expansion, one block per chunk.
//
// Replaces zlib_rs_tpu/ops/pallas/vhuff_kernel.py:expand_tokens_pallas
// (body _make_expand_kernel). The walkers of a chunk run in order; walker s
// writes output bytes [offs[s], offs[s + 1]). Each outer step is a literal
// sprint, then one match copy:
//   - the sprint funnels the 1-3 bytes of each LIT token through a word
//     register that starts as the bytes below the write position, storing
//     the word whenever a token crosses a word boundary, and the register
//     once the sprint meets a token that is not LIT;
//   - that token is a match (copied, and the walker goes on) or anything
//     else (the walker ends). The copy runs for both, with a cover of 0 for
//     the second: a byte head for dist < 4 (which turns the copy distance d4
//     into a multiple of the period of at least 4), a word store at the
//     head's end, then whole words from d4 back.
//
// Order matters: stores write whole words, leaving don't-care bytes past the
// write position that the next token or walker overwrites, and a walker's
// matches read the bytes of the walkers before it. So one thread expands a
// chunk, walker after walker, as the reference does.
//
// Bound on the H100: bytes (the tape read once, the output written once);
// in practice the serial chain of dependent word reads and writes of one
// thread per chunk, so latency.
//
// Design, as K5 (csrc/vhuff_expand.cu): the chunk's output is built in
// shared memory when it fits (32 KiB chunks take 32 KiB) and copied out
// coalesced at the end; otherwise the thread works on the output row in
// device memory. The tape is row-major [cap, W]: row t of 8 neighbouring
// walkers is one 32-byte sector. While thread 0 expands a group of 8
// walkers from shared memory, warps 1-3 stage the next group's rows (double
// buffer). Rows past the staged depth are read from device memory directly.
//
// A corrupt tape or a damaged index must not fault the context: every read
// index is clamped to [0, out_words) and every store outside it is dropped
// (the reference reads unclamped at its word copy).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;           // walkers staged together
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr int kMaxStageRows = 2048;
constexpr uint32_t kKindLit = 1, kKindMatch = 2;

struct Out {
  uint32_t* o;
  long long n;  // out_words

  __device__ __forceinline__ uint32_t rd(long long i) const {
    return o[i < 0 ? 0 : (i >= n ? n - 1 : i)];
  }
  __device__ __forceinline__ void wr(long long i, uint32_t v) const {
    if (i >= 0 && i < n) o[i] = v;
  }
  // the four bytes from byte position sp
  __device__ __forceinline__ uint32_t src4(long long sp) const {
    const int sh = (int)(sp & 3) << 3;
    const uint32_t w0 = rd(sp >> 2);
    return sh ? (w0 >> sh) | (rd((sp >> 2) + 1) << (32 - sh)) : w0;
  }
};

__device__ void copy_match(const Out& out, long long p, int length, int dist) {
  const int d4 = dist >= 4 ? dist : (dist == 3 ? 6 : 4);
  const int base = dist >= 4 ? 0 : d4 - dist;
  for (int i = 0; i < base; ++i) {  // byte head of a dist < 4 match
    const long long q = p + i;
    long long src = q - dist;
    src = src < 0 ? 0 : src;
    const uint32_t b = (out.rd(src >> 2) >> ((src & 3) << 3)) & 0xFFu;
    const int qs = (int)(q & 3) << 3;
    out.wr(q >> 2, (out.rd(q >> 2) & ~(0xFFu << qs)) | (b << qs));
  }
  const long long pw = p + base;
  const long long wi = pw >> 2;
  const int sh = (int)(pw & 3) << 3;
  const uint32_t keep = out.rd(wi) & ((1u << sh) - 1u);
  out.wr(wi, keep | (out.src4(pw - d4) << sh));
  const long long nw = ((p + length - 1) >> 2) - wi;
  for (long long k = 0; k < nw; ++k) {
    const long long q = (wi + 1 + k) << 2;
    out.wr(wi + 1 + k, out.src4(q - d4));
  }
}

struct Tape {
  const uint32_t* staged;  // rows [0, stage_rows), stride kGroup
  int stage_rows;
  const int32_t* col;      // the walker's column in device memory, stride W
  long long W;
  int cap;

  __device__ __forceinline__ uint32_t at(int t) const {
    if (t >= cap) return 0u;
    return t < stage_rows ? staged[t * kGroup] : (uint32_t)col[t * W];
  }
};

__device__ void expand_walker(const Out& out, const Tape& tape, long long p,
                              long long p1) {
  int t = 0;
  while (t < tape.cap && p < p1) {
    // literal sprint through the word register
    uint32_t reg = out.rd(p >> 2) & ((1u << ((int)(p & 3) << 3)) - 1u);
    uint32_t tok = tape.at(t);
    while ((tok >> 30) == kKindLit) {
      const int cnt = (int)((tok >> 24) & 3u) + 1;
      const uint32_t w = tok & 0x00FFFFFFu;
      const int sh = (int)(p & 3) << 3;
      const uint32_t full = reg | (w << sh);
      const long long p2 = p + cnt;
      out.wr(p >> 2, full);
      // bytes past the word go to the next one (sh == 0 spills nothing)
      reg = (p2 >> 2) > (p >> 2) ? (sh ? w >> (32 - sh) : 0u) : full;
      p = p2;
      tok = tape.at(++t);
    }
    out.wr(p >> 2, reg);  // flush the partial word
    // one match, or a cover-0 copy that ends the walker
    const bool is_match = (tok >> 30) == kKindMatch;
    const int cover = is_match ? (int)((tok >> 16) & 0x3FFFu) + 3 : 0;
    copy_match(out, p, cover, (int)(tok & 0xFFFFu));
    p += cover;
    t = is_match ? t + 1 : tape.cap;
  }
}

__device__ void stage(uint32_t* dst, const int32_t* tape, long long W,
                      long long col0, int rows, int tid, int nth) {
  for (int i = tid; i < rows * kGroup; i += nth)
    dst[i] = (uint32_t)tape[(long long)(i / kGroup) * W + col0 + (i % kGroup)];
}

__global__ void vhuff_expand1(const int32_t* __restrict__ tape,
                              const int32_t* __restrict__ offs, int cap, int W,
                              int S, int out_words, int stage_rows,
                              int out_in_smem, int32_t* __restrict__ out_g) {
  extern __shared__ uint32_t smem[];
  const int chunk = blockIdx.x;
  const int per_buf = stage_rows * kGroup;
  uint32_t* st[2] = {smem, smem + per_buf};
  uint32_t* row = (uint32_t*)out_g + (long long)chunk * out_words;
  const Out out = {out_in_smem ? smem + 2 * per_buf : row, out_words};
  for (int i = threadIdx.x; i < out_words; i += kThreads) out.o[i] = 0;

  const long long col = (long long)chunk * S;
  const int32_t* of = offs + (long long)chunk * (S + 1);
  const int groups = S / kGroup;
  stage(st[0], tape, W, col, stage_rows, threadIdx.x, kThreads);
  __syncthreads();
  for (int g = 0; g < groups; ++g) {
    const int cur = g & 1;
    if (threadIdx.x >= 32) {
      if (g + 1 < groups)
        stage(st[cur ^ 1], tape, W, col + (long long)(g + 1) * kGroup, stage_rows,
              threadIdx.x - 32, kThreads - 32);
    } else if (threadIdx.x == 0) {
      for (int j = 0; j < kGroup; ++j) {
        const int s = g * kGroup + j;
        const Tape tp = {st[cur] + j, stage_rows, tape + col + s, W, cap};
        expand_walker(out, tp, of[s], of[s + 1]);
      }
    }
    __syncthreads();
  }
  if (out_in_smem)
    for (int i = threadIdx.x; i < out_words; i += kThreads) row[i] = out.o[i];
}

}  // namespace

extern "C" int zrs_vhuff_expand1(const void* tape, const void* offs, int cap,
                                 int W, int S, int out_words, void* out,
                                 void* stream) {
  if (W <= 0 || S <= 0 || S % kGroup || cap <= 0) return (int)cudaErrorInvalidValue;
  const int B = W / S;
  const int row_bytes = 2 * kGroup * 4;  // two buffers of one plane
  const long long out_bytes = 4LL * out_words;
  const int min_rows = cap < 64 ? cap : 64;
  const int out_in_smem = out_bytes + (long long)row_bytes * min_rows <= kSmemMax;
  const long long avail = kSmemMax - (out_in_smem ? out_bytes : 0);
  int stage_rows = (int)(avail / row_bytes);
  stage_rows = stage_rows < cap ? stage_rows : cap;
  stage_rows = stage_rows < kMaxStageRows ? stage_rows : kMaxStageRows;
  const size_t smem = (size_t)row_bytes * stage_rows + (out_in_smem ? out_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      vhuff_expand1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  vhuff_expand1<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tape, (const int32_t*)offs, cap, W, S, out_words,
      stage_rows, out_in_smem, (int32_t*)out);
  return (int)cudaGetLastError();
}
