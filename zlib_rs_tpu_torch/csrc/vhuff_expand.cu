// K5: the two-plane token expansion, one block per chunk.
//
// Replaces zlib_rs_tpu/ops/pallas/vhuff_kernel.py:expand_tokens_pallas2
// (body _make_expand_kernel2). The walkers of a chunk run in order; walker
// s writes output bytes [offs[s], offs[s + 1]). Each tape row is a literal
// funnel store of up to four bytes (the bytes below the write position in
// its word are kept), then, if the row has a match, the match copy: a byte
// head for dist < 4 (which turns the copy distance d4 into a multiple of
// the period of at least 4), a word store at the head's end, then whole
// words from d4 back. An all-zero row ends the walker.
//
// Order matters: stores write whole words, leaving don't-care bytes past a
// row's end that the next row or walker overwrites, and a walker's matches
// read the bytes of the walkers before it. So one thread expands a chunk,
// walker after walker, as the reference does.
//
// Bound on the H100: bytes (the tapes read once, the output written
// once); in practice the serial chain of dependent word reads and writes
// of one thread per chunk, so latency.
//
// Design: the chunk's output is built in shared memory when it fits (32
// KiB chunks take 32 KiB) and copied out coalesced at the end; otherwise
// the thread works on the output row in device memory. Tapes are
// row-major [cap, W]: row t of 8 neighbouring walkers is one 32-byte
// sector. While thread 0 expands a group of 8 walkers from shared memory,
// warps 1-3 stage the next group's rows (double buffer). Rows past the
// staged depth are read from device memory directly.
//
// A corrupt tape or a damaged index must not fault the context: every
// read index is clamped to [0, out_words) and every store outside it is
// dropped (the reference reads unclamped at its word copy).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;           // walkers staged together
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr int kMaxStageRows = 1024;

struct Out {
  uint32_t* o;
  long long n;  // out_words

  __device__ __forceinline__ uint32_t rd(long long i) const {
    return o[i < 0 ? 0 : (i >= n ? n - 1 : i)];
  }
  __device__ __forceinline__ void wr(long long i, uint32_t v) const {
    if (i >= 0 && i < n) o[i] = v;
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
  const long long sp = pw - d4;
  const int ssh = (int)(sp & 3) << 3;
  const uint32_t s0 = out.rd(sp >> 2);
  const uint32_t src4 = ssh ? (s0 >> ssh) | (out.rd((sp >> 2) + 1) << (32 - ssh)) : s0;
  out.wr(wi, (out.rd(wi) & ((1u << sh) - 1u)) | (src4 << sh));
  const long long nw = ((p + length - 1) >> 2) - wi;
  const long long sp0 = ((wi + 1) << 2) - d4;
  const long long swi0 = sp0 >> 2;
  const int sh_s = (int)(sp0 & 3) << 3;
  const bool rep4 = swi0 == wi;  // d4 == 4: repeat the word just stored
  uint32_t w0 = out.rd(swi0);
  for (long long k = 0; k < nw; ++k) {
    const uint32_t w1 = out.rd(swi0 + k + 1);
    const uint32_t val = sh_s ? (w0 >> sh_s) | (w1 << (32 - sh_s)) : w0;
    out.wr(wi + 1 + k, val);
    w0 = rep4 ? val : w1;
  }
}

__device__ void expand_walker(const Out& out, const uint32_t* sa,
                              const uint32_t* sb, int stage_rows,
                              const int32_t* ga, const int32_t* gb, long long W,
                              int cap, long long p, long long p1) {
  int t = 0;
  while (t < cap && p < p1) {
    uint32_t ta, tb;
    if (t < stage_rows) {
      ta = sa[t * kGroup];
      tb = sb[t * kGroup];
    } else {
      ta = (uint32_t)ga[t * W];
      tb = (uint32_t)gb[t * W];
    }
    const int cnt = (int)(tb & 7u);
    // literal funnel: up to 4 bytes, at most one word boundary
    const long long wi = p >> 2;
    const int sh = (int)(p & 3) << 3;
    const long long p2 = p + cnt;
    out.wr(wi, (out.rd(wi) & ((1u << sh) - 1u)) | (ta << sh));
    if ((p2 >> 2) > wi) out.wr(p2 >> 2, sh ? ta >> (32 - sh) : 0u);
    int length = 0;
    if (tb & 8u) {
      length = (int)((tb >> 4) & 0xFFu) + 3;
      copy_match(out, p2, length, (int)((tb >> 12) & 0xFFFFu));
    }
    t = tb ? t + 1 : cap;
    p = p2 + length;
  }
}

__device__ void stage(uint32_t* dst_a, uint32_t* dst_b, const int32_t* tape_a,
                      const int32_t* tape_b, long long W, long long col0,
                      int rows, int tid, int nth) {
  for (int i = tid; i < rows * kGroup; i += nth) {
    const long long g = (long long)(i / kGroup) * W + col0 + (i % kGroup);
    dst_a[i] = (uint32_t)tape_a[g];
    dst_b[i] = (uint32_t)tape_b[g];
  }
}

__global__ void vhuff_expand(const int32_t* __restrict__ tape_a,
                             const int32_t* __restrict__ tape_b,
                             const int32_t* __restrict__ offs, int cap, int W,
                             int S, int out_words, int stage_rows,
                             int out_in_smem, int32_t* __restrict__ out_g) {
  extern __shared__ uint32_t smem[];
  const int chunk = blockIdx.x;
  const int per_buf = stage_rows * kGroup;
  uint32_t* st_a[2] = {smem, smem + 2 * per_buf};
  uint32_t* st_b[2] = {smem + per_buf, smem + 3 * per_buf};
  uint32_t* row = (uint32_t*)out_g + (long long)chunk * out_words;
  const Out out = {out_in_smem ? smem + 4 * per_buf : row, out_words};
  for (int i = threadIdx.x; i < out_words; i += kThreads) out.o[i] = 0;

  const long long col = (long long)chunk * S;
  const int32_t* of = offs + (long long)chunk * (S + 1);
  const int groups = S / kGroup;
  stage(st_a[0], st_b[0], tape_a, tape_b, W, col, stage_rows, threadIdx.x, kThreads);
  __syncthreads();
  for (int g = 0; g < groups; ++g) {
    const int cur = g & 1;
    if (threadIdx.x >= 32) {
      if (g + 1 < groups)
        stage(st_a[cur ^ 1], st_b[cur ^ 1], tape_a, tape_b, W,
              col + (long long)(g + 1) * kGroup, stage_rows, threadIdx.x - 32,
              kThreads - 32);
    } else if (threadIdx.x == 0) {
      for (int j = 0; j < kGroup; ++j) {
        const int s = g * kGroup + j;
        expand_walker(out, st_a[cur] + j, st_b[cur] + j, stage_rows,
                      tape_a + col + s, tape_b + col + s, W, cap, of[s], of[s + 1]);
      }
    }
    __syncthreads();
  }
  if (out_in_smem)
    for (int i = threadIdx.x; i < out_words; i += kThreads) row[i] = out.o[i];
}

}  // namespace

extern "C" int zrs_vhuff_expand(const void* tape_a, const void* tape_b,
                                const void* offs, int cap, int W, int S,
                                int out_words, void* out, void* stream) {
  if (W <= 0 || S <= 0 || S % kGroup) return (int)cudaErrorInvalidValue;
  const int B = W / S;
  const int row_bytes = 4 * kGroup * 4;  // two buffers of two planes
  const long long out_bytes = 4LL * out_words;
  const int min_rows = cap < 64 ? cap : 64;
  const int out_in_smem = out_bytes + (long long)row_bytes * min_rows <= kSmemMax;
  const long long avail = kSmemMax - (out_in_smem ? out_bytes : 0);
  int stage_rows = (int)(avail / row_bytes);
  stage_rows = stage_rows < cap ? stage_rows : cap;
  stage_rows = stage_rows < kMaxStageRows ? stage_rows : kMaxStageRows;
  const size_t smem = (size_t)row_bytes * stage_rows + (out_in_smem ? out_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      vhuff_expand, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  vhuff_expand<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tape_a, (const int32_t*)tape_b, (const int32_t*)offs, cap,
      W, S, out_words, stage_rows, out_in_smem, (int32_t*)out);
  return (int)cudaGetLastError();
}
