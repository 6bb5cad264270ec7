// K9: the 320-bin symbol histogram of a compact match stream, one chunk
// per block.
//
// Replaces the freq branch of
// zlib_rs_tpu/ops/pallas/deflate_kernel.py:freq_pack_chunks_pallas (body
// _freq_kernel), which the chain (K8) and tab (K10) routes run before the
// trees: literal bytes of every gap between matches at bins 0..255 (gap k
// is [end of match k - 1, mpos[k]), the first from `start`, the last to
// n_valid), 257 + the length code and 288 + the distance code of every
// match (the _len_sym/_dist_sym arithmetic); EOB is not counted. A chunk
// that arrives with nmatch = 0 (a bad chunk's all-literal parse) counts
// every byte of [start, n_valid). Each gap is counted on its own, so a
// byte that two gaps hold counts twice, as in the reference.
//
// Bound on the H100: a reduction over the span's bytes and the match
// stream, both read once; it is bound by bytes, and by the increments into
// the 320 bins.
//
// Design: a block of kThreads threads per chunk. The chunk's words of
// [start, n_valid) are staged into shared memory first (coalesced; bytes
// outside the stage, which only a stream whose gaps leave the span has, are
// read from device memory). Then, a tile of kTile gaps at a time (the
// nmatch + 1 gaps: one before each match and the last to n_valid):
//   1. Each thread takes kPer consecutive gaps: the codes of the match
//      after each go into its warp's private histogram (kWarps x 320 int32
//      in shared memory), and a block exclusive scan of the gap lengths,
//      max(0, b - a), places every gap's literals in the tile's run of
//      literals.
//   2. Each thread takes a contiguous share of that run, finds its first
//      gap by a binary search over the scanned offsets, and walks on,
//      counting each byte into its warp's histogram; a run of equal bytes
//      is one increment. A literal costs the same whatever the gap lengths,
//      so a long gap spreads over the block as short ones do.
// Then the kWarps histograms are summed into the chunk's 320 bins. Reads
// of the match stream clamp the slot to [0, C-1] and word reads to
// [0, W-1], as the TPU's SMEM reads clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 3;
constexpr int kBins = 320;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                   // consecutive gaps a thread takes
constexpr int kTile = kThreads * kPer;    // gaps a tile
constexpr int kStageWords = 16384;        // the span's words in shared memory: 64 KiB
constexpr int kSmemInts = kWarps * kBins + 2 * kTile + 1 + kStageWords;

__device__ __forceinline__ int bit_length(int x) { return x > 0 ? 32 - __clz(x) : 0; }

__device__ __forceinline__ int len_code(int mlen) {
  const int v = mlen - kMinMatch;
  if (v == 255) return 28;
  if (v < 8) return v;
  const int e = bit_length(v) - 3;
  return 4 + 4 * e + ((v >> e) & 3);
}

__device__ __forceinline__ int dist_code(int dist) {
  const int d = dist - 1;
  if (d < 4) return d;
  const int e = bit_length(d) - 2;
  return 2 * (e + 1) + ((d >> e) & 1);
}

// The chunk's bytes: words [w0, w1) from the stage, the others from
// device memory at a clamped index.
struct Bytes {
  const uint32_t* __restrict__ w;
  int W;
  const uint32_t* stage;
  int w0, w1;

  __device__ __forceinline__ int at(int p) const {
    const int wi = p >> 2;
    const uint32_t x =
        wi >= w0 && wi < w1 ? stage[wi - w0] : __ldg(w + min(max(wi, 0), W - 1));
    return (int)((x >> ((p & 3) << 3)) & 0xFFu);
  }
};

// Exclusive sum scan of one int a thread, in thread order; *total gets
// the block's sum. Every thread of the block calls it.
__device__ int block_excl_sum(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int z = lane < kWarps ? tmp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, z, d);
      if (lane >= d) z += y;
    }
    if (lane < kWarps) tmp[lane] = z;
  }
  __syncthreads();
  *total = tmp[kWarps - 1];
  return x - v + (warp ? tmp[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads, 1)
freq_kernel(const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ mpos,
            const uint32_t* __restrict__ mld, int C, const int32_t* __restrict__ meta,
            int32_t* __restrict__ freq) {
  extern __shared__ int smem[];
  int* hist = smem;                   // [kWarps][kBins]
  int* gap_a = hist + kWarps * kBins;  // [kTile]: each gap's first byte
  int* gap_off = gap_a + kTile;       // [kTile + 1]: its first literal in the tile's run
  uint32_t* stage = (uint32_t*)(gap_off + kTile + 1);
  __shared__ int tmp[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const uint32_t* wrow = words + (long long)row * W;
  const int32_t* mp = mpos + (long long)row * C;
  const uint32_t* md = mld + (long long)row * C;
  const int32_t* m = meta + (long long)row * 8;
  const int n_valid = m[0], start = m[1], nmatch = max(m[2], 0);

  // stage the words of [start, n_valid), up to kStageWords of them
  const int w0 = min(max(start >> 2, 0), W);
  const int w1 = max(min((n_valid >> 2) + 1, min(W, w0 + kStageWords)), w0);
  for (int i = tid; i < w1 - w0; i += kThreads) stage[i] = __ldg(wrow + w0 + i);
  for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  const Bytes bytes{wrow, W, stage, w0, w1};
  int* wh = hist + (tid >> 5) * kBins;

  auto slot = [&](int k) { return min(max(k, 0), C - 1); };
  auto match_end = [&](int k) {  // end of match k; `start` before the first
    if (k < 0) return start;
    const int s = slot(k);
    return mp[s] + (int)(__ldg(md + s) >> 15) + kMinMatch;
  };
  __syncthreads();

  for (int t0 = 0; t0 <= nmatch; t0 += kTile) {
    const int ng = min(kTile, nmatch - t0 + 1);  // gaps of this tile
    // 1. codes, gaps and their places
    int a[kPer], len[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid * kPer + i, k = t0 + j;
      a[i] = 0;
      len[i] = 0;
      if (j < ng) {
        int b = n_valid;
        if (k < nmatch) {
          const int s = slot(k);
          const uint32_t x = __ldg(md + s);
          atomicAdd(&wh[min(257 + len_code((int)(x >> 15) + kMinMatch), kBins - 1)], 1);
          atomicAdd(&wh[288 + dist_code((int)(x & 0x7FFFu) + 1)], 1);
          b = mp[s];
        }
        a[i] = match_end(k - 1);
        len[i] = max(b - a[i], 0);
      }
      sum += len[i];
    }
    int total;
    int off = block_excl_sum(sum, tmp, &total);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = tid * kPer + i;
      if (j < ng) {
        gap_a[j] = a[i];
        gap_off[j] = off;
      }
      off += len[i];
    }
    if (tid == 0) gap_off[ng] = total;
    __syncthreads();

    // 2. literals: this thread's share [lo, hi) of the tile's run
    const int per = (total + kThreads - 1) / kThreads;
    const int lo = (int)min((long long)tid * per, (long long)total);
    const int hi = min(lo + per, total);
    if (lo < hi) {
      int j = 0, top = ng - 1;  // the last gap whose first literal is at or before lo
      while (j < top) {
        const int mid = (j + top + 1) >> 1;
        if (gap_off[mid] <= lo) j = mid;
        else top = mid - 1;
      }
      int p = gap_a[j] + (lo - gap_off[j]);
      int left = gap_off[j + 1] - lo;
      int run_b = 0, run_n = 0;
      for (int i = lo; i < hi; ++i) {
        while (left == 0) {  // the next gap that holds a literal
          ++j;
          p = gap_a[j];
          left = gap_off[j + 1] - gap_off[j];
        }
        const int b = bytes.at(p);
        if (b != run_b && run_n) {
          atomicAdd(&wh[run_b], run_n);
          run_n = 0;
        }
        run_b = b;
        ++run_n;
        ++p;
        --left;
      }
      if (run_n) atomicAdd(&wh[run_b], run_n);
    }
    __syncthreads();
  }

  // merge the warps' histograms
  int32_t* f = freq + (long long)row * kBins;
  for (int b = tid; b < kBins; b += kThreads) {
    int s = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) s += hist[w * kBins + b];
    f[b] = s;
  }
}

}  // namespace

extern "C" int zrs_freq(const void* words, int W, const void* mpos, const void* mld, int C,
                        const void* meta, void* freq, int batch, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(freq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  freq_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, W, (const int32_t*)mpos, (const uint32_t*)mld, C,
      (const int32_t*)meta, (int32_t*)freq);
  return (int)cudaGetLastError();
}
