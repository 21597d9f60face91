// Greedy non-maximum suppression scan for Hopper (sm_90a).
//
// It replaces no Pallas kernel.  The JAX package writes greedy NMS as one
// lax.fori_loop over the score-sorted boxes in three ops
// (mxnet_tpu/ops/contrib_ops.py: _contrib_MultiBoxDetection :253,
// _contrib_box_nms :298, _contrib_Proposal :515), which XLA compiles into
// one device-side while loop.  Run as a Python loop of torch ops, the same
// scan costs several launches a step: tens of thousands for one SSD
// detection call.  This kernel is the counterpart of those loops.
//
// What it computes, for each batch row b:
//   keep[b, i] = init[b, i] && !any_{j < i} (keep[b, j] && sup[b, j, i])
// in order of i.  `sup` (B, K, K) and `init` (B, K) are bool (one byte a
// value); `keep` (B, K) is bool.  The caller builds `sup` with the op's own
// IoU formula in torch ops, so the kernel does no float arithmetic.
//
// Design.  Two kernels in one launch sequence:
//   1. pack: one warp a row (b, j) turns sup[b, j, i > j] into 64-bit words
//      (`__ballot_sync` over 32 coalesced bytes, twice a word).  Only the
//      words that hold some i > j are written: the scan reads no other.
//   2. scan: one block a batch row keeps the `removed` bit set of its K
//      candidates in shared memory (K / 64 words).  It walks the candidates
//      64 at a time.  Thread 0 resolves the 64 of a chunk against each
//      other from the chunk's diagonal words (a 64-step loop on registers);
//      then the block ORs the later words of every row kept in the chunk
//      into `removed`, one word a thread.
// The dependency chain is the K steps of the recurrence; the chunking
// turns it into K / 64 block-wide steps.  The scan reads only the rows of
// kept candidates (and every chunk's diagonal words), but the pack pass
// reads all of sup's upper triangle: the recurrence itself needs only the
// kept rows' bytes past their diagonal.
//
// Limits: 1 <= K <= 65536 (the removed set lives in 8 KB of static shared
// memory), B >= 1.  The wrapper (mxnet_tpu_torch/ops/nms_ops.py) checks
// both, allocates the packed words (B * K * ceil(K / 64) * 8 bytes) and
// the output, and raises on a nonzero return.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 65536;
constexpr int kMaxWords = kMaxK / 64;
constexpr int kPackThreads = 256;
constexpr int kScanThreads = 256;

__global__ void pack_rows(const unsigned char* __restrict__ sup,
                          unsigned long long* __restrict__ words,
                          long long rows, int K, int W) {
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = first; row < rows; row += stride) {
    const int j = (int)(row % K);
    const unsigned char* src = sup + row * (long long)K;
    unsigned long long* dst = words + row * (long long)W;
    for (int w = j >> 6; w < W; ++w) {
      const int i0 = w * 64 + lane;
      const int i1 = i0 + 32;
      const bool b0 = i0 > j && i0 < K && src[i0];
      const bool b1 = i1 > j && i1 < K && src[i1];
      const unsigned lo = __ballot_sync(0xffffffffu, b0);
      const unsigned hi = __ballot_sync(0xffffffffu, b1);
      if (lane == 0) dst[w] = ((unsigned long long)hi << 32) | lo;
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_rows(const unsigned long long* __restrict__ words,
          const unsigned char* __restrict__ init,
          unsigned char* __restrict__ keep, int K, int W) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long diag[64];
  __shared__ int kept_rows[64];
  __shared__ int kept_count;
  const long long b = blockIdx.x;
  const unsigned long long* base = words + b * K * (long long)W;
  const unsigned char* in = init + b * K;

  // a candidate that is not in `init` (or lies past K) starts removed: it
  // is never kept, so it suppresses nothing
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    unsigned long long r = 0;
    for (int t = 0; t < 64; ++t) {
      const int i = w * 64 + t;
      if (i >= K || !in[i]) r |= 1ull << t;
    }
    removed[w] = r;
  }
  __syncthreads();

  for (int c = 0; c < W; ++c) {
    if (threadIdx.x < 64) {
      const int j = c * 64 + threadIdx.x;
      diag[threadIdx.x] = j < K ? base[(long long)j * W + c] : 0ull;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // in order within the chunk: a kept row removes the later rows of
      // the chunk it suppresses (its diagonal word holds only bits > t)
      unsigned long long rem = removed[c];
      int n = 0;
      for (int t = 0; t < 64; ++t) {
        if (!((rem >> t) & 1ull)) {
          rem |= diag[t];
          kept_rows[n++] = c * 64 + t;
        }
      }
      removed[c] = rem;
      kept_count = n;
    }
    __syncthreads();
    const int n = kept_count;
    for (int w = c + 1 + threadIdx.x; w < W; w += blockDim.x) {
      unsigned long long acc = 0;
#pragma unroll 8
      for (int k = 0; k < n; ++k) acc |= base[(long long)kept_rows[k] * W + w];
      removed[w] |= acc;
    }
    __syncthreads();
  }

  unsigned char* out = keep + b * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    out[i] = !((removed[i >> 6] >> (i & 63)) & 1ull);
}

}  // namespace

// sup: (B, K, K) bool; init, keep: (B, K) bool; words: scratch of
// B * K * ceil(K / 64) uint64.  All contiguous, on the current device.
// Returns 0, or the CUDA error of the launch.
extern "C" int mxt_greedy_nms(const void* sup, const void* init, void* keep,
                              void* words, int B, int K, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int W = (K + 63) / 64;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)B * K;
  long long blocks = (rows * 32 + kPackThreads - 1) / kPackThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  pack_rows<<<(unsigned)blocks, kPackThreads, 0, s>>>(
      (const unsigned char*)sup, (unsigned long long*)words, rows, K, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_rows<<<B, kScanThreads, 0, s>>>(
      (const unsigned long long*)words, (const unsigned char*)init,
      (unsigned char*)keep, K, W);
  return (int)cudaGetLastError();
}
