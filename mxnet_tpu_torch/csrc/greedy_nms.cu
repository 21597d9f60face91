// Greedy non-maximum suppression for Hopper (sm_90a): the IoU and the scan.
//
// It replaces no Pallas kernel.  The JAX package writes greedy NMS as one
// lax.fori_loop over the score-sorted boxes in three ops
// (mxnet_tpu/ops/contrib_ops.py: _contrib_MultiBoxDetection :253,
// _contrib_box_nms :298, _contrib_Proposal :515), with the IoU fused into
// the computation (:244-253, :289-298) or the loop body (:504-515); XLA
// compiles each into one device-side while loop.  These two kernels are
// the counterpart of the whole of it: from the boxes to the keep mask.
//
// What they compute, for each batch row b, with sup[b, j, i] "box j, if
// kept, suppresses box i" (j < i):
//   keep[b, i] = init[b, i] && !any_{j < i} (keep[b, j] && sup[b, j, i])
// in order of i.  sup is the ops' IoU above thresh (in the boxes' dtype),
// and in the corner form the same class id where ids are given.  Two
// forms, the port's torch ops operation for operation
// (mxnet_tpu_torch/ops/nms_ops.py), a = row j, b = column i:
//   corner (box_iou_xyxy):  iw = max(min(a2,b2) - max(a0,b0), 0), ih alike,
//     inter = iw*ih, area = max(x2-x0,0)*max(y2-y0,0),
//     iou = inter / max((area_a + area_b) - inter, 1e-12);
//   proposal (proposal_mask): iw = max((min(a2,b2) - max(a0,b0)) + 1, 0),
//     ih alike, area = ((x2-x0)+1)*((y2-y0)+1),
//     iou = inter / ((area_a + area_b) - inter).
// Bit-equality with the torch ops is the contract, so every operation is
// rounded on its own (Arith below): in float32 and float64 by the IEEE
// operations __fadd_rn/__dadd_rn and their kin, which are never contracted
// into an FMA; in float16 and bfloat16 in float32 and then to the dtype,
// as torch's ops compute them.  min and max propagate NaN as
// torch.minimum/maximum do (PTX min.NaN/max.NaN; fminf/fmaxf would drop
// it), and `iou > thresh` is decided as the correctly rounded quotient
// would be (below), against thresh rounded to the dtype.
//
// What it replaces in the port.  Until this design the ops built sup in
// ~10 fp32 torch ops over K x K (the SSD's detection call: 6.4 GB of
// temporaries and a 1.6 GB bool mask, 97% of the call), a pack pass read
// all of its upper triangle into words, and a scan resolved 64
// candidates at a time on one thread.
//
// What bounds it.  The recurrence needs, on a run's data, each kept row's
// IoUs with the later candidates: fp32 CUDA-core work (14-16 operations
// an IoU).  The bytes (boxes, ids, init in; keep out) are a few MB.
//
// Design.  Two kernels on the current stream:
//   1. nms_words: one block a 64 x 64 tile of the relation's upper
//      triangle (row tile r, column tile c >= r, batch b; the grid walks
//      the triangle's tiles, none below it).  Each of the block's 64
//      threads owns a column and walks the tile's 64 rows, staged in
//      shared memory; a warp's ballot gives a row's 32 bits of the warp's
//      columns, and the rows go out as 64-bit words: words[b, j, c], bit
//      t = column 64 c + t, set only for i > j.  No K x K float or bool
//      tensor is made: the words are B * K * ceil(K / 64) * 8 bytes.  It
//      computes all of the triangle's IoUs, not only the kept rows' (the
//      scan would have to wait for each), so its fp32 work is the cost,
//      and (float32 boxes) the division goes only where it could change
//      the answer: with thresh in [2^-20, 2^20] and the union u positive (the corner
//      form's is at least 1e-12f; Proposal's must be at least 2^-100),
//      inter > u * thresh * (1 + 2^-16) (each product rounded) proves the
//      rounded quotient above thresh, and inter < u * thresh * (1 - 2^-16)
//      proves it not (the margin is 2^7 times the rounding errors);
//      anything else (NaN, inf, a tie within the margin) takes __fdiv_rn,
//      the IEEE quotient torch computes, in a branch a warp takes only
//      when one of its lanes needs it.  The other dtypes always divide.
//   2. nms_scan: one block a batch row keeps the `removed` bit set of its
//      K candidates in shared memory (K / 64 words) and walks the
//      candidates 64 at a time, one barrier a chunk.  Warp 0 resolves
//      chunk c on registers: it transposes the chunk's 64 diagonal words
//      (shuffles) so that each lane holds, for its two candidates, the
//      earlier candidates that would suppress them, then decides in
//      rounds (a candidate a kept one suppresses is removed, one whose
//      suppressors are all decided and none kept is kept): as many rounds
//      as the longest chain of undecided suppressors, not one a
//      candidate.  Meanwhile warps 1-15 OR the kept rows of chunk c - 1
//      into the words past chunk c (a warp reads 256 contiguous bytes of
//      a row), and warps 1-2 stage chunk c + 1's diagonal words and the
//      words after them with cp.async; chunk c - 1's kept rows reach word
//      c through those staged words.  The scan reads only the kept rows'
//      words past their diagonal and each chunk's two staged words a row.
//      At B = 1 (a proposal layer) one SM works.  Splitting a row's words
//      over a thread-block cluster has not been tried on this scan (a
//      cluster split of an earlier, serial one-thread walk was slower than
//      that walk on one block).
//
// Limits: 1 <= K <= 65536 (the removed set lives in 8 KB of static shared
// memory), B >= 1.  The wrapper (mxnet_tpu_torch/ops/nms_ops.py) checks
// both, allocates the words and the output, and raises on a nonzero
// return.  Nothing is allocated here and nothing synchronises, so both
// launches are capturable in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxK = 65536;
constexpr int kMaxWords = kMaxK / 64;
constexpr int kTile = 64;          // rows and columns of a words tile
constexpr int kScanThreads = 512;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The arithmetic of boxes of dtype T, as torch's ops do it: compute type
// C, each operation rounded to T on its own.  kQuotientFree: the division
// may be skipped where a product test decides (float32 only).
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using C = float;
  static constexpr bool kQuotientFree = true;
  static __device__ __forceinline__ C load(float x) { return x; }
  static __device__ __forceinline__ C add(C a, C b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ C mul(C a, C b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ C max(C a, C b) { return max_nan(a, b); }
  static __device__ __forceinline__ C min(C a, C b) { return min_nan(a, b); }
  static __device__ __forceinline__ C floor() { return 1e-12f; }
};

template <>
struct Arith<double> {
  using C = double;
  static constexpr bool kQuotientFree = false;
  static __device__ __forceinline__ C load(double x) { return x; }
  static __device__ __forceinline__ C add(C a, C b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ C mul(C a, C b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ C max(C a, C b) {
    return a != a || b != b ? __dadd_rn(a, b) : fmax(a, b);
  }
  static __device__ __forceinline__ C min(C a, C b) {
    return a != a || b != b ? __dadd_rn(a, b) : fmin(a, b);
  }
  static __device__ __forceinline__ C floor() { return 1e-12; }
};

struct HalfConv {
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

struct Bf16Conv {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// float16 and bfloat16: each operation in float32, then rounded to the
// dtype (min and max of two such values are exact)
template <typename T, typename Conv>
struct ArithRounded {
  using C = float;
  static constexpr bool kQuotientFree = false;
  static __device__ __forceinline__ C load(T x) { return Conv::load(x); }
  static __device__ __forceinline__ C add(C a, C b) {
    return Conv::round(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ C sub(C a, C b) {
    return Conv::round(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ C mul(C a, C b) {
    return Conv::round(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ C div(C a, C b) {
    return Conv::round(__fdiv_rn(a, b));
  }
  static __device__ __forceinline__ C max(C a, C b) { return max_nan(a, b); }
  static __device__ __forceinline__ C min(C a, C b) { return min_nan(a, b); }
  static __device__ __forceinline__ C floor() { return Conv::round(1e-12f); }
};

template <>
struct Arith<__half> : ArithRounded<__half, HalfConv> {};
template <>
struct Arith<__nv_bfloat16> : ArithRounded<__nv_bfloat16, Bf16Conv> {};

template <typename C>
struct alignas(4 * sizeof(C)) Box {
  C x, y, z, w;
};

// A row's area and id, staged together
template <typename C, typename Id>
struct alignas(2 * (sizeof(C) > sizeof(Id) ? sizeof(C) : sizeof(Id))) AreaId {
  C area;
  Id id;
};

template <typename T>
__device__ __forceinline__ Box<typename Arith<T>::C> load_box(const T* p) {
  using A = Arith<T>;
  return {A::load(p[0]), A::load(p[1]), A::load(p[2]), A::load(p[3])};
}

template <bool kProposal, typename A, typename C>
__device__ __forceinline__ C box_area(Box<C> x) {
  if (kProposal)
    return A::mul(A::add(A::sub(x.z, x.x), C(1)),
                  A::add(A::sub(x.w, x.y), C(1)));
  return A::mul(A::max(A::sub(x.z, x.x), C(0)),
                A::max(A::sub(x.w, x.y), C(0)));
}

// The threshold in the compute type, and (float32) the thresholds of the
// quotient-free test: thresh * (1 +- 2^-16), each rounded; +-inf (every
// pair open) where thresh lies outside [2^-20, 2^20].
template <typename C>
struct Thresh {
  C t;
  float hi, lo;
};

// The overlap of boxes a (row j) and b (column i): inter and the union,
// each operation rounded on its own.
template <bool kProposal, typename A, typename C>
__device__ __forceinline__ void overlap(Box<C> a, C area_a, Box<C> b,
                                        C area_b, C* inter, C* uni) {
  C iw = A::sub(A::min(a.z, b.z), A::max(a.x, b.x));
  C ih = A::sub(A::min(a.w, b.w), A::max(a.y, b.y));
  if (kProposal) {
    iw = A::add(iw, C(1));
    ih = A::add(ih, C(1));
  }
  *inter = A::mul(A::max(iw, C(0)), A::max(ih, C(0)));
  *uni = A::sub(A::add(area_a, area_b), *inter);
  if (!kProposal) *uni = A::max(*uni, A::floor());
}

// The quotient-free test of inter / uni > t (float32): *yes where it
// proves the rounded quotient above t, *open where it proves neither that
// nor the opposite (then the quotient decides).  The corner form's union
// is at least 1e-12f or NaN, so its products stay normal or overflow,
// which the bounds cover; Proposal's union can be 0, negative or
// subnormal, which stay open.
template <bool kProposal>
__device__ __forceinline__ void decide(float inter, float uni,
                                       const Thresh<float>& th, bool* yes,
                                       bool* open) {
  bool y = inter > __fmul_rn(uni, th.hi);
  bool n = inter < __fmul_rn(uni, th.lo);
  if (kProposal) {
    const bool normal = uni >= 0x1p-100f;
    y = y && normal;
    n = n && normal;
  }
  *yes = y;
  *open = !(y || n);
}

// Row tile r and column tile c of the p-th tile of the upper triangle of
// a W x W tile grid, in row order: row r starts at S(r) = r W - r (r-1) / 2.
__device__ __forceinline__ void triangle_tile(long long p, int W, int* r,
                                              int* c) {
  const double wh = W + 0.5;
  int row = (int)(wh - sqrt(wh * wh - 2.0 * (double)p));
  auto start = [W](long long q) { return q * W - q * (q - 1) / 2; };
  if (row < 0) row = 0;
  if (row > W - 1) row = W - 1;
  while (row > 0 && start(row) > p) --row;
  while (row < W - 1 && start(row + 1) <= p) ++row;
  *r = row;
  *c = row + (int)(p - start(row));
}

// One block a tile: thread t owns column 64 c + t and walks the tile's 64
// rows (staged in shared memory); each row's test is one ballot a warp,
// which gives the row's 32 bits of that warp's columns.
template <typename T, typename Id, bool kProposal, bool kIds>
__global__ void __launch_bounds__(kTile)
nms_words(const T* __restrict__ boxes, const Id* __restrict__ ids,
          unsigned long long* __restrict__ words, int B, int K, int W,
          Thresh<typename Arith<T>::C> th) {
  using A = Arith<T>;
  using C = typename A::C;
  __shared__ Box<C> row_box[kTile];
  __shared__ AreaId<C, Id> row_area_id[kTile];
  __shared__ unsigned row_bits[2][kTile];   // [warp][row]
  int r, c;
  triangle_tile(blockIdx.x, W, &r, &c);
  const int t = threadIdx.x, lane = t & 31, half = t >> 5;
  const int j = r * kTile + t;       // the row this thread stages and writes
  const int i = min(c * kTile + t, K - 1);   // its column (past K: masked)
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* bx = boxes + (long long)b * K * 4;
    const Id* bid = kIds ? ids + (long long)b * K : nullptr;
    __syncthreads();   // the previous batch row's tile is written out
    if (j < K) {
      const Box<C> x = load_box(bx + j * 4);
      row_box[t] = x;
      row_area_id[t] = {box_area<kProposal, A>(x), kIds ? bid[j] : Id(0)};
    }
    __syncthreads();
    const Box<C> col = load_box(bx + i * 4);
    const C area_col = box_area<kProposal, A>(col);
    const Id id_col = kIds ? bid[i] : Id(0);
#pragma unroll 16
    for (int u = 0; u < kTile; ++u) {
      const AreaId<C, Id> ra = row_area_id[u];
      C inter, uni;
      overlap<kProposal, A>(row_box[u], ra.area, col, area_col, &inter, &uni);
      bool yes = false, open = true;
      if constexpr (A::kQuotientFree)
        decide<kProposal>(inter, uni, th, &yes, &open);
      if (kIds) {
        const bool same = ra.id == id_col;
        yes = yes && same;
        open = open && same;
      }
      unsigned bits = __ballot_sync(0xffffffffu, yes);
      if (__ballot_sync(0xffffffffu, open)) {   // the quotient decides
        if (open) yes = A::div(inter, uni) > th.t;
        bits = __ballot_sync(0xffffffffu, yes);
      }
      if (lane == 0) row_bits[half][u] = bits;
    }
    __syncthreads();
    if (j < K) {
      unsigned long long word =
          row_bits[0][t] | (unsigned long long)row_bits[1][t] << 32;
      const int ncol = K - c * kTile;   // columns of this tile inside K
      if (ncol < kTile) word &= (1ull << ncol) - 1;
      if (c == r) word &= t == kTile - 1 ? 0ull : ~0ull << (t + 1);  // i > j
      words[((long long)b * K + j) * W + c] = word;
    }
  }
}

// The transpose of a 32 x 32 bit matrix held one row a lane: returns, for
// lane t, the bits s = 0..31 of row s's bit t (recursive block swaps).
__device__ __forceinline__ unsigned transpose_bits(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const unsigned m = masks[k];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

// One block a batch row: warp 0 resolves chunk c while warps 1-15 OR the
// kept rows of chunk c - 1 into the words past chunk c, and warps 1-2
// stage chunk c + 1's diagonal and next words.  Word c of chunk c - 1's
// kept rows (the only one chunk c needs from them) comes from those staged
// next words, so one barrier a chunk orders it all.
__global__ void __launch_bounds__(kScanThreads)
nms_scan(const unsigned long long* __restrict__ words,
         const unsigned char* __restrict__ init,
         unsigned char* __restrict__ keep, int K, int W) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long diag[2][kTile];   // row 64 c + t's word c
  __shared__ unsigned long long next[2][kTile];   // and its word c + 1
  __shared__ int kept_rows[2][kTile];
  __shared__ int kept_count[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const unsigned long long* base = words + b * K * (long long)W;
  const unsigned char* in = init + b * K;
  unsigned char* out = keep + b * K;
  const bool stager = tid >= 32 && tid < 32 + kTile;
  const int st = tid - 32;
  auto stage = [&](int c) {
    const int j = c * kTile + st;
    const unsigned long long* row = base + (long long)j * W;
    if (j < K) cp_async8(&diag[c & 1][st], row + c);
    else diag[c & 1][st] = 0ull;
    if (j < K && c + 1 < W) cp_async8(&next[c & 1][st], row + c + 1);
    else next[c & 1][st] = 0ull;
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (stager) stage(0);
  // a candidate that is not in `init` (or lies past K) starts removed: it
  // is never kept, so it suppresses nothing
  for (int i = tid; i < W * 64; i += kScanThreads) {
    const unsigned bits = __ballot_sync(0xffffffffu, i >= K || !in[i]);
    if (lane == 0) reinterpret_cast<unsigned*>(removed)[i >> 5] = bits;
  }
  if (stager) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  unsigned long long carry = 0;   // chunk c - 1's kept rows' word c
  for (int c = 0; c < W; ++c) {
    const int buf = c & 1;
    if (warp == 0) {
      const unsigned long long d0 = diag[buf][lane];
      const unsigned long long d1 = diag[buf][lane + 32];
      // lane t's candidates t and t + 32, and the earlier candidates of
      // the chunk that would suppress each (the diagonal words' columns)
      const unsigned col_lo = transpose_bits((unsigned)d0, lane);
      const unsigned long long col_hi =
          transpose_bits((unsigned)(d0 >> 32), lane) |
          (unsigned long long)transpose_bits((unsigned)(d1 >> 32), lane)
              << 32;
      // in rounds: an open candidate that a kept one suppresses is
      // removed; one whose suppressors are all decided and none kept is
      // kept.  The lowest open candidate is decided in every round, so
      // the rounds are at most the chunk's open candidates, and as few as
      // the longest chain of open suppressors
      unsigned long long open = ~(removed[c] | carry), kept = 0;
      while (open) {
        const bool lo_in = (open >> lane) & 1ull;
        const bool hi_in = (open >> (lane + 32)) & 1ull;
        const bool lo_out = lo_in && (col_lo & (unsigned)kept);
        const bool hi_out = hi_in && (col_hi & kept);
        const bool lo_keep = lo_in && !lo_out && !(col_lo & (unsigned)open);
        const bool hi_keep = hi_in && !hi_out && !(col_hi & open);
        const unsigned long long now_kept =
            __ballot_sync(0xffffffffu, lo_keep) |
            (unsigned long long)__ballot_sync(0xffffffffu, hi_keep) << 32;
        const unsigned long long now_out =
            __ballot_sync(0xffffffffu, lo_out) |
            (unsigned long long)__ballot_sync(0xffffffffu, hi_out) << 32;
        kept |= now_kept;
        open &= ~(now_kept | now_out);
      }
      const int j0 = c * kTile + lane, j1 = j0 + 32;
      const bool k0 = (kept >> lane) & 1ull;
      const bool k1 = (kept >> (lane + 32)) & 1ull;
      if (j0 < K) out[j0] = k0;
      if (j1 < K) out[j1] = k1;
      if (k0) kept_rows[buf][__popcll(kept & ((1ull << lane) - 1))] = j0;
      if (k1)
        kept_rows[buf][__popcll(kept & ((1ull << (lane + 32)) - 1))] = j1;
      if (lane == 0) kept_count[buf] = __popcll(kept);
      const unsigned long long mine =
          (k0 ? next[buf][lane] : 0ull) | (k1 ? next[buf][lane + 32] : 0ull);
      carry = ((unsigned long long)__reduce_or_sync(
                   0xffffffffu, (unsigned)(mine >> 32)) << 32) |
              __reduce_or_sync(0xffffffffu, (unsigned)mine);
    } else {
      if (stager && c + 1 < W) stage(c + 1);
      // chunk c - 1's kept rows' words past c: worker v of 15 takes the
      // rows v, v + 15, ..., lane l the words 32 q + l (a warp reads 256
      // contiguous bytes of a row), 4 words a lane and 4 rows at a time
      const int n = c > 0 ? kept_count[buf ^ 1] : 0;
      const int w0 = c + 1, groups = (W - w0 + 31) >> 5;
      const int* rows = kept_rows[buf ^ 1];
      for (int q0 = 0; n > 0 && q0 < groups; q0 += 4) {
        unsigned long long acc[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll 4
        for (int k = warp - 1; k < n; k += kScanThreads / 32 - 1) {
          const unsigned long long* row = base + (long long)rows[k] * W;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int w = w0 + 32 * (q0 + u) + lane;
            if (w < W) acc[u] |= row[w];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          unsigned* half = reinterpret_cast<unsigned*>(
              &removed[w0 + 32 * (q0 + u) + lane]);
          if ((unsigned)acc[u]) atomicOr(half, (unsigned)acc[u]);
          if ((unsigned)(acc[u] >> 32))
            atomicOr(half + 1, (unsigned)(acc[u] >> 32));
        }
      }
      if (stager) asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
  }
}

// thresh holds a value of T (the wrapper rounds it), so the conversion to
// the compute type is exact
template <typename T>
Thresh<typename Arith<T>::C> make_thresh(double thresh) {
  Thresh<typename Arith<T>::C> th;
  th.t = (typename Arith<T>::C)thresh;
  const float t = (float)thresh;
  if (t >= 0x1p-20f && t <= 0x1p20f) {
    th.hi = t * (1.0f + 0x1p-16f);
    th.lo = t * (1.0f - 0x1p-16f);
  } else {
    th.hi = INFINITY;
    th.lo = -INFINITY;
  }
  return th;
}

template <typename T>
int launch_words(const void* boxes, const void* ids, int id_type,
                 void* words, int B, int K, double thresh, int form,
                 cudaStream_t s) {
  const int W = (K + kTile - 1) / kTile;
  const dim3 grid((unsigned)((long long)W * (W + 1) / 2),
                  (unsigned)(B < kMaxGridY ? B : kMaxGridY));
  const auto th = make_thresh<T>(thresh);
  const T* bx = (const T*)boxes;
  auto* out = (unsigned long long*)words;
  if (form == 1)
    nms_words<T, float, true, false><<<grid, kTile, 0, s>>>(
        bx, nullptr, out, B, K, W, th);
  else if (id_type == 0)
    nms_words<T, float, false, false><<<grid, kTile, 0, s>>>(
        bx, nullptr, out, B, K, W, th);
  else if (id_type == 1)
    nms_words<T, float, false, true><<<grid, kTile, 0, s>>>(
        bx, (const float*)ids, out, B, K, W, th);
  else
    nms_words<T, double, false, true><<<grid, kTile, 0, s>>>(
        bx, (const double*)ids, out, B, K, W, th);
  return (int)cudaGetLastError();
}

}  // namespace

// boxes: (B, K, 4) of box_type (0 float32, 1 float64, 2 float16,
// 3 bfloat16); ids: (B, K) of id_type (1 float32, 2 float64), or null
// with id_type 0 for no id test; thresh: a value of the boxes' dtype;
// words: (B, K, ceil(K / 64)) uint64, of which the tiles on and above the
// diagonal are written.  form 0 is corner, 1 proposal (no ids).  Returns
// 0, or the CUDA error of the launch.
extern "C" int mxt_greedy_nms_words(const void* boxes, const void* ids,
                                    void* words, int B, int K, double thresh,
                                    int form, int box_type, int id_type,
                                    void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || form < 0 || form > 1 || box_type < 0 ||
      box_type > 3 || id_type < 0 || id_type > 2 ||
      (id_type == 0) != (ids == nullptr) || (form == 1 && id_type != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (box_type) {
    case 0:
      return launch_words<float>(boxes, ids, id_type, words, B, K, thresh,
                                 form, s);
    case 1:
      return launch_words<double>(boxes, ids, id_type, words, B, K, thresh,
                                  form, s);
    case 2:
      return launch_words<__half>(boxes, ids, id_type, words, B, K, thresh,
                                  form, s);
    default:
      return launch_words<__nv_bfloat16>(boxes, ids, id_type, words, B, K,
                                         thresh, form, s);
  }
}

// words: as written by mxt_greedy_nms_words; init, keep: (B, K) bool.
// Returns 0, or the CUDA error of the launch.
extern "C" int mxt_greedy_nms_scan(const void* words, const void* init,
                                   void* keep, int B, int K, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int W = (K + kTile - 1) / kTile;
  nms_scan<<<B, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)words, (const unsigned char*)init,
      (unsigned char*)keep, K, W);
  return (int)cudaGetLastError();
}
