// Flash-attention forward for Hopper (sm_90a) on the tensor cores, at fp32
// accuracy; plain C interface for ctypes.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_ops.py::_flash_attention_pallas
// (:54, pl.pallas_call at :139).  Same function: softmax(scale * q k^T) v per
// (batch, head), q pre-scaled as pallas_ops.py:86 does, optional causal mask
// whose diagonal is shifted by `causal_offset` (0 for True/'top', Tk - Tq for
// 'bottom'), masked scores set to -1e30, online softmax with an fp32 running
// max / sum / accumulator, output in q's dtype.
//
// Bounds on an H100 SXM at the serving shape (B, H, T, D) = (8, 12, 1024,
// 64), causal, fp32: 4*D flops per visible (query, key) pair = 12.9 GFLOP.
//   * on the CUDA cores (67 TFLOP/s fp32):                        0.192 ms
//   * as three TF32 tensor-core passes (3 x 12.9 GFLOP / 495 TFLOP/s):
//                                                                 0.078 ms
//   * bytes, q/k/v read and o written once (100.7 MB / 3.35 TB/s): 0.030 ms
// This kernel takes the tensor-core route, so 0.078 ms is its bound.
//
// Products: mma.sync.m16n8k8 tf32 with fp32 accumulation, three passes.
// Each fp32 operand x is split into big = x rounded to TF32 and
// small = x - big; a product sums big*big + big*small + small*big
// (small*small, ~2^-22 relative, is dropped).  One TF32 pass alone errs by
// ~1e-3, far beyond the 2e-5 the kernel is held to.  The split takes three
// integer/fp32 ops (see split()): cvt.rna.tf32.f32 compiles to five, and
// the kernel issues instructions at well under one a cycle, so every op of
// the split, done for each K and V element by each of the 4 warps, shows in
// its time.
//
// Layout: a block is 4 warps and owns BQ = 64 query rows of one (b, h); each
// warp owns 16 rows (one m16 tile).  K/V tiles of BK = 64 keys are staged in
// shared memory as fp32 with a row stride of D + 4 floats, in two stages:
// tile j + 1 is copied while tile j computes.  How a tile is copied is
// chosen per launch: 16-byte cp.async.cg for fp32 inputs whose base pointers
// and (B, H, T) strides are 16-byte multiples (the served head views are),
// and loads widened to fp32 and stored by the threads for bf16 and any other
// fp32 input.
//
// Fragments of m16n8k8 tf32, g = lane / 4, t = lane % 4:
//   A: a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)
//   B: b0 = (k = t, n = g), b1 = (k = t+4, n = g)
//   C: c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t), c3 = (g+8, 2t+1)
// S = Q K^T for the 8 keys j0..j0+7 leaves a thread P[g][j0+2t],
// P[g][j0+2t+1], P[g+8][j0+2t], P[g+8][j0+2t+1].  P V takes those 8 keys as
// one k8 step with its keys permuted, k-index t -> key j0+2t and k-index
// t+4 -> key j0+2t+1, so that P's A fragment is the accumulator as it lies:
//   a0 = c0, a1 = c2, a2 = c1, a3 = c3,
//   b0 = V[j0+2t][d0+g], b1 = V[j0+2t+1][d0+g].
// A sum over keys does not depend on their order.  The softmax's row max and
// row sum reduce over the 4 threads of a quad (__shfl_xor_sync 1, 2).
//
// Shared-memory banks with the D + 4 stride (D + 4 = 4 mod 32 for D = 32,
// 64, 128; 20 mod 32 for D = 16): K's B loads hit bank (4g + t) mod 32
// (D = 16: (20g + t) mod 32), V's permuted loads (8t + g) mod 32 for every D,
// Q's A loads (4g + t) mod 32: 32 distinct banks for each warp-wide load.
//
// Q (pre-scaled) is split once per block and kept as fragments in registers
// for D <= 64; for D = 128 it stays in shared memory and is split as it is
// read, since its fragments, the accumulator and the scores would not fit
// in 255 registers.  K/V fragments are split as they are read.
//
// Registers (ptxas -v, sm_90a), no spills in any instance:
//   fp32, 16-byte cp.async, D = 16/32/64/128: 139/167/213/199;
//   fp32, widened loads,    D = 16/32/64/128: 135/163/210/194;
//   bf16,                   D = 16/32/64/128: 137/163/210/196.
// Dynamic shared memory a block: 25,600/46,080/87,040/168,960 bytes, so two
// blocks (8 warps) share an SM for D <= 64 and one for D = 128.
//
// Ragged T / Tk are masked here (key < Tk, query < T), so the wrapper pads
// nothing; tiles wholly inside the visible region skip the mask.  The causal
// key loop stops at the last key any row of the block sees, and the longest
// causal q tiles launch first.  q/k/v are read through their (B, H, T)
// strides with D contiguous; o is contiguous (B, H, T, D).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per shared-memory tile
constexpr int kThreads = 128;         // 4 warps x 16 rows
constexpr float kMasked = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 does, in two integer ops where cvt takes five); small =
// x - big is exact in fp32 and goes to the tensor core as it is, which reads
// its top 19 bits (rounding toward zero, an error below 2^-21 |x|).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b, m16n8k8, tf32 inputs, fp32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at fp32 accuracy from (big, small) halves of a and b
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab,
                                     const uint32_t* as, const uint32_t* bb,
                                     const uint32_t* bs) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
}

// Asynchronous 16-byte copy from global to shared memory; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(n) : "memory");
}

// How a K/V tile reaches shared memory, chosen per launch by dtype and
// alignment: 16-byte cp.async (fp32 whose base pointers and (B, H, T)
// strides are 16-byte multiples), or synchronous loads widened to fp32 (bf16
// and any other fp32).
enum Staging { kAsync16, kWiden };

// Stage keys k0..k0+BK-1 of K and V into shared memory as fp32, rows past
// Tk as zeros.  The cp.async path only issues the copies.
template <typename T, int D, Staging S>
__device__ __forceinline__ void stage_tile(float* ks, float* vs, const T* kb,
                                           const T* vb, long long skt,
                                           long long svt, int k0, int Tk) {
  constexpr int LD = D + 4;
  if constexpr (S == kAsync16) {
    constexpr int CPR = D / 4;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 4;
      const int kp = k0 + r;
      const bool in = kp < Tk;
      cp_async16(ks + r * LD + col, in ? kb + kp * skt + col : kb, in);
      cp_async16(vs + r * LD + col, in ? vb + kp * svt + col : vb, in);
    }
  } else {
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const int kp = k0 + r;
      const bool in = kp < Tk;
      ks[r * LD + col] = in ? to_float(kb[kp * skt + col]) : 0.f;
      vs[r * LD + col] = in ? to_float(vb[kp * svt + col]) : 0.f;
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return (BQ + 4 * BK) * (D + 4) * 4;  // Q, then two stages of K and V
}

template <typename T, int D, Staging S>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int Tq, int Tk, long long sqb, long long sqh,
                           long long sqt, long long skb, long long skh,
                           long long skt, long long svb, long long svh,
                           long long svt, int causal, int causal_offset,
                           float scale) {
  constexpr int LD = D + 4;
  constexpr int KD = D / 8;      // k8 steps over D in S; n8 tiles of O
  constexpr int NJ = BK / 8;     // 8-key steps per tile
  constexpr bool kQInRegs = D <= 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // BQ x LD, pre-scaled q
  float* kvs = qs + BQ * LD;     // 2 stages x (K, V) x BK x LD

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // longest causal q tiles first: the tail of the grid is short tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;             // the warp's first row in the tile
  const int row0 = q0 + wr + g;         // this thread's rows: row0, row0 + 8

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // keys any row of this block can see
  int n_keys = Tk;
  if (causal) {
    const int last_q = min(Tq, q0 + BQ) - 1;
    n_keys = max(0, min(Tk, last_q + causal_offset + 1));
  }
  const int n_tiles = (n_keys + BK - 1) / BK;
  if (n_tiles > 0)
    stage_tile<T, D, S>(kvs, kvs + BK * LD, kb, vb, skt, svt, 0, Tk);
  cp_async_commit();

  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, col = e % D;
    const int qp = q0 + r;
    qs[r * LD + col] = qp < Tq ? to_float(qb[qp * sqt + col]) * scale : 0.f;
  }
  __syncthreads();

  // Q's A fragments, (big, small), for D <= 64
  uint32_t qf[kQInRegs ? KD : 1][2][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float* qr = qs + (wr + g) * LD + kk * 8 + t;
      split(qr[0], qf[kk][0][0], qf[kk][1][0]);
      split(qr[8 * LD], qf[kk][0][1], qf[kk][1][1]);
      split(qr[4], qf[kk][0][2], qf[kk][1][2]);
      split(qr[8 * LD + 4], qf[kk][0][3], qf[kk][1][3]);
    }
  }

  // the last key the warp's first row sees: tiles up to it need no mask
  const int warp_first_key_limit = q0 + wr + causal_offset;

  float o_acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m0 = kMasked, m1 = kMasked;  // running max of rows row0, row0 + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    // the next tile loads into the other stage while this one computes;
    // the barrier that ended the previous step freed that stage
    if (it + 1 < n_tiles) {
      float* next = kvs + ((it + 1) & 1) * 2 * BK * LD;
      stage_tile<T, D, S>(next, next + BK * LD, kb, vb, skt, svt, k0 + BK,
                          Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile `it` have landed
    __syncthreads();     // and everyone's
    const float* ks = kvs + (it & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;

    // S = Q K^T for the tile's 64 keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qf[kk][0][e];
          as[e] = qf[kk][1][e];
        }
      } else {
        const float* qr = qs + (wr + g) * LD + kk * 8 + t;
        split(qr[0], ab[0], as[0]);
        split(qr[8 * LD], ab[1], as[1]);
        split(qr[4], ab[2], as[2]);
        split(qr[8 * LD + 4], ab[3], as[3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kr = ks + (j * 8 + g) * LD + kk * 8 + t;
        uint32_t bb[2], bs[2];
        split(kr[0], bb[0], bs[0]);
        split(kr[4], bb[1], bs[1]);
        mma3(s[j], ab, as, bb, bs);
      }
    }

    const bool need_mask =
        k0 + BK > Tk || (causal && k0 + BK - 1 > warp_first_key_limit);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          const bool keep =
              kp < Tk && (!causal || kp <= qp + causal_offset);
          if (!keep) s[j][e] = kMasked;
        }
      }
    }

    // online softmax
    float mt0 = kMasked, mt1 = kMasked;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mt0 = fmaxf(mt0, fmaxf(s[j][0], s[j][1]));
      mt1 = fmaxf(mt1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, w));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, w));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      o_acc[n][0] *= alpha0;
      o_acc[n][1] *= alpha0;
      o_acc[n][2] *= alpha1;
      o_acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = exp2f((s[j][0] - m0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - m0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - m1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - m1) * kLog2e);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V, P straight from the accumulator (keys permuted in-step)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
      const float* vr = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        uint32_t bb[2], bs[2];
        split(vr[n * 8], bb[0], bs[0]);
        split(vr[LD + n * 8], bb[1], bs[1]);
        mma3(o_acc[n], pb, ps, bb, bs);
      }
    }
    __syncthreads();  // stage `it & 1` consumed before it is refilled
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  T* ob = o + (long long)bh * Tq * D;
  if (row0 < Tq) {
#pragma unroll
    for (int n = 0; n < KD; ++n)
      store2(ob + (long long)row0 * D + n * 8 + 2 * t, o_acc[n][0] * inv0,
             o_acc[n][1] * inv0);
  }
  if (row0 + 8 < Tq) {
#pragma unroll
    for (int n = 0; n < KD; ++n)
      store2(ob + (long long)(row0 + 8) * D + n * 8 + 2 * t,
             o_acc[n][2] * inv1, o_acc[n][3] * inv1);
  }
}

// base pointer and (B, H, T) strides (elements of 4 bytes) 16-byte multiples
bool aligned16(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % 4 != 0) return false;
  return true;
}

template <typename T, int D, Staging S>
int launch_staged(const void* q, const void* k, const void* v, void* o, int B,
                  int H, int Tq, int Tk, const long long* st, int causal,
                  int causal_offset, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  auto kernel = flash_attention_fwd_kernel<T, D, S>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Tq, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, causal_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Tq, int Tk, const long long* st, int causal, int causal_offset,
           float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (aligned16(k, st + 3) && aligned16(v, st + 6))
      return launch_staged<T, D, kAsync16>(q, k, v, o, B, H, Tq, Tk, st,
                                           causal, causal_offset, scale,
                                           stream);
  }
  return launch_staged<T, D, kWiden>(q, k, v, o, B, H, Tq, Tk, st, causal,
                                     causal_offset, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Tq, int Tk, int D, const long long* st, int causal,
             int causal_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Tq, Tk, st, causal,
                                  causal_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Tq, Tk, st, causal,
                                  causal_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Tq, Tk, st, causal,
                                  causal_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Tq, Tk, st, causal,
                                    causal_offset, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Strides are in elements: (sqb, sqh, sqt, skb, skh, skt, svb, svh, svt).
// Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, int causal, int causal_offset, float scale, void* stream) {
  const long long st[9] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, Tq, Tk, D, st, causal,
                           causal_offset, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Tq, Tk, D, st, causal,
                                   causal_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
