// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_ops.py::_flash_attention_pallas
// (:54, pl.pallas_call at :139).  Same function: softmax(scale * q k^T) v per
// (batch, head), optional causal mask whose diagonal is shifted by
// `causal_offset` (0 for True/'top', Tk - Tq for 'bottom'), masked scores
// set to -1e30, online softmax with an fp32 running max / sum / accumulator,
// output in q's dtype.
//
// Bound on an H100 at the serving shape (B, H, T, D) = (8, 12, 1024, 64),
// causal, fp32: 4*D flops per visible (query, key) pair = 12.9 GFLOP, which
// at the card's 67 TFLOP/s fp32 (CUDA cores) is ~0.19 ms, against 100.7 MB
// of q/k/v/o traffic (~30 us at 3.35 TB/s).  So it is bound by operations.
//
// Design (a simple, correct first kernel; wgmma/TMA/warp specialisation are
// later work):
//   * one thread block per (b*h, tile of BQ = 64 query rows);
//   * each query row is owned by G = D/32 threads (1 for D <= 32); each
//     thread keeps its DPT = D/G dims of the pre-scaled q row and of the fp32
//     accumulator in registers, with the row's running max m and sum l;
//   * K/V tiles of BK = 32 keys are staged through shared memory as fp32
//     (bf16 is widened with __bfloat162float on the way in);
//   * a thread's dims are interleaved float4 chunks (chunk g, g+G, ...), so
//     the G threads of a row read neighbouring 16-byte words of a K/V row:
//     broadcast shared-memory reads without bank conflicts;
//   * partial q.k dots are summed across the G threads with __shfl_xor_sync;
//   * the causal key loop stops at the last key any row of the tile sees;
//     ragged T / Tk are masked here (k_pos < n_keys, q_pos < T), so the
//     wrapper pads nothing;
//   * q/k/v are read through their (B, H, T) strides with D contiguous, so
//     the model's head transpose needs no copy; o is contiguous (B, H, T, D).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // keys per shared-memory tile
constexpr float kMasked = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D > 32 ? D / 32 : 1))
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int Tq, int Tk, long long sqb, long long sqh,
                           long long sqt, long long skb, long long skh,
                           long long skt, long long svb, long long svh,
                           long long svt, int causal, int causal_offset,
                           float scale) {
  constexpr int DPT = D < 32 ? D : 32;  // dims per thread
  constexpr int G = D / DPT;            // threads per query row
  constexpr int NC = DPT / 4;           // float4 chunks per thread
  constexpr int NT = BQ * G;            // threads per block
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid / G, g = tid % G;
  const int q_pos = q0 + row;
  const bool live = q_pos < Tq;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (g + G * c) + e;
      qr[4 * c + e] = live ? to_float(qb[q_pos * sqt + d]) * scale : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kMasked, l = 0.f;

  // keys any row of this tile can see
  int n_keys = Tk;
  if (causal) {
    const int last_q = min(Tq, q0 + BQ) - 1;
    n_keys = max(0, min(Tk, last_q + causal_offset + 1));
  }

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < n_keys) {
        kx = to_float(kb[kp * skt + d]);
        vx = to_float(vb[kp * svt + d]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    float s[BK];
    float m_tile = kMasked;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[g + G * c];
        part = fmaf(qr[4 * c + 0], kk.x, part);
        part = fmaf(qr[4 * c + 1], kk.y, part);
        part = fmaf(qr[4 * c + 2], kk.z, part);
        part = fmaf(qr[4 * c + 3], kk.w, part);
      }
#pragma unroll
      for (int w = G / 2; w > 0; w >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w);
      const int kp = k0 + j;
      const bool keep =
          kp < n_keys && (!causal || kp <= q_pos + causal_offset);
      s[j] = keep ? part : kMasked;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[g + G * c];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv_l = 1.f / l;
    T* ob = o + ((long long)bh * Tq + q_pos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[4 * (g + G * c) + e] = from_float<T>(acc[4 * c + e] * inv_l);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int H, int Tq, int Tk, const long long* st, int causal,
            int causal_offset, float scale, cudaStream_t stream) {
  constexpr int G = D > 32 ? D / 32 : 1;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_attention_fwd_kernel<T, D><<<grid, BQ * G, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Tq, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, causal_offset,
      scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Tq, int Tk, int D, const long long* st, int causal,
             int causal_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, H, Tq, Tk, st, causal,
                           causal_offset, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, H, Tq, Tk, st, causal,
                           causal_offset, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, H, Tq, Tk, st, causal,
                           causal_offset, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, H, Tq, Tk, st, causal,
                             causal_offset, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
