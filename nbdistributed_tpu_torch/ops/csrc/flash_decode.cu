// Flash-decode for Hopper: one new token per sequence against the
// heads-major KV cache.
//
// Replaces: nbdistributed_tpu/ops/decode.py, _decode_kernel (driven by
// _decode_call and flash_decode_attention).
//
// What it computes: for each (batch b, kv head hk) the GQA group's
// queries q[b, hk*group : (hk+1)*group] attend cache slots
// t in [lo, valid_k), valid_k = min(pos[b] + 1, T),
// lo = pos[b] + 1 - window (window > 0) else 0 -- the window's lower
// bound is taken on the UNCLAMPED position, as on the TPU.  The masked
// online softmax streams the cache once; with an int8 cache the fp32
// per-token scales commute through both products: k_s rescales the
// score columns, v_s multiplies p before p@V while the normalizer l
// sums the unscaled p.  Optionally writes the per-head log-sum-exp
// (NEG_INF when the row attends nothing).
//
// What bounds it on the H100: bytes.  Each step reads the valid part of
// the cache once (2 * valid * D elements per (b, hk)) and does 4 flops
// per element per query head, far below the card's ~295 flop/byte
// ridge.  Design: one block per (b, hk) holds the whole GQA group in
// shared memory, so each K/V element is read from device memory once
// for the group, not once per query head; tiles outside [lo, valid_k)
// are never loaded.  Known limit: B * Hkv blocks (24 at the SmolLM2
// serving shape) cannot fill 132 SMs -- splitting T across blocks and
// merging the pieces by their lse (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite: -inf breaks exp(m_prev - m_new)
constexpr int kMaxGroup = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename QT, typename CT, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc, const CT* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ pos, QT* __restrict__ out, float* __restrict__ lse,
    int H, int Hkv, int T, int group, float scale, int window) {
  constexpr int TK = (D <= 64) ? 64 : 32;  // keys per tile
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float k_s[TK][D + 1];          // +1: conflict-free column reads
  __shared__ float v_s[TK][D];
  __shared__ float p_s[kMaxGroup][TK];      // scores, then p (times v scale)
  __shared__ float acc_s[kMaxGroup][D];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], corr_s[kMaxGroup];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(hk) * group;

  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f(q[(head0 + g) * D + d]) * scale;
    acc_s[g][d] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int valid = pos[b] + 1;
  const int valid_k = min(valid, T);
  const int lo = window > 0 ? valid - window : 0;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + hk) * T;  // (b, hk, t = 0)
  __syncthreads();

  if (lo < valid_k) {  // else the row attends nothing: o = 0, l = 0
    const int warp = tid / 32, lane = tid % 32;
    for (int t0 = (max(lo, 0) / TK) * TK; t0 < valid_k; t0 += TK) {
      for (int i = tid; i < TK * D; i += kThreads) {
        const int r = i / D, d = i % D, t = t0 + r;
        float kx = 0.f, vx = 0.f;
        if (t < T) {
          kx = to_f(kc[(row0 + t) * D + d]);
          vx = to_f(vc[(row0 + t) * D + d]);
        }
        k_s[r][d] = kx;
        v_s[r][d] = vx;
      }
      __syncthreads();

      for (int i = tid; i < group * TK; i += kThreads) {
        const int g = i / TK, r = i % TK, t = t0 + r;
        float s = kNegInf;
        if (t >= lo && t < valid_k) {
          float a = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) a += q_s[g][d] * k_s[r][d];
          if (ks != nullptr) a *= ks[row0 + t];
          s = a;
        }
        p_s[g][r] = s;
      }
      __syncthreads();

      // Every tile visited holds at least one valid key, so m_new is
      // finite and masked columns get p = 0 exactly.
      for (int g = warp; g < group; g += kThreads / 32) {
        float mx = kNegInf;
        for (int r = lane; r < TK; r += 32) mx = fmaxf(mx, p_s[g][r]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int r = lane; r < TK; r += 32) {
          const int t = t0 + r;
          float p = 0.f;
          if (t >= lo && t < valid_k) p = expf(p_s[g][r] - m_new);
          sum += p;
          p_s[g][r] = (vs != nullptr && t < T) ? p * vs[row0 + t] : p;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[g] = l_s[g] * corr + sum;  // unscaled p
          m_s[g] = m_new;
          corr_s[g] = corr;
        }
      }
      __syncthreads();

      for (int i = tid; i < group * D; i += kThreads) {
        const int g = i / D, d = i % D;
        float a = acc_s[g][d] * corr_s[g];
#pragma unroll 8
        for (int r = 0; r < TK; ++r) a += p_s[g][r] * v_s[r][d];
        acc_s[g][d] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    out[(head0 + g) * D + d] = from_f<QT>(acc_s[g][d] / fmaxf(l_s[g], 1e-30f));
  }
  if (lse != nullptr && tid < group) {
    const float l = l_s[tid];
    lse[head0 + tid] = l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-30f)) : kNegInf;
  }
}

template <typename QT, typename CT, int D>
int launch(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* pos, void* out, float* lse, int B, int H,
           int Hkv, int T, int group, float scale, int window, cudaStream_t stream) {
  decode_kernel<QT, CT, D><<<B * Hkv, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc), static_cast<const CT*>(vc),
      ks, vs, pos, static_cast<QT*>(out), lse, H, Hkv, T, group, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT>
int by_dim(int D, const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* pos, void* out, float* lse, int B, int H,
           int Hkv, int T, int group, float scale, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch<QT, CT, 32>(q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
    case 64: return launch<QT, CT, 64>(q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
    case 128: return launch<QT, CT, 128>(q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (cache only, with scales).
// Returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int nbd_flash_decode(const void* q, const void* kc, const void* vc,
                                const float* ks, const float* vs, const int* pos,
                                void* out, float* lse, int B, int H, int Hkv, int T,
                                int D, int q_dtype, int cache_dtype, float scale,
                                int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || B <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return by_dim<float, float>(D, q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(D, q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
  if (q_dtype == 0 && cache_dtype == 2)
    return by_dim<float, int8_t>(D, q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
  if (q_dtype == 1 && cache_dtype == 2)
    return by_dim<__nv_bfloat16, int8_t>(D, q, kc, vc, ks, vs, pos, out, lse, B, H, Hkv, T, group, scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
