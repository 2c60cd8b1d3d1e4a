// Flash-attention forward for Hopper: blockwise online-softmax
// attention that never writes the (Sq, Sk) score matrix to memory.
//
// Replaces: nbdistributed_tpu/ops/attention.py, _flash_forward and its
// body _flash_kernel (driven by _flash_fwd / flash_attention).
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), query head h
// reads kv head h / group.  A key is kept when it is below Sk (ragged
// Sk), at or below the offset causal diagonal
// (ki + k_off <= qi + q_off), inside the sliding window
// (ki + k_off > qi + q_off - window) and in the query's segment.  Writes
// O in q's layout and dtype and the fp32 per-row log-sum-exp
// lse (B, H, Sq) = m + log(l).
//
// What bounds it on the H100: causal work is 4 * D * H * Sq * Sk / 2
// flops against (2 * Sq * H + 2 * Sk * Hkv) * D elements of I/O.  At the
// forward's shape (B = 1, S = 512, H = 9, D = 64, bf16) the two floors
// are close -- 0.47 us of bytes, 0.31 us of tensor-core work -- and the
// work grows as S^2 against the bytes' S, so past S ~ 800 the tensor
// cores set the floor.  This first version does its products with fp32
// FMAs from shared memory (no mma/wgmma yet), so it runs far above
// either floor; moving the two products onto wgmma is later work.
// Design: one block per (batch * kv head, tile of 64 "folded" rows),
// row r = qi * group + g, so the whole GQA group of a query position
// shares each K/V tile staged in shared memory (K/V are read once per
// group, never repeated to H heads).  The k loop runs only over the
// tiles the block's causal / window range can see, as
// _causal_k_iters / _window_first_k_block do on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;      // folded query rows per block
constexpr int kBN = 64;      // keys per tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBM * (D + 1) + kBN * D + kBM * (kBN + 1) + 3 * kBM) +
         sizeof(int) * 2 * kBM;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int Sq, int Sk, int H, int Hkv, int group,
    float scale, int causal, int window, int q_off, int k_off) {
  static_assert(kBM == 64 && kBN == 64 && kThreads == 256, "tiling below assumes 16x16 threads");
  constexpr int DP = D + 1;  // padded row stride: conflict-free column reads
  constexpr int PP = kBN + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // kBM x DP, pre-scaled
  float* k_s = q_s + kBM * DP;     // kBN x DP
  float* v_s = k_s + kBN * DP;     // kBN x D
  float* p_s = v_s + kBN * D;      // kBM x PP
  float* m_s = p_s + kBM * PP;
  float* l_s = m_s + kBM;
  float* c_s = l_s + kBM;
  int* qi_s = reinterpret_cast<int*>(c_s + kBM);  // query index of row, -1 = pad
  int* sg_s = qi_s + kBM;                         // segment id of row

  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int row0 = blockIdx.x * kBM;
  const int nrows = Sq * group;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i % D, R = row0 + r;
    float x = 0.f;
    if (R < nrows) {
      const int qi = R / group, g = R % group;
      x = to_f(q[((static_cast<size_t>(b) * Sq + qi) * H + hk * group + g) * D + d]) * scale;
    }
    q_s[r * DP + d] = x;
  }
  if (tid < kBM) {
    const int R = row0 + tid;
    qi_s[tid] = R < nrows ? R / group : -1;
    sg_s[tid] = (qseg != nullptr && R < nrows) ? qseg[static_cast<size_t>(b) * Sq + R / group] : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Keys this block's rows can see: [kbeg, kend).
  const int qi_lo = row0 / group;
  const int qi_hi = (min(row0 + kBM, nrows) - 1) / group;
  int kbeg = 0, kend = Sk;
  if (causal) {
    kend = min(Sk, qi_hi + q_off - k_off + 1);
    if (window > 0) kbeg = max(0, qi_lo + q_off - k_off - window + 1);
  }
  kbeg = (kbeg / kBN) * kBN;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kb0 = kbeg; kb0 < kend; kb0 += kBN) {
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int c = i / D, d = i % D, ki = kb0 + c;
      float kx = 0.f, vx = 0.f;
      if (ki < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + ki) * Hkv + hk) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[c * DP + d] = kx;
      v_s[c * D + d] = vx;
    }
    __syncthreads();

    // Scores: this thread owns rows ty + 16 i and columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = qi_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, ki = kb0 + c;
        bool keep = qi >= 0 && ki < Sk;
        if (causal) {
          keep = keep && (ki + k_off <= qi + q_off);
          if (window > 0) keep = keep && (ki + k_off > qi + q_off - window);
        }
        if (kseg != nullptr && keep) keep = sg_s[r] == kseg[static_cast<size_t>(b) * Sk + ki];
        p_s[r * PP + c] = keep ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes share a row, 16 columns each.
    {
      const int r = tid / 4, sub = tid % 4;
      float* row = p_s + r * PP + sub * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, R = row0 + r;
    if (R >= nrows) continue;
    const int qi = R / group, g = R % group;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
    T* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H + hk * group + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = from_f<T>(acc[i][j] / l_safe);
  }
  if (tid < kBM && row0 + tid < nrows) {
    const int R = row0 + tid, qi = R / group, g = R % group;
    lse[(static_cast<size_t>(b) * H + hk * group + g) * Sq + qi] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// Opt flash_fwd_kernel<T, D> into its dynamic shared memory (over the
// 48 KB default) once per device, not before every launch.
template <typename T, int D>
cudaError_t ensure_smem_attr() {
  static std::atomic<unsigned long long> done{0};  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>()));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* qseg, const int* kseg, int B, int Sq, int Sk, int H, int Hkv,
           float scale, int causal, int window, int q_off, int k_off, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = ensure_smem_attr<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = H / Hkv;
  dim3 grid((Sq * group + kBM - 1) / kBM, B * Hkv);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, qseg, kseg, Sq, Sk, H, Hkv, group, scale, causal, window,
      q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(int D, const void* q, const void* k, const void* v, void* o, float* lse,
           const int* qseg, const int* kseg, int B, int Sq, int Sk, int H, int Hkv,
           float scale, int causal, int window, int q_off, int k_off, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  window <= 0 means none; qseg /
// kseg (B, Sq) / (B, Sk) int32 or null.  Returns cudaGetLastError().
extern "C" int nbd_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, float* lse, const int* qseg,
                                       const int* kseg, int B, int Sq, int Sk, int H,
                                       int Hkv, int D, int dtype, int causal, float scale,
                                       int window, int q_off, int k_off, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(D, q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(D, q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
