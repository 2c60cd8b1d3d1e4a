// Flash-attention backward for Hopper: dQ (K2) and dK/dV (K3), rebuilt
// blockwise from the forward's saved per-row log-sum-exp, so no
// (Sq, Sk) score or probability matrix is ever written to memory.
//
// Replaces: nbdistributed_tpu/ops/attention.py, the two pallas_calls of
// _flash_backward_folded -- the dQ call (body _flash_bwd_dq_kernel) and
// the dK/dV call (body _flash_bwd_dkv_kernel); delta = rowsum(dO * O)
// (_flash_bwd_prep) stays a PyTorch op in the wrapper, as it is plain
// XLA on the TPU.
//
// What it computes: q/dO (B, Sq, H, D), k/v (B, Sk, Hkv, D), query head
// h reads kv head h / group; lse and delta (B, H, Sq) fp32.  With the
// forward's mask (keys below Sk, the offset causal diagonal
// ki + k_off <= qi + q_off, the sliding window ki + k_off > qi + q_off -
// window, equal segment ids) and s = scale * q.k:
//   p  = exp(s - lse)              (0 where masked)
//   dS = p * (dO.v - delta)
//   dQ = scale * sum_j dS_ij k_j                      (K2)
//   dV = sum_i p_ij dO_i,  dK = scale * sum_i dS_ij q_i  (K3)
// with dK/dV summed over the GQA group.  dq in q's dtype, dk/dv in k's;
// every sum is fp32.
//
// What bounds it on the H100: the causal work is 3 (K2) and 4 (K3)
// products of 2 * D flops per attending (q, k) pair.  At the train
// shape (B = 4, S = 2048, H = 9, Hkv = 3, D = 64, bf16) that is
// 75.5M pairs: 29 GFLOP for K2 (29 us at 989 TFLOP/s) against ~35 MB
// of I/O (~10 us at 3.35 TB/s), and 39 GFLOP for K3 (39 us) -- both
// bound by operations.  This first version does every product with
// scalar fp32 FMAs from shared memory (no mma/wgmma yet), so it runs
// far above that floor; moving the products onto the tensor cores is
// later work.
//
// Design.  Blocks on the H100 run in no order, so nothing is carried
// between them as the TPU's sequential grid carries its fp32 scratch:
// a loop inside the block takes the sequential axis' place.
//   * K2: one block per (batch * kv head, tile of 64 "folded" rows),
//     row r = qi * group + g, exactly K1's layout: the whole GQA group
//     of a query position shares each K/V tile.  The block's Q, dO,
//     lse and delta stay in shared memory while it walks the key tiles
//     its causal / window range can see (_causal_k_iters /
//     _window_first_k_block).
//   * K3: one block per (batch * kv head, tile of 64 keys).  K and V
//     stay in shared memory while the block walks the folded rows --
//     the group's heads and the query tiles together -- that its
//     range can see (_causal_first_q_block / _window_last_q_block in
//     folded rows), so dK/dV sum over the group inside the block, in
//     registers, with no float atomics: the result is the same on
//     every run.
// Padded query rows and keys beyond Sk carry p = 0 (the TPU kernel's
// seq_q_valid), so they add nothing.  Rows with no key at all are
// undefined, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kBM = 64;      // folded query rows per tile
constexpr int kBN = 64;      // keys per tile
constexpr int kThreads = 256;
constexpr int kPP = kBN + 1;  // padded stride of the 64x64 p / dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* qseg;
  const int* kseg;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, H, Hkv, group;
  float scale;
  int causal, window, q_off, k_off;
};

// Shared memory of both kernels: Q, dO, K, V tiles (fp32, rows padded to
// D + 1 floats so column reads miss no bank), the p and dS tiles, and
// per-row / per-key scalars.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBM * (D + 1) + 2 * kBN * (D + 1) + 2 * kBM * kPP + 2 * kBM) +
         sizeof(int) * (2 * kBM + kBN);
}

template <int D>
struct Smem {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
  int *qi, *qsg, *ksg;
  __device__ explicit Smem(float* base) {
    constexpr int DP = D + 1;
    q = base;
    dout = q + kBM * DP;
    k = dout + kBM * DP;
    v = k + kBN * DP;
    p = v + kBN * DP;
    ds = p + kBM * kPP;
    lse = ds + kBM * kPP;
    delta = lse + kBM;
    qi = reinterpret_cast<int*>(delta + kBM);
    qsg = qi + kBM;
    ksg = qsg + kBM;
  }
};

// Stage folded rows [row0, row0 + kBM) of (b, kv head hk): Q pre-scaled,
// dO, lse, delta, the query index (-1 for a padded row) and segment.
template <typename T, int D>
__device__ void load_rows(const Args& a, const Smem<D>& sm, int b, int hk, int row0) {
  constexpr int DP = D + 1;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int nrows = a.Sq * a.group;
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i % D, R = row0 + r;
    float x = 0.f, y = 0.f;
    if (R < nrows) {
      const int qi = R / a.group, g = R % a.group;
      const size_t off = ((static_cast<size_t>(b) * a.Sq + qi) * a.H + hk * a.group + g) * D + d;
      x = to_f(q[off]) * a.scale;
      y = to_f(dout[off]);
    }
    sm.q[r * DP + d] = x;
    sm.dout[r * DP + d] = y;
  }
  if (threadIdx.x < kBM) {
    const int t = threadIdx.x, R = row0 + t;
    const bool ok = R < nrows;
    const int qi = ok ? R / a.group : 0, g = ok ? R % a.group : 0;
    const size_t li = (static_cast<size_t>(b) * a.H + hk * a.group + g) * a.Sq + qi;
    sm.qi[t] = ok ? qi : -1;
    sm.qsg[t] = (a.qseg != nullptr && ok) ? a.qseg[static_cast<size_t>(b) * a.Sq + qi] : 0;
    sm.lse[t] = ok ? a.lse[li] : 0.f;
    sm.delta[t] = ok ? a.delta[li] : 0.f;
  }
}

// Stage keys [kb0, kb0 + kBN) of (b, hk): K, V (zero past Sk), segments.
template <typename T, int D>
__device__ void load_keys(const Args& a, const Smem<D>& sm, int b, int hk, int kb0) {
  constexpr int DP = D + 1;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < kBN * D; i += kThreads) {
    const int c = i / D, d = i % D, ki = kb0 + c;
    float kx = 0.f, vx = 0.f;
    if (ki < a.Sk) {
      const size_t off = ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    sm.k[c * DP + d] = kx;
    sm.v[c * DP + d] = vx;
  }
  if (threadIdx.x < kBN) {
    const int ki = kb0 + threadIdx.x;
    sm.ksg[threadIdx.x] =
        (a.kseg != nullptr && ki < a.Sk) ? a.kseg[static_cast<size_t>(b) * a.Sk + ki] : 0;
  }
}

// p and dS of the staged 64 x 64 (row, key) tile into shared memory.
// Thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j.
template <int D>
__device__ void p_and_ds(const Args& a, const Smem<D>& sm, int kb0) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = sm.q[(ty + 16 * i) * DP + d];
      oa[i] = sm.dout[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = sm.k[(tx + 16 * j) * DP + d];
      vb[j] = sm.v[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qa[i] * kb[j];
        dp[i][j] += oa[i] * vb[j];
      }
  }
  const bool has_seg = a.kseg != nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = sm.qi[r];
    const float lse = sm.lse[r], delta = sm.delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, ki = kb0 + c;
      bool keep = qi >= 0 && ki < a.Sk;
      if (a.causal) {
        keep = keep && (ki + a.k_off <= qi + a.q_off);
        if (a.window > 0) keep = keep && (ki + a.k_off > qi + a.q_off - a.window);
      }
      if (has_seg) keep = keep && sm.qsg[r] == sm.ksg[c];
      const float p = keep ? expf(s[i][j] - lse) : 0.f;
      sm.p[r * kPP + c] = p;
      sm.ds[r * kPP + c] = p * (dp[i][j] - delta);
    }
  }
}

// K2: dQ for one (b * Hkv + hk, tile of 64 folded rows).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  static_assert(kBM == 64 && kBN == 64 && kThreads == 256, "tiling assumes 16x16 threads");
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int row0 = blockIdx.x * kBM;
  const int nrows = a.Sq * a.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D>(a, sm, b, hk, row0);

  // Keys this block's rows can see: [kbeg, kend).
  const int qi_lo = row0 / a.group;
  const int qi_hi = (min(row0 + kBM, nrows) - 1) / a.group;
  int kbeg = 0, kend = a.Sk;
  if (a.causal) {
    kend = min(a.Sk, qi_hi + a.q_off - a.k_off + 1);
    if (a.window > 0) kbeg = max(0, qi_lo + a.q_off - a.k_off - a.window + 1);
  }
  kbeg = (kbeg / kBN) * kBN;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kb0 = kbeg; kb0 < kend; kb0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    load_keys<T, D>(a, sm, b, hk, kb0);
    __syncthreads();
    p_and_ds<D>(a, sm, kb0);
    __syncthreads();
    // dQ rows ty + 16 i, columns tx + 16 j: += dS . K
#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sm.ds[(ty + 16 * i) * kPP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sm.k[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += dsv[i] * kv[j];
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= nrows) continue;
    const int qi = R / a.group, g = R % a.group;
    T* dst = dq + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + hk * a.group + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = from_f<T>(acc[i][j] * a.scale);
  }
}

// K3: dK and dV for one (b * Hkv + hk, tile of 64 keys), summed over
// every folded row (all heads of the group) that can see the tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  static_assert(kBM == 64 && kBN == 64 && kThreads == 256, "tiling assumes 16x16 threads");
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int kb0 = blockIdx.x * kBN;
  const int nrows = a.Sq * a.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_keys<T, D>(a, sm, b, hk, kb0);

  // Folded rows that can see this key tile: [rbeg, rend).  The first
  // query that sees key kb0 sits on its offset diagonal
  // (_causal_first_q_block); with a window the last one sits window - 1
  // positions past the tile's last key (_window_last_q_block).
  int rbeg = 0, rend = nrows;
  if (a.causal) {
    const int qlo = max(0, kb0 + a.k_off - a.q_off);
    rbeg = qlo < a.Sq ? qlo * a.group : nrows;
    if (a.window > 0) {
      const int qhi = kb0 + kBN - 1 + a.k_off - a.q_off + a.window - 1;
      rend = qhi < 0 ? 0 : (qhi + 1 < a.Sq ? (qhi + 1) * a.group : nrows);
    }
  }
  rbeg = (rbeg / kBM) * kBM;

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int row0 = rbeg; row0 < rend; row0 += kBM) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(a, sm, b, hk, row0);
    __syncthreads();
    p_and_ds<D>(a, sm, kb0);
    __syncthreads();
    // Keys ty + 16 i, columns tx + 16 j: dV += p^T dO, dK += dS^T Q
    // (Q was pre-scaled, so dK carries the scale already).
#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      float pv[4], dsv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sm.p[r * kPP + ty + 16 * i];
        dsv[i] = sm.ds[r * kPP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sm.dout[r * DP + tx + 16 * j];
        qv[j] = sm.q[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] += pv[i] * ov[j];
          dk[i][j] += dsv[i] * qv[j];
        }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = kb0 + ty + 16 * i;
    if (ki >= a.Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[off + tx + 16 * j] = from_f<T>(dk[i][j]);
      dvp[off + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, bool kDkv>
void* kernel_ptr() {
  if constexpr (kDkv)
    return reinterpret_cast<void*>(flash_bwd_dkv_kernel<T, D>);
  else
    return reinterpret_cast<void*>(flash_bwd_dq_kernel<T, D>);
}

// Opt each kernel into its dynamic shared memory (over the 48 KB
// default) once per device, not before every launch.
template <typename T, int D, bool kDkv>
cudaError_t ensure_smem_attr() {
  static std::atomic<unsigned long long> done{0};  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_ptr<T, D, kDkv>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>()));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D, bool kDkv>
int launch(const Args& a, int B, cudaStream_t s) {
  cudaError_t err = ensure_smem_attr<T, D, kDkv>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes<D>();
  if constexpr (kDkv) {
    dim3 grid((a.Sk + kBN - 1) / kBN, B * a.Hkv);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  } else {
    dim3 grid((a.Sq * a.group + kBM - 1) / kBM, B * a.Hkv);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv>
int dispatch(const Args& a, int B, int D, int dtype, cudaStream_t s) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || B <= 0 || a.Sq <= 0 || a.Sk <= 0 ||
      B * a.Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32, kDkv>(a, B, s);
      case 64: return launch<float, 64, kDkv>(a, B, s);
      case 128: return launch<float, 128, kDkv>(a, B, s);
      default: break;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32, kDkv>(a, B, s);
      case 64: return launch<__nv_bfloat16, 64, kDkv>(a, B, s);
      case 128: return launch<__nv_bfloat16, 128, kDkv>(a, B, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* qseg, const int* kseg, void* dq, void* dk,
               void* dv, int Sq, int Sk, int H, int Hkv, int causal, float scale, int window,
               int q_off, int k_off) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.qseg = qseg;
  a.kseg = kseg;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.group = Hkv > 0 ? H / Hkv : 0;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.q_off = q_off;
  a.k_off = k_off;
  return a;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v, dout and the gradients
// share it).  lse / delta (B, H, Sq) fp32; window <= 0 means none;
// qseg / kseg (B, Sq) / (B, Sk) int32 or null.  Each returns
// cudaGetLastError() of its launch.
extern "C" int nbd_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, const int* qseg,
                                          const int* kseg, void* dq, int B, int Sq, int Sk,
                                          int H, int Hkv, int D, int dtype, int causal,
                                          float scale, int window, int q_off, int k_off,
                                          void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, qseg, kseg, dq, nullptr, nullptr, Sq, Sk,
                           H, Hkv, causal, scale, window, q_off, k_off);
  return dispatch<false>(a, B, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int nbd_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, const int* qseg,
                                           const int* kseg, void* dk, void* dv, int B, int Sq,
                                           int Sk, int H, int Hkv, int D, int dtype,
                                           int causal, float scale, int window, int q_off,
                                           int k_off, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, qseg, kseg, nullptr, dk, dv, Sq, Sk, H,
                           Hkv, causal, scale, window, q_off, k_off);
  return dispatch<true>(a, B, D, dtype, static_cast<cudaStream_t>(stream));
}
