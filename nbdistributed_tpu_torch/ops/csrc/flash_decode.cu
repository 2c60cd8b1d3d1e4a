// Flash-decode for Hopper: one new token per sequence against the
// heads-major KV cache, with the cache's length split across blocks
// (flash-decoding).
//
// Replaces: nbdistributed_tpu/ops/decode.py, _decode_kernel (driven by
// _decode_call and flash_decode_attention).
//
// What it computes: for each (batch b, kv head hk) the GQA group's
// queries q[b, hk*group : (hk+1)*group] attend cache slots
// t in [lo, valid_k), valid_k = min(pos[b] + 1, T),
// lo = pos[b] + 1 - window (window > 0) else 0 -- the window's lower
// bound is taken on the UNCLAMPED position, as on the TPU.  With an int8
// cache the fp32 per-token scales commute through both products: k_s
// rescales the score columns, v_s multiplies p before p@V while the
// normalizer l sums the unscaled p.  Optionally writes the per-head
// log-sum-exp.  A row whose window lies wholly past the valid keys
// (lo >= valid_k: pos >= T, the sequence-parallel caller's case) attends
// nothing: o = 0, lse = NEG_INF.
//
// What bounds it on the H100: bytes.  Each step reads the valid part of
// the cache once (2 * valid * D elements per (b, hk)) and does 4 flops
// per element per query head, far below the card's ~295 flop/byte
// ridge.  The bytes are few: at the serving shape (B = 8, Hkv = 3, 16 to
// 232 valid keys) they take ~0.2 us, under a launch's latency, and at
// full context (T = 2048, every key valid) 3.8 us.  One block per
// (b, hk), 24 blocks for 132 SMs each walking its keys tile after tile,
// could reach neither; the split below spreads the keys over the card.
//
// Design.  The grid is (B * Hkv, nsplit): block (bh, i) takes chunk i of
// T, keys [i * chunk, (i + 1) * chunk), chunk a multiple of kChunkKeys.
// The wrapper picks nsplit from B * Hkv and T alone (_decode_splits in
// ops/decode.py), never from pos, which lives on the card: a block whose
// chunk misses [max(lo, 0), valid_k) exits at once with m = NEG_INF,
// l = 0.  A block keeps the whole GQA group, so each K/V byte is read
// from device memory once for the group, and streams its chunk through a
// two-stage cp.async ring of 16-byte copies (8 bf16, 16 int8 or 4 fp32
// values): rows outside the keys that attend are zero-filled, not read.
// Each of its four warps runs its own online softmax over its share of
// each tile.  The score of a key is a dot product over D split across
// kLpk lanes (each reads 64 bytes of the key row from shared memory,
// rows padded so those reads miss no bank) and summed with shuffles;
// the group's max and the p.V product are warp-level too: a lane owns
// D / 32 output columns and takes each key's p by shuffle.  The warps'
// (m, l, o) merge through shared memory at the end.  With nsplit = 1 the
// block writes o and the lse itself; otherwise it writes its partial
// (o unnormalized, m in the log2 domain, l) in fp32 and a second kernel
// of the same entry point, one warp per (b, query head), merges the
// partials by their lse: o = sum_i 2^(m_i - M) o_i / sum_i 2^(m_i - M) l_i.
// tests/test_torch_decode_split.py mirrors the split, the chunk bounds,
// the early exit and both merges on the CPU.

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite: -inf breaks exp(m_prev - m_new)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxGroup = 8;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkKeys = 128;  // a chunk of T is a multiple of every key tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The key tile of a cache of CT with head dim D: each lane of the score
// reads 64 bytes of a key row (or the whole row, if shorter), so kLpk
// lanes share a key, a warp scores kKpw keys and the four warps kTK.
template <typename CT, int D>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(CT));  // 32 .. 512
  static constexpr int kLpk = kRowBytes <= 64 ? 1 : kRowBytes / 64;   // lanes per key
  static constexpr int kKpw = 32 / kLpk;                               // keys per warp
  static constexpr int kTK = kWarps * kKpw;                            // keys per tile
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte chunks of a row
  static constexpr int kLaneChunks = kChunks / kLpk;   // read by one lane
  static constexpr int kVals = 16 / static_cast<int>(sizeof(CT));  // values per chunk
  static constexpr int kCols = D / 32;                  // output columns per lane
  // Lane part p reads chunks c * kLpk + p.  The padding puts the eight
  // lanes of a 16-byte shared-memory read phase on eight distinct
  // 16-byte bank groups.
  static constexpr int kStride = kRowBytes + 16 * kLpk;
  static constexpr int kMat = kTK * kStride;  // one K or V tile, bytes
  static_assert(kChunkKeys % kTK == 0, "a chunk holds whole tiles");
  static_assert((kTK * kChunks) % kThreads == 0, "copies split evenly");
};

// A 16-byte chunk of CT values from shared memory, as floats.
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[16]) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

// Block (b * Hkv + hk, split) of the split decode.  part_o (B * H,
// nsplit, D) and part_ml (B * H, nsplit, 2) take the partials when
// nsplit > 1; with nsplit = 1 the block writes out and lse itself.
template <typename QT, typename CT, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc, const CT* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs, const int* __restrict__ pos,
    QT* __restrict__ out, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml, int H, int Hkv, int T, int group, int chunk, float scale,
    int window) {
  using Tl = Tile<CT, D>;
  __shared__ __align__(16) unsigned char kv_s[2][2][Tl::kMat];  // [stage][K, V]
  __shared__ float sc_s[2][2][Tl::kTK];                         // [stage][k_s, v_s]
  __shared__ float q_s[kMaxGroup][D];

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(hk) * group;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + hk) * T;  // (b, hk, t = 0)

  // The keys of this block's chunk that attend: [k_lo, k_hi).
  const int valid = pos[b] + 1;
  const int valid_k = min(valid, T);
  const int lo = window > 0 ? valid - window : 0;
  const int c0 = split * chunk;
  const int k_lo = max(c0, max(lo, 0));
  const int k_hi = min(c0 + chunk, valid_k);
  if (k_lo >= k_hi) {
    if (nsplit > 1) {
      if (tid < group) {
        float* ml = part_ml + ((head0 + tid) * nsplit + split) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    } else {  // the row attends nothing
      for (int i = tid; i < group * D; i += kThreads) out[head0 * D + i] = from_f<QT>(0.f);
      if (lse != nullptr && tid < group) lse[head0 + tid] = kNegInf;
    }
    return;
  }

  for (int i = tid; i < group * D; i += kThreads)
    q_s[i / D][i % D] = to_f(q[head0 * D + i]) * (scale * kLog2e);

  // Start the copy of the tile of keys [t0, t0 + kTK) into stage st;
  // rows outside [k_lo, k_hi) are zero-filled.
  auto issue = [&](int t0, int st) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const CT* src = m == 0 ? kc : vc;
#pragma unroll
      for (int it = 0; it < Tl::kTK * Tl::kChunks / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / Tl::kChunks, c = i % Tl::kChunks;
        const int t = t0 + r;
        const bool ok = t >= k_lo && t < k_hi;
        const unsigned char* g =
            reinterpret_cast<const unsigned char*>(src + (row0 + (ok ? t : k_lo)) * D) + c * 16;
        nbd::cp_async16(nbd::smem_u32(&kv_s[st][m][r * Tl::kStride + c * 16]), g, ok);
      }
    }
    if (ks != nullptr && tid < Tl::kTK) {
      const int t = t0 + tid;
      const bool ok = t >= k_lo && t < k_hi;
      nbd::cp_async4(&sc_s[st][0][tid], ks + row0 + (ok ? t : k_lo), ok);
      nbd::cp_async4(&sc_s[st][1][tid], vs + row0 + (ok ? t : k_lo), ok);
    }
    nbd::cp_async_commit();
  };

  const int tbeg = c0 + ((k_lo - c0) / Tl::kTK) * Tl::kTK;
  issue(tbeg, 0);

  // This warp's online softmax (log2 domain): m per head, the same in
  // every lane; l this lane's share of the sum; o this lane's columns.
  float m[kMaxGroup], l[kMaxGroup], o[kMaxGroup][Tl::kCols];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < Tl::kCols; ++e) o[g][e] = 0.f;
  }
  const int key = warp * Tl::kKpw + lane / Tl::kLpk, part = lane % Tl::kLpk;

  int st = 0;
  for (int t0 = tbeg; t0 < k_hi; t0 += Tl::kTK, st ^= 1) {
    if (t0 + Tl::kTK < k_hi) {
      issue(t0 + Tl::kTK, st ^ 1);
      nbd::cp_async_wait<1>();
    } else {
      nbd::cp_async_wait<0>();
    }
    __syncthreads();  // tile t0 (and q_s) visible to every thread
    const unsigned char* kt = kv_s[st][0];
    const unsigned char* vt = kv_s[st][1];

    // Scores of this lane's key, its kLpk lanes summed.
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < Tl::kLaneChunks; ++c) {
      const int ch = c * Tl::kLpk + part;
      float x[Tl::kVals];
      load_chunk(kt + key * Tl::kStride + ch * 16, x);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
#pragma unroll
        for (int e = 0; e < Tl::kVals; ++e) s[g] = fmaf(q_s[g][ch * Tl::kVals + e], x[e], s[g]);
      }
    }
    const int t = t0 + key;
    const bool keep = t >= k_lo && t < k_hi;
    const float ksc = ks != nullptr ? sc_s[st][0][key] : 1.f;
    const float vsc = vs != nullptr ? sc_s[st][1][key] : 1.f;
    float p[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
#pragma unroll
      for (int off = Tl::kLpk / 2; off > 0; off >>= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      const float x = keep ? s[g] * ksc : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = Tl::kLpk; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      const float pg = keep ? exp2f(x - m_new) : 0.f;
      l[g] = l[g] * corr + (part == 0 ? pg : 0.f);  // unscaled p, once per key
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < Tl::kCols; ++e) o[g][e] *= corr;
      p[g] = pg * vsc;
    }

    // o += p V over the warp's keys.
#pragma unroll 4
    for (int j = 0; j < Tl::kKpw; ++j) {
      const CT* vr =
          reinterpret_cast<const CT*>(vt + (warp * Tl::kKpw + j) * Tl::kStride) + lane * Tl::kCols;
      float vx[Tl::kCols];
#pragma unroll
      for (int e = 0; e < Tl::kCols; ++e) vx[e] = to_f(vr[e]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
        const float pj = __shfl_sync(0xffffffffu, p[g], j * Tl::kLpk);
#pragma unroll
        for (int e = 0; e < Tl::kCols; ++e) o[g][e] = fmaf(pj, vx[e], o[g][e]);
      }
    }
    __syncthreads();  // every thread is done with stage st before it is refilled
  }

  // Merge the four warps' (m, l, o) through shared memory (the K/V ring
  // is free: the last tile's barrier has passed and no copy is pending).
  float* wm = reinterpret_cast<float*>(&kv_s[0][0][0]);  // [kWarps][kMaxGroup]
  float* wl = wm + kWarps * kMaxGroup;                   // [kWarps][kMaxGroup]
  float* wo = wl + kWarps * kMaxGroup;                   // [kWarps][kMaxGroup][D]
  static_assert(sizeof(float) * kWarps * kMaxGroup * (2 + D) <= sizeof(kv_s), "merge fits");
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
    if (lane == 0) {
      wm[warp * kMaxGroup + g] = m[g];
      wl[warp * kMaxGroup + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < Tl::kCols; ++e)
      wo[(warp * kMaxGroup + g) * D + lane * Tl::kCols + e] = o[g][e];
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxGroup + g]);
    float num = 0.f, den = 0.f;  // den >= 1: the block saw a key that attends
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(wm[w * kMaxGroup + g] - M);
      num += a * wo[(w * kMaxGroup + g) * D + d];
      den += a * wl[w * kMaxGroup + g];
    }
    if (nsplit == 1) {
      out[(head0 + g) * D + d] = from_f<QT>(num / den);
      if (lse != nullptr && d == 0) lse[head0 + g] = M * kLn2 + logf(den);
    } else {
      part_o[((head0 + g) * nsplit + split) * D + d] = num;
      if (d == 0) {
        float* ml = part_ml + ((head0 + g) * nsplit + split) * 2;
        ml[0] = M;
        ml[1] = den;
      }
    }
  }
}

// Merge the nsplit partials of each (b, query head) by their lse: one
// warp per row, a lane per D / 32 columns.  A partial with l = 0 (its
// chunk held no key that attends) weighs nothing and its o is not read.
template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml, QT* __restrict__ out,
    float* __restrict__ lse, int rows, int nsplit) {
  constexpr int kCols = D / 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* ml = part_ml + static_cast<size_t>(row) * nsplit * 2;
  float M = kNegInf;
  for (int i = lane; i < nsplit; i += 32)
    if (ml[2 * i + 1] > 0.f) M = fmaxf(M, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float num[kCols], den = 0.f;
#pragma unroll
  for (int e = 0; e < kCols; ++e) num[e] = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float li = ml[2 * i + 1];
    if (li <= 0.f) continue;
    const float a = exp2f(ml[2 * i] - M);
    den += a * li;
    const float* oi = part_o + (static_cast<size_t>(row) * nsplit + i) * D + lane * kCols;
#pragma unroll
    for (int e = 0; e < kCols; ++e) num[e] = fmaf(a, oi[e], num[e]);
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    out[static_cast<size_t>(row) * D + lane * kCols + e] =
        from_f<QT>(num[e] / fmaxf(den, 1e-30f));
  if (lse != nullptr && lane == 0) lse[row] = den > 0.f ? M * kLn2 + logf(den) : kNegInf;
}

struct Params {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const int* pos;
  void* out;
  float *lse, *part_o, *part_ml;  // part_ml follows part_o in one scratch
  int B, H, Hkv, T, nsplit, chunk;
  float scale;
  int window;
};

template <typename QT, typename CT, int D>
int launch(const Params& p, cudaStream_t s) {
  decode_split_kernel<QT, CT, D><<<dim3(p.B * p.Hkv, p.nsplit), kThreads, 0, s>>>(
      static_cast<const QT*>(p.q), static_cast<const CT*>(p.kc), static_cast<const CT*>(p.vc),
      p.ks, p.vs, p.pos, static_cast<QT*>(p.out), p.lse, p.part_o, p.part_ml, p.H, p.Hkv, p.T,
      p.H / p.Hkv, p.chunk, p.scale, p.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return static_cast<int>(err);
  const int rows = p.B * p.H;
  decode_combine_kernel<QT, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      p.part_o, p.part_ml, static_cast<QT*>(p.out), p.lse, rows, p.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT>
int by_dim(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 32: return launch<QT, CT, 32>(p, s);
    case 64: return launch<QT, CT, 64>(p, s);
    case 128: return launch<QT, CT, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (cache only, with scales).
// The cache is split into nsplit chunks of `chunk` keys (a multiple of
// 128, (nsplit - 1) * chunk < T <= nsplit * chunk); with nsplit > 1,
// part is fp32 scratch of B * H * nsplit * (D + 2) floats for the
// partials: every chunk's o, then every chunk's (m, l).  kc / vc must be
// 16-byte aligned (cp.async).
// Launches the split kernel, then (nsplit > 1) the combine kernel, and
// returns the first nonzero cudaGetLastError() code (0 = launched).
extern "C" int nbd_flash_decode(const void* q, const void* kc, const void* vc,
                                const float* ks, const float* vs, const int* pos,
                                void* out, float* lse, float* part, int B, int H, int Hkv,
                                int T, int D, int q_dtype, int cache_dtype, int nsplit,
                                int chunk, float scale, int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || B <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nsplit < 1 || nsplit > 65535 || chunk <= 0 || chunk % kChunkKeys != 0 ||
      static_cast<long long>(nsplit - 1) * chunk >= T ||
      static_cast<long long>(nsplit) * chunk < T ||
      (nsplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!nbd::aligned16(kc) || !nbd::aligned16(vc))
    return static_cast<int>(cudaErrorMisalignedAddress);
  float* part_ml = part ? part + static_cast<size_t>(B) * H * nsplit * D : nullptr;
  const Params p{q, kc, vc, ks, vs, pos, out, lse, part, part_ml,
                 B, H, Hkv, T, nsplit, chunk, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0) return by_dim<float, float>(D, p, s);
  if (q_dtype == 1 && cache_dtype == 1) return by_dim<__nv_bfloat16, __nv_bfloat16>(D, p, s);
  if (q_dtype == 0 && cache_dtype == 2) return by_dim<float, int8_t>(D, p, s);
  if (q_dtype == 1 && cache_dtype == 2) return by_dim<__nv_bfloat16, int8_t>(D, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
