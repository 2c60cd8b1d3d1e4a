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
// cores set the floor (train shape B = 4, S = 2048: 19.3 GFLOP, 20 us).
//
// Layout shared by both versions: one block per (batch * kv head, tile
// of 64 "folded" rows), row r = qi * group + g, so the whole GQA group of
// a query position shares each K/V tile staged in shared memory (K/V are
// read once per group, never repeated to H heads).  The k loop runs only
// over the tiles the block's causal / window range can see (key_range in
// sm90.cuh, as _causal_k_iters / _window_first_k_block on the TPU).
//
// bf16: the tensor-core kernel (flash_fwd_wgmma_kernel).  One warpgroup
// of 128 threads per block.  Q stays in shared memory as bf16, loaded
// once; K/V tiles of 64 keys come through a two-stage ring filled by
// 16-byte cp.async, so the next tile loads while this one computes.
// S = Q K^T is wgmma m64n64k16 from shared memory (both K-major); the
// online softmax runs on the accumulator registers in the log2 domain
// (scale * log2 e folded into S, exp2f), each row's max and sum over the
// four lanes that hold it; P is rounded to bf16 in registers and is the
// register A operand of O += P V (wgmma, V the MN-major B).  The mask is
// applied only on tiles that need it (tile_needs_mask: the causal
// diagonal, window edges, ragged Sk, padded rows, mixed segments), with
// the tile's key segments staged in shared memory; full tiles skip it.
// Row tiles are launched in reverse, so the heaviest causal tiles start
// first.  O is normalised in registers and stored as bf16 pairs.  P is
// rounded to bf16 before its product, as attention_reference casts the
// probabilities to v's dtype; l sums the fp32 p, so the lse is exact.
// D = 32 is held zero-padded to 64 columns (the wgmma tile's K is 64
// elements of a 128-byte swizzle row).  tests/test_torch_attention_tiles.py
// mirrors the tile loop and its masks, and this rounding, on the CPU.
//
// fp32: the scalar kernel (flash_fwd_kernel), fp32 FMAs from shared
// memory, by design: the tensor cores take fp32 only as TF32, whose ~3
// decimal digits cannot meet the fp32 checks (1e-5), and fp32 is the
// port's checking dtype; serving and training run in bf16.

#include "sm90.cuh"

namespace {

using nbd::kTileBytes;
using nbd::kWarpgroup;
using nbd::padded_dim;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 64;      // folded query rows per block
constexpr int kBN = 64;      // keys per tile
constexpr int kThreads = 256;  // scalar kernel

// ----------------------------------------------------------------------
// bf16: tensor cores

// Shared memory of flash_fwd_wgmma_kernel, byte offsets from a
// 1024-byte-aligned base: Q, two stages of K and of V (each kNcb tiles),
// two stages of the tile's key segments.
template <int D>
struct FwdSmem {
  static constexpr int kNcb = padded_dim(D) / 64;  // 64-column blocks
  static constexpr int kQ = 0;
  static constexpr int kK = kNcb * kTileBytes;
  static constexpr int kV = kK + 2 * kNcb * kTileBytes;
  static constexpr int kSeg = kV + 2 * kNcb * kTileBytes;
  static constexpr size_t kBytes = kSeg + 2 * kBN * sizeof(int) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWarpgroup) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ qseg, const int* __restrict__ kseg, int Sq, int Sk, int H, int Hkv,
    int group, float scale, int causal, int window, int q_off, int k_off) {
  using L = FwdSmem<D>;
  constexpr int kNcb = L::kNcb, kSteps = padded_dim(D) / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nbd::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* seg_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::kSeg);

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest causal tiles first
  const int nrows = Sq * group;
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool has_seg = kseg != nullptr;

  // This thread's two rows, 16 w + g + 8 h: query index (-1 if padded)
  // and segment; and whether one segment covers every row of the block.
  const int seg0 = has_seg ? qseg[static_cast<size_t>(b) * Sq + row0 / group] : 0;
  int qi_t[2], seg_t[2];
  bool rows_vote = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = row0 + 16 * w + g + 8 * h;
    qi_t[h] = R < nrows ? R / group : -1;
    seg_t[h] = (has_seg && R < nrows) ? qseg[static_cast<size_t>(b) * Sq + R / group] : 0;
    rows_vote = rows_vote && (qi_t[h] < 0 || seg_t[h] == seg0);
  }
  const bool rows_uniform = __syncthreads_and(rows_vote) != 0;

  auto kv_row = [&](const __nv_bfloat16* x, int ki) -> const __nv_bfloat16* {
    return ki < Sk ? x + ((static_cast<size_t>(b) * Sk + ki) * Hkv + hk) * D : nullptr;
  };
  // Start the copy of key tile kb0 (K, V and the keys' segments) into
  // stage st.
  auto issue = [&](int kb0, int st) {
    nbd::load_tile<D, kWarpgroup>(base + L::kK + st * kNcb * kTileBytes, tid, k,
                                  [&](int r) { return kv_row(k, kb0 + r); });
    nbd::load_tile<D, kWarpgroup>(base + L::kV + st * kNcb * kTileBytes, tid, v,
                                  [&](int r) { return kv_row(v, kb0 + r); });
    if (has_seg && tid < kBN) {
      const int ki = kb0 + tid;
      nbd::cp_async4(seg_s + st * kBN + tid,
                     kseg + static_cast<size_t>(b) * Sk + min(ki, Sk - 1), ki < Sk);
    }
    nbd::cp_async_commit();
  };

  nbd::load_tile<D, kWarpgroup>(base + L::kQ, tid, q, [&](int r) -> const __nv_bfloat16* {
    const int R = row0 + r;
    if (R >= nrows) return nullptr;
    return q + ((static_cast<size_t>(b) * Sq + R / group) * H + hk * group + R % group) * D;
  });
  int kbeg, kend;
  nbd::key_range(row0, nrows, group, Sk, causal, window, q_off, k_off, &kbeg, &kend);
  if (kbeg < kend)
    issue(kbeg, 0);
  else
    nbd::cp_async_commit();

  float acc[kNcb][32];
#pragma unroll
  for (int c = 0; c < kNcb; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  int st = 0;
  for (int kb0 = kbeg; kb0 < kend; kb0 += kBN, st ^= 1) {
    if (kb0 + kBN < kend) {
      issue(kb0 + kBN, st ^ 1);
      nbd::cp_async_wait<1>();
    } else {
      nbd::cp_async_wait<0>();
    }
    nbd::fence_proxy_async();
    // Tile kb0 (and Q) in shared memory; one segment over its keys and rows?
    // The vote is also the barrier that makes every thread's copies visible
    // to the whole warpgroup, so it runs on every tile.
    const bool vote = !has_seg || tid >= kBN || kb0 + tid >= Sk || seg_s[st * kBN + tid] == seg0;
    const bool tile_vote = __syncthreads_and(vote) != 0;
    const bool seg_uniform = rows_uniform && tile_vote;
    const uint32_t kt = base + L::kK + st * kNcb * kTileBytes;
    const uint32_t vt = base + L::kV + st * kNcb * kTileBytes;

    // S = Q K^T (fp32 in registers).
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    nbd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      nbd::wgmma_ss(s, nbd::desc_kmajor(base + L::kQ + off), nbd::desc_kmajor(kt + off), kk > 0);
    }
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
    nbd::fence_regs(s);

    // Online softmax in the log2 domain; s[4 j + 2 h + e] is row
    // 16 w + g + 8 h, key kb0 + 8 j + 2 t + e.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= sl2;
    if (nbd::tile_needs_mask(row0, kb0, nrows, group, Sk, causal, window, q_off, k_off, has_seg,
                             seg_uniform)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;
            const bool keep = nbd::pair_kept(qi_t[h], kb0 + c, Sk, causal, window, q_off, k_off) &&
                              (!has_seg || seg_t[h] == seg_s[st * kBN + c]);
            if (!keep) s[4 * j + 2 * h + e] = kNegInf;
          }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * h + e] - m_new);
          s[4 * j + 2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * corr[h] + sum;  // this thread's columns; summed over the row at the end
    }
#pragma unroll
    for (int c = 0; c < kNcb; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];

    // O += P V, P rounded to bf16 as the register A operand.
    uint32_t a[4][4];
    nbd::acc_to_a(s, a);
    nbd::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNcb; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        nbd::wgmma_rs(acc[c], a[kk], nbd::desc_mnmajor(vt + c * kTileBytes + kk * 16 * 128));
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kNcb; ++c) nbd::fence_regs(acc[c]);
    __syncthreads();  // every thread is done with stage st before it is refilled
  }
  nbd::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int R = row0 + 16 * w + g + 8 * h;
    if (qi_t[h] < 0) continue;
    const int qi = qi_t[h], hq = hk * group + R % group;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H + hq) * D;
#pragma unroll
    for (int c = 0; c < kNcb; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * h] * inv, acc[c][4 * j + 2 * h + 1] * inv);
      }
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + hq) * Sq + qi] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* qseg, const int* kseg, int B, int Sq, int Sk, int H, int Hkv,
                float scale, int causal, int window, int q_off, int k_off, cudaStream_t s) {
  static std::atomic<unsigned long long> attr_done{0};
  constexpr size_t smem = FwdSmem<D>::kBytes;
  cudaError_t err = nbd::ensure_smem(reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>),
                                     smem, attr_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = H / Hkv;
  const int tiles = (Sq * group + kBM - 1) / kBM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * Hkv, tiles);
  flash_fwd_wgmma_kernel<D><<<grid, kWarpgroup, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, qseg, kseg, Sq,
      Sk, H, Hkv, group, scale, causal, window, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// fp32: scalar FMAs

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBM * (D + 1) + kBN * D + kBM * (kBN + 1) + 3 * kBM) +
         sizeof(int) * 2 * kBM;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ qseg,
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
      x = q[((static_cast<size_t>(b) * Sq + qi) * H + hk * group + g) * D + d] * scale;
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

  int kbeg, kend;
  nbd::key_range(row0, nrows, group, Sk, causal, window, q_off, k_off, &kbeg, &kend);

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
        kx = k[off];
        vx = v[off];
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
        bool keep = nbd::pair_kept(qi, ki, Sk, causal, window, q_off, k_off);
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
    float* dst = o + ((static_cast<size_t>(b) * Sq + qi) * H + hk * group + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j] / l_safe;
  }
  if (tid < kBM && row0 + tid < nrows) {
    const int R = row0 + tid, qi = R / group, g = R % group;
    lse[(static_cast<size_t>(b) * H + hk * group + g) * Sq + qi] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* qseg, const int* kseg, int B, int Sq, int Sk, int H, int Hkv,
                float scale, int causal, int window, int q_off, int k_off, cudaStream_t s) {
  static std::atomic<unsigned long long> attr_done{0};
  const size_t smem = smem_bytes<D>();
  cudaError_t err =
      nbd::ensure_smem(reinterpret_cast<const void*>(flash_fwd_kernel<D>), smem, attr_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = H / Hkv;
  dim3 grid((Sq * group + kBM - 1) / kBM, B * Hkv);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, qseg, kseg, Sq, Sk, H, Hkv, group, scale, causal, window,
      q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

#define NBD_FWD_ARGS q, k, v, o, lse, qseg, kseg, B, Sq, Sk, H, Hkv, scale, causal, window, q_off, k_off, s

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  window <= 0 means none; qseg /
// kseg (B, Sq) / (B, Sk) int32 or null.  bf16 q, k, v must be 16-byte
// aligned (cp.async).  Returns cudaGetLastError().
extern "C" int nbd_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, float* lse, const int* qseg,
                                       const int* kseg, int B, int Sq, int Sk, int H,
                                       int Hkv, int D, int dtype, int causal, float scale,
                                       int window, int q_off, int k_off, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_fp32<32>(NBD_FWD_ARGS);
      case 64: return launch_fp32<64>(NBD_FWD_ARGS);
      case 128: return launch_fp32<128>(NBD_FWD_ARGS);
      default: break;
    }
  } else if (dtype == 1) {
    if (!nbd::aligned16(q) || !nbd::aligned16(k) || !nbd::aligned16(v))
      return static_cast<int>(cudaErrorMisalignedAddress);
    switch (D) {
      case 32: return launch_bf16<32>(NBD_FWD_ARGS);
      case 64: return launch_bf16<64>(NBD_FWD_ARGS);
      case 128: return launch_bf16<128>(NBD_FWD_ARGS);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
