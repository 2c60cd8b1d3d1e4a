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
// bound by operations.
//
// Design.  Blocks on the H100 run in no order, so nothing is carried
// between them as the TPU's sequential grid carries its fp32 scratch:
// a loop inside the block takes the sequential axis' place.
//   * K2: one block per (batch * kv head, tile of 64 "folded" rows),
//     row r = qi * group + g, exactly K1's layout: the whole GQA group
//     of a query position shares each K/V tile.  The block walks the
//     key tiles its causal / window range can see (key_range in
//     sm90.cuh: _causal_k_iters / _window_first_k_block), the same walk
//     as K1's.
//   * K3: one block per (batch * kv head, tile of 64 keys).  K and V
//     stay in shared memory while the block walks the folded rows --
//     the group's heads and the query tiles together -- that its
//     range can see (row_range: _causal_first_q_block /
//     _window_last_q_block in folded rows), so dK/dV sum over the group
//     inside the block, in registers, with no float atomics: the result
//     is the same on every run.
// Padded query rows and keys beyond Sk carry p = 0 (the TPU kernel's
// seq_q_valid), so they add nothing.  Rows with no key at all are
// undefined, as on the TPU.
//
// K2 in bf16 runs on the tensor cores (flash_bwd_dq_wgmma_kernel), laid
// out as K1's forward: one warpgroup of 128 threads per block, the 64
// folded rows as the wgmma M.  Q and dO row tiles are loaded once as
// swizzled bf16; each thread keeps its two rows' lse (log2 domain) and
// delta in registers.  64-key K/V tiles and their key segments come
// through a two-stage cp.async ring.  Per key tile: S = Q K^T and
// dP = dO V^T (wgmma from shared memory, both operands K-major), then in
// registers P = exp2(S scale log2 e - lse log2 e), masked only where
// tile_needs_mask says so, and dS = P (dP - delta); then dQ += dS K with
// dS as the register A operand and K as the MN-major B -- the role V
// plays in K1's O += P V, so no transpose goes through shared memory.
// dS goes in as two bf16 operands, hi = bf16(dS) and lo = bf16(dS - hi):
// dS is signed and its terms cancel, and one bf16 rounding takes dQ to
// 0.89 of the bf16 limit in the CPU emulation against 0.40 with hi + lo
// (PERF.md), at 4 products per tile instead of 3.  At D = 128 dQ is two
// 64-column accumulators.  dQ is scaled once at the end and stored as
// bf16 pairs in q's layout.  Row tiles are launched heaviest-first, as
// K1's are.  What bounds it at the train shape is the tensor cores'
// rate; one warpgroup with no overlap of the exp2 math and the products
// keeps it well above that bound.
//
// K3 in bf16 runs on the tensor cores (flash_bwd_dkv_wgmma_kernel): the
// keys are the wgmma M.  One warpgroup per 64-column block of dK/dV (one
// for D <= 64, two for D = 128, each holding 64 fp32 registers of dK+dV
// per thread instead of 128).  K and V sit in shared memory as bf16,
// loaded once; (Q, dO) row tiles of 64 come through a two-stage cp.async
// ring with the tile's lse, delta and segments (4-byte cp.async) and
// query index.  Per row tile: S^T = K Q^T and dP^T = V dO^T (wgmma from
// shared memory, both operands K-major), then in registers
// P^T = exp2(S^T scale log2 e - lse log2 e), masked only where
// tile_needs_mask says so, and dS^T = P^T (dP^T - delta); then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A operands
// and dO, Q read as MN-major B from the same shared tiles -- keys as M is
// what keeps any transpose out of shared memory.  P^T and dS^T each go in
// as two bf16 operands, hi = bf16(x) and lo = bf16(x - hi): dK and dV sum
// thousands of rows, and one bf16 rounding of every term alone takes the
// result past the bf16 limits (measured on the card and in the CPU
// emulation, PERF.md); hi + lo keeps ~16 bits for 1.5x the products.
// dK is scaled once at the end.  Key tiles are launched in order, so the
// heaviest causal tiles (small kb0, the most rows) start first.  D = 32
// is zero-padded to 64 columns.  At D = 128 each of the two warpgroups
// computes the whole 64 x 64 S^T and dP^T (over all 128 columns) and its
// own exp2 and mask, and uses them only for its 64 columns of dK/dV:
// those products and that math are done twice (D = 64 is the train
// path's width; splitting them through shared memory is queued in
// ROADMAP).  tests/test_torch_attention_tiles.py mirrors the tile loops,
// their masks and both kernels' rounding on the CPU.
//
// In fp32 both kernels stay scalar by design (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel: fp32 FMAs from padded shared memory): the tensor
// cores take fp32 only as TF32, whose ~3 decimal digits cannot meet the
// fp32 checks (1e-4), and fp32 is the port's checking dtype; training
// runs in bf16.

#include "sm90.cuh"

#include <type_traits>

namespace {

using nbd::kTileBytes;
using nbd::kWarpgroup;
using nbd::padded_dim;

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kBM = 64;      // folded query rows per tile
constexpr int kBN = 64;      // keys per tile
constexpr int kThreads = 256;
constexpr int kPP = kBN + 1;  // padded stride of the 64x64 p / dS tiles

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

// ----------------------------------------------------------------------
// fp32: scalar FMAs

// Shared memory of both scalar kernels: Q, dO, K, V tiles (fp32, rows
// padded to D + 1 floats so column reads miss no bank), the p and dS
// tiles, and per-row / per-key scalars.
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
template <int D>
__device__ void load_rows(const Args& a, const Smem<D>& sm, int b, int hk, int row0) {
  constexpr int DP = D + 1;
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const int nrows = a.Sq * a.group;
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i % D, R = row0 + r;
    float x = 0.f, y = 0.f;
    if (R < nrows) {
      const int qi = R / a.group, g = R % a.group;
      const size_t off = ((static_cast<size_t>(b) * a.Sq + qi) * a.H + hk * a.group + g) * D + d;
      x = q[off] * a.scale;
      y = dout[off];
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
template <int D>
__device__ void load_keys(const Args& a, const Smem<D>& sm, int b, int hk, int kb0) {
  constexpr int DP = D + 1;
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  for (int i = threadIdx.x; i < kBN * D; i += kThreads) {
    const int c = i / D, d = i % D, ki = kb0 + c;
    float kx = 0.f, vx = 0.f;
    if (ki < a.Sk) {
      const size_t off = ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D + d;
      kx = k[off];
      vx = v[off];
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
      bool keep = nbd::pair_kept(qi, ki, a.Sk, a.causal, a.window, a.q_off, a.k_off);
      if (has_seg) keep = keep && sm.qsg[r] == sm.ksg[c];
      const float p = keep ? expf(s[i][j] - lse) : 0.f;
      sm.p[r * kPP + c] = p;
      sm.ds[r * kPP + c] = p * (dp[i][j] - delta);
    }
  }
}

// K2: dQ for one (b * Hkv + hk, tile of 64 folded rows).
template <int D>
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

  load_rows<D>(a, sm, b, hk, row0);

  int kbeg, kend;
  nbd::key_range(row0, nrows, a.group, a.Sk, a.causal, a.window, a.q_off, a.k_off, &kbeg,
                 &kend);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kb0 = kbeg; kb0 < kend; kb0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    load_keys<D>(a, sm, b, hk, kb0);
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

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= nrows) continue;
    const int qi = R / a.group, g = R % a.group;
    float* dst = dq + ((static_cast<size_t>(b) * a.Sq + qi) * a.H + hk * a.group + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j] * a.scale;
  }
}

// K3: dK and dV for one (b * Hkv + hk, tile of 64 keys), summed over
// every folded row (all heads of the group) that can see the tile.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  static_assert(kBM == 64 && kBN == 64 && kThreads == 256, "tiling assumes 16x16 threads");
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int kb0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_keys<D>(a, sm, b, hk, kb0);

  int rbeg, rend;
  nbd::row_range(kb0, a.Sq, a.group, a.causal, a.window, a.q_off, a.k_off, &rbeg, &rend);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int row0 = rbeg; row0 < rend; row0 += kBM) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(a, sm, b, hk, row0);
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

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = kb0 + ty + 16 * i;
    if (ki >= a.Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[off + tx + 16 * j] = dk[i][j];
      dvp[off + tx + 16 * j] = dv[i][j];
    }
  }
}

// ----------------------------------------------------------------------
// K2 in bf16: tensor cores

// Shared memory of flash_bwd_dq_wgmma_kernel, byte offsets from a
// 1024-byte-aligned base: Q and dO (kNcb tiles each), two stages of K
// and of V, two stages of the key tile's segments.
template <int D>
struct DqSmem {
  static constexpr int kNcb = padded_dim(D) / 64;  // 64-column blocks
  static constexpr int kQ = 0;
  static constexpr int kO = kNcb * kTileBytes;
  static constexpr int kK = 2 * kNcb * kTileBytes;
  static constexpr int kV = kK + 2 * kNcb * kTileBytes;
  static constexpr int kSeg = kV + 2 * kNcb * kTileBytes;
  static constexpr size_t kBytes = kSeg + 2 * kBN * sizeof(int) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWarpgroup) flash_bwd_dq_wgmma_kernel(Args a) {
  using L = DqSmem<D>;
  constexpr int kNcb = L::kNcb, kSteps = padded_dim(D) / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nbd::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* seg_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::kSeg);

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest causal tiles first
  const int nrows = a.Sq * a.group;
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool has_seg = a.kseg != nullptr;

  // This thread's two rows, 16 w + g + 8 h: query index (-1 if padded),
  // segment, lse (log2 domain) and delta; and whether one segment covers
  // every row of the block.
  const int seg0 = has_seg ? a.qseg[static_cast<size_t>(b) * a.Sq + row0 / a.group] : 0;
  int qi_t[2], seg_t[2];
  float lse_t[2], dl_t[2];
  bool rows_vote = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = row0 + 16 * w + g + 8 * h;
    const bool ok = R < nrows;
    const int qi = ok ? R / a.group : 0;
    const size_t li =
        (static_cast<size_t>(b) * a.H + hk * a.group + (ok ? R % a.group : 0)) * a.Sq + qi;
    qi_t[h] = ok ? qi : -1;
    seg_t[h] = (has_seg && ok) ? a.qseg[static_cast<size_t>(b) * a.Sq + qi] : 0;
    lse_t[h] = ok ? a.lse[li] * kLog2e : 0.f;
    dl_t[h] = ok ? a.delta[li] : 0.f;
    rows_vote = rows_vote && (!ok || seg_t[h] == seg0);
  }
  const bool rows_uniform = __syncthreads_and(rows_vote) != 0;

  auto kv_row = [&](const bf16* x, int ki) -> const bf16* {
    return ki < a.Sk ? x + ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D : nullptr;
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
                     a.kseg + static_cast<size_t>(b) * a.Sk + min(ki, a.Sk - 1), ki < a.Sk);
    }
    nbd::cp_async_commit();
  };

  auto row_ptr = [&](const bf16* x) {
    return [=](int r) -> const bf16* {
      const int R = row0 + r;
      if (R >= nrows) return nullptr;
      return x + ((static_cast<size_t>(b) * a.Sq + R / a.group) * a.H + hk * a.group +
                  R % a.group) * D;
    };
  };
  nbd::load_tile<D, kWarpgroup>(base + L::kQ, tid, q, row_ptr(q));
  nbd::load_tile<D, kWarpgroup>(base + L::kO, tid, dout, row_ptr(dout));
  int kbeg, kend;
  nbd::key_range(row0, nrows, a.group, a.Sk, a.causal, a.window, a.q_off, a.k_off, &kbeg,
                 &kend);
  if (kbeg < kend)
    issue(kbeg, 0);
  else
    nbd::cp_async_commit();

  float acc[kNcb][32];
#pragma unroll
  for (int c = 0; c < kNcb; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  int st = 0;
  for (int kb0 = kbeg; kb0 < kend; kb0 += kBN, st ^= 1) {
    if (kb0 + kBN < kend) {
      issue(kb0 + kBN, st ^ 1);
      nbd::cp_async_wait<1>();
    } else {
      nbd::cp_async_wait<0>();
    }
    nbd::fence_proxy_async();
    // Tile kb0 (and Q, dO) in shared memory; one segment over its keys and
    // rows?  The vote is also the barrier that makes every thread's copies
    // visible to the whole warpgroup, so it runs on every tile.
    const bool vote =
        !has_seg || tid >= kBN || kb0 + tid >= a.Sk || seg_s[st * kBN + tid] == seg0;
    const bool tile_vote = __syncthreads_and(vote) != 0;
    const bool seg_uniform = rows_uniform && tile_vote;
    const uint32_t kt = base + L::kK + st * kNcb * kTileBytes;
    const uint32_t vt = base + L::kV + st * kNcb * kTileBytes;

    // S = Q K^T and dP = dO V^T; element 4 j + 2 h + e is row
    // 16 w + g + 8 h, key kb0 + 8 j + 2 t + e.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    nbd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      nbd::wgmma_ss(s, nbd::desc_kmajor(base + L::kQ + off), nbd::desc_kmajor(kt + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      nbd::wgmma_ss(dp, nbd::desc_kmajor(base + L::kO + off), nbd::desc_kmajor(vt + off), kk > 0);
    }
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
    nbd::fence_regs(s);
    nbd::fence_regs(dp);

    const bool masked = nbd::tile_needs_mask(row0, kb0, nrows, a.group, a.Sk, a.causal, a.window,
                                             a.q_off, a.k_off, has_seg, seg_uniform);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, c = 8 * j + 2 * t + e;
          float p = exp2f(fmaf(s[i], sl2, -lse_t[h]));
          if (masked && !(nbd::pair_kept(qi_t[h], kb0 + c, a.Sk, a.causal, a.window, a.q_off,
                                         a.k_off) &&
                          (!has_seg || seg_t[h] == seg_s[st * kBN + c])))
            p = 0.f;
          dp[i] = p * (dp[i] - dl_t[h]);
        }

    // dQ += dS K: dS as a bf16 hi + lo register A operand (one rounding
    // of the signed, cancelling dS alone comes too close to the bf16
    // limit), K MN-major.
    uint32_t ds_hi[4][4], ds_lo[4][4];
    nbd::acc_to_a_split(dp, ds_hi, ds_lo);
    nbd::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNcb; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bk = nbd::desc_mnmajor(kt + c * kTileBytes + kk * 16 * 128);
        nbd::wgmma_rs(acc[c], ds_hi[kk], bk);
        nbd::wgmma_rs(acc[c], ds_lo[kk], bk);
      }
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kNcb; ++c) nbd::fence_regs(acc[c]);
    __syncthreads();  // every thread is done with stage st before it is refilled
  }
  nbd::cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qi_t[h] < 0) continue;
    const int R = row0 + 16 * w + g + 8 * h;
    bf16* dst =
        dq + ((static_cast<size_t>(b) * a.Sq + qi_t[h]) * a.H + hk * a.group + R % a.group) * D;
#pragma unroll
    for (int c = 0; c < kNcb; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * h] * a.scale, acc[c][4 * j + 2 * h + 1] * a.scale);
      }
  }
}

// ----------------------------------------------------------------------
// K3 in bf16: tensor cores

// Shared memory of flash_bwd_dkv_wgmma_kernel, byte offsets from a
// 1024-byte-aligned base: K, V (kNcb tiles each), two stages of Q and of
// dO, two stages of the row tile's lse, delta, query index (-1: padded)
// and segment.
template <int D>
struct DkvSmem {
  static constexpr int kNcb = padded_dim(D) / 64;  // 64-column blocks = warpgroups
  static constexpr int kK = 0;
  static constexpr int kV = kNcb * kTileBytes;
  static constexpr int kQ = 2 * kNcb * kTileBytes;
  static constexpr int kO = kQ + 2 * kNcb * kTileBytes;
  static constexpr int kRows = kO + 2 * kNcb * kTileBytes;
  static constexpr size_t kBytes = kRows + 4 * 2 * kBM * sizeof(float) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWarpgroup * (padded_dim(D) / 64))
    flash_bwd_dkv_wgmma_kernel(Args a) {
  using L = DkvSmem<D>;
  constexpr int kNcb = L::kNcb, kThr = kWarpgroup * kNcb, kSteps = padded_dim(D) / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nbd::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);  // [2][64]
  float* dl_s = lse_s + 2 * kBM;
  int* qi_s = reinterpret_cast<int*>(dl_s + 2 * kBM);
  int* sg_s = qi_s + 2 * kBM;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int kb0 = blockIdx.y * kBN;  // launched in order: heaviest causal tiles first
  const int nrows = a.Sq * a.group;
  const int tid = threadIdx.x, wg = tid / kWarpgroup;  // wg: this warpgroup's dK/dV columns
  const int w = (tid % kWarpgroup) / 32, g = (tid % 32) / 4, t = tid % 4;
  const bool has_seg = a.kseg != nullptr;

  // K, V; this thread's two keys kb0 + 16 w + g + 8 h and their segments;
  // whether one segment covers every key of the tile.
  auto kv_row = [&](const bf16* x, int r) -> const bf16* {
    const int ki = kb0 + r;
    return ki < a.Sk ? x + ((static_cast<size_t>(b) * a.Sk + ki) * a.Hkv + hk) * D : nullptr;
  };
  nbd::load_tile<D, kThr>(base + L::kK, tid, k, [&](int r) { return kv_row(k, r); });
  nbd::load_tile<D, kThr>(base + L::kV, tid, v, [&](int r) { return kv_row(v, r); });
  const int seg0 = has_seg ? a.kseg[static_cast<size_t>(b) * a.Sk + kb0] : 0;
  int ki_t[2], seg_t[2];
  bool keys_vote = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ki_t[h] = kb0 + 16 * w + g + 8 * h;
    seg_t[h] = (has_seg && ki_t[h] < a.Sk) ? a.kseg[static_cast<size_t>(b) * a.Sk + ki_t[h]] : 0;
    keys_vote = keys_vote && (ki_t[h] >= a.Sk || seg_t[h] == seg0);
  }
  const bool keys_uniform = __syncthreads_and(keys_vote) != 0;

  // Start the copy of row tile row0 into stage st: Q, dO and the rows'
  // lse, delta and segments (zero for padded rows); the query index.
  auto issue = [&](int row0, int st) {
    auto row_ptr = [&](const bf16* x) {
      return [=](int r) -> const bf16* {
        const int R = row0 + r;
        if (R >= nrows) return nullptr;
        return x + ((static_cast<size_t>(b) * a.Sq + R / a.group) * a.H + hk * a.group +
                    R % a.group) * D;
      };
    };
    nbd::load_tile<D, kThr>(base + L::kQ + st * kNcb * kTileBytes, tid, q, row_ptr(q));
    nbd::load_tile<D, kThr>(base + L::kO + st * kNcb * kTileBytes, tid, dout, row_ptr(dout));
    if (tid < kBM) {
      const int R = row0 + tid;
      const bool ok = R < nrows;
      const int qi = ok ? R / a.group : 0, gg = ok ? R % a.group : 0;
      const size_t li = (static_cast<size_t>(b) * a.H + hk * a.group + gg) * a.Sq + qi;
      nbd::cp_async4(lse_s + st * kBM + tid, a.lse + li, ok);
      nbd::cp_async4(dl_s + st * kBM + tid, a.delta + li, ok);
      if (has_seg) nbd::cp_async4(sg_s + st * kBM + tid, a.qseg + size_t(b) * a.Sq + qi, ok);
      qi_s[st * kBM + tid] = ok ? qi : -1;
    }
    nbd::cp_async_commit();
  };

  int rbeg, rend;
  nbd::row_range(kb0, a.Sq, a.group, a.causal, a.window, a.q_off, a.k_off, &rbeg, &rend);
  if (rbeg < rend)
    issue(rbeg, 0);
  else
    nbd::cp_async_commit();

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  int st = 0;
  for (int row0 = rbeg; row0 < rend; row0 += kBM, st ^= 1) {
    if (row0 + kBM < rend) {
      issue(row0 + kBM, st ^ 1);
      nbd::cp_async_wait<1>();
    } else {
      nbd::cp_async_wait<0>();
    }
    nbd::fence_proxy_async();
    // Row tile row0 (and K, V) in shared memory; one segment over its rows
    // and keys?  The vote is also the barrier that makes every thread's
    // copies visible to the whole block, so it runs on every tile.
    const bool vote =
        !has_seg || tid >= kBM || row0 + tid >= nrows || sg_s[st * kBM + tid] == seg0;
    const bool tile_vote = __syncthreads_and(vote) != 0;
    const bool seg_uniform = keys_uniform && tile_vote;
    const uint32_t qt = base + L::kQ + st * kNcb * kTileBytes;
    const uint32_t ot = base + L::kO + st * kNcb * kTileBytes;

    // S^T = K Q^T and dP^T = V dO^T; element 4 j + 2 h + e is key
    // kb0 + 16 w + g + 8 h, row row0 + 8 j + 2 t + e.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    nbd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      nbd::wgmma_ss(s, nbd::desc_kmajor(base + L::kK + off), nbd::desc_kmajor(qt + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
      nbd::wgmma_ss(dp, nbd::desc_kmajor(base + L::kV + off), nbd::desc_kmajor(ot + off), kk > 0);
    }
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
    nbd::fence_regs(s);
    nbd::fence_regs(dp);

    const bool masked = nbd::tile_needs_mask(row0, kb0, nrows, a.group, a.Sk, a.causal, a.window,
                                             a.q_off, a.k_off, has_seg, seg_uniform);
    const int so = st * kBM;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, c = 8 * j + 2 * t + e;
          float p = exp2f(fmaf(s[i], sl2, -lse_s[so + c] * kLog2e));
          if (masked && !(nbd::pair_kept(qi_s[so + c], ki_t[h], a.Sk, a.causal, a.window,
                                         a.q_off, a.k_off) &&
                          (!has_seg || sg_s[so + c] == seg_t[h])))
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl_s[so + c]);
        }

    // dV += P^T dO, dK += dS^T Q: P^T and dS^T as bf16 hi + lo register
    // A operands (one rounding alone overshoots the bf16 limits on sums of
    // thousands of rows), dO and Q MN-major.
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    nbd::acc_to_a_split(s, p_hi, p_lo);
    nbd::acc_to_a_split(dp, ds_hi, ds_lo);
    nbd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = nbd::desc_mnmajor(ot + wg * kTileBytes + kk * 16 * 128);
      nbd::wgmma_rs(dv, p_hi[kk], bo);
      nbd::wgmma_rs(dv, p_lo[kk], bo);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = nbd::desc_mnmajor(qt + wg * kTileBytes + kk * 16 * 128);
      nbd::wgmma_rs(dk, ds_hi[kk], bq);
      nbd::wgmma_rs(dk, ds_lo[kk], bq);
    }
    nbd::wgmma_commit();
    nbd::wgmma_wait_all();
    nbd::fence_regs(dv);
    nbd::fence_regs(dk);
    __syncthreads();  // every thread is done with stage st before it is refilled
  }
  nbd::cp_async_wait<0>();

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ki_t[h] >= a.Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * a.Sk + ki_t[h]) * a.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * wg + 8 * j + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + col) = __floats2bfloat162_rn(
          dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + col) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------------
// launches

// One launch: grid (x, y) of `threads`, the kernel opted into `smem`
// bytes of dynamic shared memory once per device (attr_done: one static
// per kernel).
int launch_kernel(void (*kernel)(Args), const Args& a, dim3 grid, int threads, size_t smem,
                  std::atomic<unsigned long long>& attr_done, cudaStream_t s) {
  cudaError_t err = nbd::ensure_smem(reinterpret_cast<const void*>(kernel), smem, attr_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kDkv>
int launch(const Args& a, int B, cudaStream_t s) {
  static std::atomic<unsigned long long> attr_done{0};
  const int BH = B * a.Hkv;
  const int row_tiles = (a.Sq * a.group + kBM - 1) / kBM, key_tiles = (a.Sk + kBN - 1) / kBN;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (kDkv)
      return launch_kernel(flash_bwd_dkv_wgmma_kernel<D>, a, dim3(BH, key_tiles),
                           kWarpgroup * (padded_dim(D) / 64), DkvSmem<D>::kBytes, attr_done, s);
    else
      return launch_kernel(flash_bwd_dq_wgmma_kernel<D>, a, dim3(BH, row_tiles), kWarpgroup,
                           DqSmem<D>::kBytes, attr_done, s);
  } else if constexpr (kDkv) {
    return launch_kernel(flash_bwd_dkv_kernel<D>, a, dim3(key_tiles, BH), kThreads,
                         smem_bytes<D>(), attr_done, s);
  } else {
    return launch_kernel(flash_bwd_dq_kernel<D>, a, dim3(row_tiles, BH), kThreads,
                         smem_bytes<D>(), attr_done, s);
  }
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
    // Both bf16 kernels copy q, k, v and dout with 16-byte cp.async.
    if (!(nbd::aligned16(a.q) && nbd::aligned16(a.k) && nbd::aligned16(a.v) &&
          nbd::aligned16(a.dout)))
      return static_cast<int>(cudaErrorMisalignedAddress);
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
