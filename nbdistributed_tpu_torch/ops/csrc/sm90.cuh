// Hopper (sm_90a) building blocks shared by the port's kernels: 16- and
// 4-byte cp.async (the flash kernels and flash-decode), 128-byte-swizzled
// bf16 tiles, wgmma descriptors and the two wgmma shapes the flash
// kernels issue, written as inline PTX; and the tile ranges and mask
// tests every flash kernel shares.
//
// Tile layout.  A tile is 64 rows of 64 bf16 (128 bytes a row), 8 KB,
// at a 1024-byte-aligned shared address: 16-byte chunk c of row r sits at
// r * 128 + ((c ^ (r % 8)) * 16).  That is the 128-byte swizzle the
// tensor cores read (address bits 4-6 XOR bits 7-9).  A head dim of 128
// is two such tiles side by side (column blocks, 8 KB apart); 32 is one
// tile with columns 32-63 zero.  The same bytes serve as a K-major
// operand (rows = M or N, columns = the reduction) and as an MN-major B
// (rows = the reduction, columns = N).
//
// The tile ranges and mask tests below are mirrored line for line by
// tests/test_torch_attention_tiles.py, which holds them to the plain
// version's mask on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace nbd {

constexpr int kTileBytes = 64 * 64 * 2;  // one 64 x 64 bf16 tile
constexpr int kWarpgroup = 128;

// Head dim as held in shared memory: 32 is zero-padded to 64.
__host__ __device__ constexpr int padded_dim(int D) { return D < 64 ? 64 : D; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (a per-row scalar), or 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's cp.async / st.shared writes visible to wgmma's
// (async-proxy) reads; a barrier must follow before another thread's
// wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of chunk c (16 bytes, 8 bf16) of row r in a swizzled tile
// row of padded width DP: column block c / 8, chunk c % 8 in it.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * kTileBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Copy 64 rows of D bf16 values into the swizzled 64 x padded_dim(D)
// tile at shared address dst, 16 bytes per cp.async, kThreads threads
// sharing the work.  row_ptr(r) gives row r's first element, or nullptr
// for a row of zeros; columns D and up are zero.  `any` is any valid
// global address (read by no copy; cp.async wants one).
template <int D, int kThreads, typename RowPtr>
__device__ __forceinline__ void load_tile(uint32_t dst, int tid, const void* any,
                                          RowPtr row_ptr) {
  constexpr int kCpr = padded_dim(D) / 8;  // chunks per row
  static_assert((64 * kCpr) % kThreads == 0, "chunks split evenly");
#pragma unroll
  for (int it = 0; it < 64 * kCpr / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / kCpr, c = i % kCpr;
    const __nv_bfloat16* src = row_ptr(r);
    const bool ok = src != nullptr && c * 8 < D;
    cp_async16(dst + swz(r, c), ok ? static_cast<const void*>(src + c * 8) : any, ok);
  }
}

// wgmma shared-memory descriptor of a swizzled tile (128-byte swizzle,
// 8-row groups 1024 bytes apart).  K-major: the leading offset is unused
// (1 by convention).  MN-major: with N = 64 (one swizzle atom) the atom
// stride is unused too, so both offsets carry the 8-row-group stride.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return make_desc(addr, 16); }
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) { return make_desc(addr, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 fp32) = (accumulate ? d : 0) + A . B^T over 16 of the
// reduction: A (64 x 16) and B (64 x 16) both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) += A . B over 16 of the reduction: A (64 x 16 bf16)
// in registers, B (16 x 64) MN-major in shared memory (rows = the
// reduction index, 64 contiguous columns).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Two fp32 -> one bf16x2 register, lo in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64 x 64 wgmma as the register A operand of the
// next product (reduction over its 64 columns, four steps of 16), rounded
// to bf16.  Thread layout of both (lane = 4 * g + t in warp w): d[4j + 2h
// + e] is row 16 w + g + 8 h, column 8 j + 2 t + e; step kk's A registers
// are d[8 kk .. 8 kk + 7] in pairs.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack_bf16(d[8 * kk + 2 * q], d[8 * kk + 2 * q + 1]);
}

// The same as two bf16 operands, hi = bf16(d) and lo = bf16(d - hi):
// hi + lo carries d to ~16 bits, where hi alone keeps 8.
__device__ __forceinline__ void acc_to_a_split(const float (&d)[32], uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = d[8 * kk + 2 * q], x1 = d[8 * kk + 2 * q + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][q] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][q] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
}

// ----------------------------------------------------------------------
// Tile ranges and masks, shared by every flash kernel (folded rows: row
// R = qi * group + g of kv head hk).

// Keys the folded rows [row0, row0 + 64) can see, as [*kbeg, *kend) with
// kbeg rounded down to a 64-key tile (_causal_k_iters /
// _window_first_k_block on the TPU).
__device__ __forceinline__ void key_range(int row0, int nrows, int group, int Sk, int causal,
                                          int window, int q_off, int k_off, int* kbeg,
                                          int* kend) {
  const int qi_lo = row0 / group;
  const int qi_hi = (min(row0 + 64, nrows) - 1) / group;
  int b = 0, e = Sk;
  if (causal) {
    e = min(Sk, qi_hi + q_off - k_off + 1);
    if (window > 0) b = max(0, qi_lo + q_off - k_off - window + 1);
  }
  *kbeg = (b / 64) * 64;
  *kend = e;
}

// Folded rows that can see keys [kb0, kb0 + 64), as [*rbeg, *rend) with
// rbeg rounded down to a 64-row tile.  The first query that sees key kb0
// sits on its offset diagonal (_causal_first_q_block); with a window the
// last one sits window - 1 positions past the tile's last key
// (_window_last_q_block).
__device__ __forceinline__ void row_range(int kb0, int Sq, int group, int causal, int window,
                                          int q_off, int k_off, int* rbeg, int* rend) {
  const int nrows = Sq * group;
  int b = 0, e = nrows;
  if (causal) {
    const int qlo = max(0, kb0 + k_off - q_off);
    b = qlo < Sq ? qlo * group : nrows;
    if (window > 0) {
      const int qhi = kb0 + 64 - 1 + k_off - q_off + window - 1;
      e = qhi < 0 ? 0 : (qhi + 1 < Sq ? (qhi + 1) * group : nrows);
    }
  }
  *rbeg = (b / 64) * 64;
  *rend = e;
}

// Whether query qi (-1: a padded row) keeps key ki, segments aside.
__device__ __forceinline__ bool pair_kept(int qi, int ki, int Sk, int causal, int window,
                                          int q_off, int k_off) {
  bool keep = qi >= 0 && ki < Sk;
  if (causal) {
    keep = keep && (ki + k_off <= qi + q_off);
    if (window > 0) keep = keep && (ki + k_off > qi + q_off - window);
  }
  return keep;
}

// Whether the tile of folded rows [row0, row0 + 64) and keys [kb0, kb0 +
// 64) holds a pair the mask removes -- ragged Sk, padded rows, the causal
// diagonal, the window's edge, or segments, unless every row and key of
// the tile shares one segment (seg_uniform).  A tile that needs no mask
// is computed without one.
__device__ __forceinline__ bool tile_needs_mask(int row0, int kb0, int nrows, int group, int Sk,
                                                int causal, int window, int q_off, int k_off,
                                                bool has_seg, bool seg_uniform) {
  if (kb0 + 64 > Sk || row0 + 64 > nrows) return true;
  if (has_seg && !seg_uniform) return true;
  if (!causal) return false;
  const int q_first = row0 / group + q_off, q_last = (row0 + 63) / group + q_off;
  if (kb0 + 63 + k_off > q_first) return true;       // crosses the causal diagonal
  return window > 0 && kb0 + k_off <= q_last - window;  // crosses the window's edge
}

// Opt `kernel` into `bytes` of dynamic shared memory (over the 48 KB
// default) once per device, not before every launch: `done` (a static
// of the caller, one per kernel) holds a bit per device.
inline cudaError_t ensure_smem(const void* kernel, size_t bytes,
                               std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace nbd
