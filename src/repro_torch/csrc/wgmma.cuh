// Hopper (sm_90a) building blocks of the tensor-core kernels (flash_attn.cu,
// flash_attn_bwd.cu, and the split-precision GEMM core split_gemm.cuh of
// fused_is_grpo.cu): inline PTX for cp.async with zero-fill, the
// shared-memory swizzle and matrix descriptors of wgmma, and the warpgroup
// products they issue.
//
// Every operand tile is 64 rows of HD bf16 (HD = 32 or 64), one row per
// token, rows of ROWB = 2 * HD bytes, stored with the swizzle of that width
// (64 B or 128 B: the 16-byte chunk c of row r lands at chunk c ^ (r >> 1 & 3)
// or c ^ (r & 7)). The tile's base is 1024-byte aligned, so the hardware's
// swizzle, which works on address bits, matches the one the loads apply. The
// same tile serves both operand majors:
//   K-major (the product sums over hd, along a row: Q, K, dO, V in
//   S = Q K^T, dP = dO V^T and their transposes): 8-row groups SBO =
//   8 * ROWB apart, a k-step of 16 advances the start address by 32 bytes;
//   MN-major (the product sums over the rows: V in O += P V, K in
//   dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q; the transpose bit
//   of the bf16 wgmma): 8-row groups SBO = 8 * ROWB apart, N = HD spans one
//   swizzle atom, a k-step advances 16 rows.
// Accumulators follow the wgmma m64nN f32 layout: thread t of the warpgroup
// (warp w = t / 32, lane l) holds, for register i, row 16 w + l / 4 + 8 (i / 2
// % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2. Registers 8 kk .. 8 kk + 7 of
// a 64-column accumulator, rounded to bf16 in pairs, are the register A
// operand of k-step kk: the S fragment is the A fragment of P V.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace repro {
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of ROWB-byte rows
template <int ROWB>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  static_assert(ROWB == 64 || ROWB == 128, "rows of 32 or 64 bf16");
  return ROWB == 128 ? r * 128 + ((c ^ (r & 7)) << 4)
                     : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source address must still be mapped: callers clamp it to row 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's completed cp.async writes visible to wgmma (the async
// proxy); follow with __syncthreads() before any thread issues the product
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies a tile of 64 rows of HD bf16 (row i from src + i * stride
// elements) into the swizzled tile at dst; rows >= valid are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int valid) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < 64 * CHUNKS; e += 128) {
    const int r = e / CHUNKS, c = e % CHUNKS;
    const bool ok = r < valid;
    cp_async16(dst + swizzle<2 * HD>(r, c), src + (ok ? r : 0) * stride + c * 8,
               ok);
  }
}

// matrix descriptors of a swizzled tile (see the header note): SBO is the
// stride of 8-row groups. A K-major tile ignores LBO. An MN-major tile reads
// LBO as the stride of swizzle atoms along N, and N = HD fills one atom, so
// LBO is set to the 8-row stride too: the descriptor is then the same under
// either reading of the two fields.
template <int HD>
__device__ __forceinline__ uint64_t desc_bits(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t ROWB = 2 * HD;
  constexpr uint64_t mode = ROWB == 128 ? 1 : 2;  // 128 B or 64 B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * ROWB >> 4) << 32) | (mode << 62);
}
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return desc_bits<HD>(addr, 16);
}
template <int HD>
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t addr) {
  return desc_bits<HD>(addr, 8 * 2 * HD);
}

// descriptor advance (in 16-byte units) of one k-step of 16
template <int HD>
__host__ __device__ constexpr uint64_t kstep_kmajor() { return 32 >> 4; }
template <int HD>
__host__ __device__ constexpr uint64_t kstep_mnmajor() { return 16 * 2 * HD >> 4; }

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins an accumulator's registers at this point of the program: the
// compiler sees the asynchronous product as complete when its asm returns,
// so reads after mma_wait() and writes before the product are fenced.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A operands, which a product reads until mma_wait()
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of the four k-steps from a 64-column accumulator, rounded once
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// The same, as two bf16 terms: hi = bf16(x), lo = bf16(x - hi), so that
// hi + lo carries x to ~2^-17 relative (the backward's P and dS)
__device__ __forceinline__ void to_a_frags2(const float (&s)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
      const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
      hi[kk][j] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
      lo[kk][j] = pack_bf16(x0 - __bfloat162float(h0),
                            x1 - __bfloat162float(h1));
    }
}

// The warpgroup products. ss: A and B from shared memory, each K-major
// (T = 0) or MN-major (T = 1, its transpose bit: A's for dw = dl^T h, whose
// A is read along M), the sum overwritten (accumulate == 0) or added to.
// rs: A from registers, B MN-major (the transpose bit), always added to.
template <int TB = 0, int TA = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  static_assert((TB == 0 || TB == 1) && (TA == 0 || TA == 1), "transpose bits");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},\n"
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},\n"
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace tc
}  // namespace repro
