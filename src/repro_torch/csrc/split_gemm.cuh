// A tensor-core (wgmma, sm_90a) GEMM core for float32 products taken from
// bf16 terms: the main loop of the loss backward's logits and dh kernels
// (fused_is_grpo.cu), written so that the forward, dw and the fused log-prob
// can move onto it.
//
// One block of two warpgroups (256 threads) computes a 128 x 128 f32 tile
// C = A B, each warpgroup 64 rows x 128 columns as two m64n64 accumulators
// (wgmma m64n64k16, bf16 inputs, f32 sums), over k tiles of 64:
//
//   A (M x K) is K-major: row-major in memory. bf16 A (the hidden states) is
//     staged as it is; float32 A (dl) as two bf16 terms.
//   B (K x N) is float32 (the f32 master unembedding), staged as two bf16
//     terms, and read in its own memory layout: K-major when k is its
//     contiguous dimension, MN-major (the transpose bit of the bf16 wgmma)
//     when n is. So the tied (V, d) embedding and an untied (d, V) lm_head
//     both serve both products (logits = h w, dh = dl w^T) with no
//     transposed copy.
//
// Split precision: a float32 x becomes hi = bf16(x) and mid = bf16(x - hi)
// (x - hi is exact in f32), so hi + mid carries x to ~2^-17 relative. The
// products summed are
//   bf16 A:  A B_hi + A B_mid                       (2 passes; A exact)
//   f32 A:   A_hi B_hi + A_hi B_mid + A_mid B_hi    (3 passes)
// each product of two bf16 values exact in f32 and summed in f32. The
// dropped A_mid B_mid term and the terms' own rounding leave ~2^-16 of
// each product's magnitude, well inside the loss backward's 1e-4 of the
// largest gradient element; one bf16 pass (2^-9) is not
// (tests/test_torch_split_numerics.py emulates both at the train shape).
//
// Staging: every thread loads its share of the next k tile into registers
// with 16-byte loads (4-byte loads where a row is not 16-byte aligned), the
// warpgroups' products of the current tile run meanwhile, then the tile is
// split and stored into the other of two stages of 64 x 64 bf16 subtiles in
// shared memory, with the 128-byte swizzle of wgmma.cuh (one subtile is one
// swizzle atom: 64 rows of 128 bytes, so the descriptors are those of the
// flash kernels at hd 64). Rows past M or N and k past K read as zeros.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro {
namespace sg {

constexpr int BM = 128;          // rows of a block tile
constexpr int BN = 128;          // columns of a block tile
constexpr int BK = 64;           // depth of a k tile
constexpr int NT = 256;          // two warpgroups
constexpr int SUB = 64 * 128;    // bytes of one 64 x 64 bf16 subtile

// A row-major matrix in memory: element (r, c) at p[r * stride + c]; rows
// >= rows and columns >= cols read as zero. vec: 16-byte loads of 4 f32
// are allowed (stride, cols and the pointer are multiples of 4 elements).
template <typename T>
struct View {
  const T* p;
  long long stride;
  int rows, cols;
  int vec;
};

template <typename TA>
struct Layout {
  static constexpr int kATerms = std::is_same<TA, float>::value ? 2 : 1;
  // per stage: A [term][warpgroup], then B [term][column half]
  static constexpr int kStage = (2 * kATerms + 4) * SUB;
  static constexpr int kBytes = 2 * kStage + 1024;  // + alignment slack
  __device__ static uint32_t a(uint32_t st, int term, int g) {
    return st + (term * 2 + g) * SUB;
  }
  __device__ static uint32_t b(uint32_t st, int term, int h) {
    return st + (2 * kATerms + term * 2 + h) * SUB;
  }
};

__device__ __forceinline__ float4 ld_f32x4(const View<float>& v, int r,
                                           int c) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= v.rows || c >= v.cols) return x;
  const float* p = v.p + (long long)r * v.stride + c;
  if (v.vec) return __ldcg(reinterpret_cast<const float4*>(p));
  x.x = __ldcg(p);
  if (c + 1 < v.cols) x.y = __ldcg(p + 1);
  if (c + 2 < v.cols) x.z = __ldcg(p + 2);
  if (c + 3 < v.cols) x.w = __ldcg(p + 3);
  return x;
}

// 8 bf16 (cols a multiple of 8: a chunk is wholly inside or outside)
__device__ __forceinline__ uint4 ld_bf16x8(const View<__nv_bfloat16>& v,
                                           int r, int c) {
  if (r >= v.rows || c >= v.cols) return make_uint4(0, 0, 0, 0);
  return __ldcg(reinterpret_cast<const uint4*>(v.p + (long long)r * v.stride + c));
}

// 4 f32 at (row r, columns 4 c4 .. 4 c4 + 3) of a subtile, as two bf16 terms
__device__ __forceinline__ void st_split4(uint32_t hi, uint32_t mid, int r,
                                          int c4, float4 x) {
  const uint32_t off = tc::swizzle<128>(r, c4 >> 1) + (c4 & 1) * 8;
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  const __nv_bfloat162 m01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
  const __nv_bfloat162 m23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(hi + off),
               "r"(*reinterpret_cast<const uint32_t*>(&h01)),
               "r"(*reinterpret_cast<const uint32_t*>(&h23)));
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(mid + off),
               "r"(*reinterpret_cast<const uint32_t*>(&m01)),
               "r"(*reinterpret_cast<const uint32_t*>(&m23)));
}

__device__ __forceinline__ void st_bf16x8(uint32_t dst, int r, int c8,
                                          uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   dst + tc::swizzle<128>(r, c8)),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w));
}

// One k tile's share of this thread: A's two 64-row subtiles and B's two
// 64-column subtiles, in registers between the load and the store.
template <typename TA>
struct Stage;

template <>
struct Stage<__nv_bfloat16> {
  uint4 a[2][2];
  __device__ void load_a(const View<__nv_bfloat16>& A, int m0, int k0) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = threadIdx.x + NT * i;
        a[g][i] = ld_bf16x8(A, m0 + 64 * g + (idx >> 3), k0 + 8 * (idx & 7));
      }
  }
  __device__ void store_a(uint32_t st) const {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = threadIdx.x + NT * i;
        st_bf16x8(Layout<__nv_bfloat16>::a(st, 0, g), idx >> 3, idx & 7,
                  a[g][i]);
      }
  }
};

template <>
struct Stage<float> {
  float4 a[2][4];
  __device__ void load_a(const View<float>& A, int m0, int k0) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = threadIdx.x + NT * i;
        a[g][i] = ld_f32x4(A, m0 + 64 * g + (idx >> 4), k0 + 4 * (idx & 15));
      }
  }
  __device__ void store_a(uint32_t st) const {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = threadIdx.x + NT * i;
        st_split4(Layout<float>::a(st, 0, g), Layout<float>::a(st, 1, g),
                  idx >> 4, idx & 15, a[g][i]);
      }
  }
};

// B's two subtiles of k tile k0 for block columns n0: K-major, rows n0 + 64 h
// + r and columns k0 + c of memory; MN-major, rows k0 + r and columns n0 +
// 64 h + c.
template <bool B_KMAJOR>
__device__ __forceinline__ void load_b(float4 (&b)[2][4], const View<float>& B,
                                       int n0, int k0) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + NT * i;
      const int r = idx >> 4, c = 4 * (idx & 15);
      b[h][i] = B_KMAJOR ? ld_f32x4(B, n0 + 64 * h + r, k0 + c)
                         : ld_f32x4(B, k0 + r, n0 + 64 * h + c);
    }
}

template <typename TA>
__device__ __forceinline__ void store_b(const float4 (&b)[2][4], uint32_t st) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + NT * i;
      st_split4(Layout<TA>::b(st, 0, h), Layout<TA>::b(st, 1, h), idx >> 4,
                idx & 15, b[h][i]);
    }
}

// The products of one k tile (stage st) for warpgroup g into d, added to
// it, or overwriting it with `fresh`.
template <typename TA, bool B_KMAJOR>
__device__ __forceinline__ void tile_products(float (&d)[2][32], uint32_t st,
                                              int g, bool fresh) {
  using namespace repro::tc;
  using L = Layout<TA>;
  constexpr int TB = B_KMAJOR ? 0 : 1;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint64_t da[L::kATerms];
#pragma unroll
    for (int ta = 0; ta < L::kATerms; ++ta)
      da[ta] = make_desc<64>(L::a(st, ta, g)) + kk * kstep_kmajor<64>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t db[2];
#pragma unroll
      for (int tb = 0; tb < 2; ++tb)
        db[tb] = B_KMAJOR
                     ? make_desc<64>(L::b(st, tb, h)) + kk * kstep_kmajor<64>()
                     : make_desc_mn<64>(L::b(st, tb, h)) +
                           kk * kstep_mnmajor<64>();
      mma_ss_n64<TB>(d[h], da[0], db[0], !(fresh && kk == 0));  // A_hi B_hi
      mma_ss_n64<TB>(d[h], da[0], db[1], 1);                    // A_hi B_mid
      if constexpr (L::kATerms == 2)
        mma_ss_n64<TB>(d[h], da[1], db[0], 1);                  // A_mid B_hi
    }
  }
}

// acc[h] (this warpgroup's rows m0 + 64 g .. + 63, columns n0 + 64 h ..
// + 63) = sum over k < K of A(m, k) B(k, n), from the split terms. smem: the
// block's dynamic shared memory, 1024-byte aligned, Layout<TA>::kBytes.
//
// PROMOTE: each k tile's products go to a fresh accumulator, added to acc
// by an f32 add after the tile. The tensor cores' f32 sums truncate, so one
// accumulator carried through thousands of k steps drifts with their
// number: dh = dl w^T over V = 128256 (8016 steps of 16, three passes)
// missed the loss backward's 1e-4 of its largest element without it.
template <typename TA, bool B_KMAJOR, bool PROMOTE>
__device__ __forceinline__ void gemm_tile(const View<TA>& A,
                                          const View<float>& B, int m0,
                                          int n0, int K, uint32_t smem,
                                          float (&acc)[2][32]) {
  using namespace repro::tc;
  using L = Layout<TA>;
  const int g = threadIdx.x / 128;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float part[2][32];  // used only with PROMOTE

  Stage<TA> sa;
  float4 sb[2][4];
  sa.load_a(A, m0, 0);
  load_b<B_KMAJOR>(sb, B, n0, 0);
  sa.store_a(smem);
  store_b<TA>(sb, smem);
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t st = smem + (kt & 1) * L::kStage;
    const bool more = kt + 1 < nk;
    if (more) {  // the next tile's loads fly while this one multiplies
      sa.load_a(A, m0, (kt + 1) * BK);
      load_b<B_KMAJOR>(sb, B, n0, (kt + 1) * BK);
    }
    auto multiply = [&](float (&d)[2][32]) {
      fence_regs(d[0]);
      fence_regs(d[1]);
      mma_fence();
      tile_products<TA, B_KMAJOR>(d, st, g, PROMOTE);
      mma_commit();
      fence_regs(d[0]);
      fence_regs(d[1]);
      if (more) {  // the other stage was released at the end of tile kt - 1
        const uint32_t nx = smem + ((kt + 1) & 1) * L::kStage;
        sa.store_a(nx);
        store_b<TA>(sb, nx);
      }
      mma_wait();
      fence_regs(d[0]);
      fence_regs(d[1]);
    };
    if constexpr (PROMOTE) {
      multiply(part);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] += part[h][i];
    } else {
      multiply(acc);
    }
    fence_async_smem();
    __syncthreads();
  }
}

}  // namespace sg
}  // namespace repro
