// A tensor-core (wgmma, sm_90a) GEMM core for float32 products taken from
// bf16 terms: the main loop of every loss kernel on the tensor cores
// (fused_is_grpo.cu): the forward's and the backward's logits, dh and dw.
//
// One block of two warpgroups (256 threads) computes a 128 x 128 f32 tile
// C = A B, each warpgroup 64 rows x 128 columns as two m64n64 accumulators
// (wgmma m64n64k16, bf16 inputs, f32 sums), over k tiles of 64. Each
// operand is an Operand<T, KMAJOR>: bf16 (the hidden states, exact) staged
// as it is, or float32 (the f32 master unembedding, dl) staged as two bf16
// terms; read in its own memory layout, K-major when k is its contiguous
// dimension, MN-major (the transpose bit of the bf16 wgmma) when m or n is.
// So the tied (V, d) embedding and an untied (d, V) lm_head serve the
// logits (h w) and dh (dl w^T) with no transposed copy, and dw = dl^T h
// reads dl and h as they lie (both MN-major).
//
// Split precision: a float32 x becomes hi = bf16(x) and mid = bf16(x - hi)
// (x - hi is exact in f32), so hi + mid carries x to ~2^-17 relative. The
// products summed are
//   one f32 operand:   X Y_hi + X Y_mid                     (2 passes)
//   two f32 operands:  A_hi B_hi + A_hi B_mid + A_mid B_hi  (3 passes)
// each product of two bf16 values exact in f32 and summed in f32. The
// dropped A_mid B_mid term and the terms' own rounding leave ~2^-16 of
// each product's magnitude, well inside the loss's tolerances; one bf16
// pass (2^-9) is not (tests/test_torch_split_numerics.py emulates both at
// the train shape).
//
// Staging, into the other of two stages of 64 x 64 bf16 subtiles in shared
// memory while the warpgroups' products of the current k tile run: a bf16
// operand is copied there by cp.async (16 bytes a copy, no registers); an
// f32 operand is loaded into registers (16-byte loads, 4-byte where a row
// is not 16-byte aligned), then split and stored. Subtiles take the
// 128-byte swizzle of wgmma.cuh (one subtile is one swizzle atom: 64 rows of
// 128 bytes, so the descriptors are those of the flash kernels at hd 64).
// A subtile's rows are m or n and its columns k (K-major), or the other way
// round (MN-major). Rows past M or N and k past K read as zeros.
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

// One operand's share of this thread of one k tile: 128 rows of M (A) or N
// (B) by 64 of K, read from a row-major View whose rows are m or n and
// columns k (KMAJOR) or whose rows are k and columns m or n. Subtile h holds
// m or n 64 h .. 64 h + 63 of the stage at `base`; a float32 operand's
// terms (hi, mid) are two sets of subtiles, held in registers between the
// load and the store, a bf16 operand copied straight into its subtiles.
template <typename T, bool KMAJOR>
struct Operand {
  using Elem = T;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kTerms = kF32 ? 2 : 1;
  static constexpr int kMN = KMAJOR ? 0 : 1;       // the transpose bit
  static constexpr int kElems = 16 / sizeof(T);    // per 16-byte load
  static constexpr int kChunks = 64 / kElems;      // loads per subtile row
  static constexpr int kLoads = 64 * kChunks / NT; // per thread per subtile
  float4 x[kF32 ? 2 : 1][kF32 ? kLoads : 1];  // f32 only

  // starts the loads of k tile k0 into stage `base` (subtile h of term t at
  // base + (2 t + h) SUB): f32 into x, bf16 by cp.async (callers commit)
  __device__ void load(const View<T>& v, int mn0, int k0, uint32_t base) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int idx = threadIdx.x + NT * i;
        const int r = idx / kChunks, c = idx % kChunks;
        const int row = KMAJOR ? mn0 + 64 * h + r : k0 + r;
        const int col = KMAJOR ? k0 + kElems * c : mn0 + 64 * h + kElems * c;
        if constexpr (kF32) {
          x[h][i] = ld_f32x4(v, row, col);
        } else {  // cols a multiple of 8: a chunk is wholly inside or outside
          const bool ok = row < v.rows && col < v.cols;
          tc::cp_async16(base + h * SUB + tc::swizzle<128>(r, c),
                         v.p + (ok ? (long long)row * v.stride + col : 0),
                         ok);
        }
      }
  }
  // splits the f32 loads into their subtiles (bf16: nothing left to do)
  __device__ void store(uint32_t base) const {
    if constexpr (kF32) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int idx = threadIdx.x + NT * i;
          st_split4(base + h * SUB, base + (2 + h) * SUB, idx / kChunks,
                    idx % kChunks, x[h][i]);
        }
    }
  }
  // descriptor of k step kk of subtile h of term t
  __device__ static uint64_t desc(uint32_t base, int t, int h, int kk) {
    using namespace repro::tc;
    const uint32_t a = base + (2 * t + h) * SUB;
    return KMAJOR ? make_desc<64>(a) + kk * kstep_kmajor<64>()
                  : make_desc_mn<64>(a) + kk * kstep_mnmajor<64>();
  }
};

// Shared memory of gemm_tile: two stages, each A's subtiles then B's.
template <class OA, class OB>
struct Layout {
  static constexpr int kB = 2 * OA::kTerms * SUB;  // B's offset in a stage
  static constexpr int kStage = kB + 2 * OB::kTerms * SUB;
  static constexpr int kBytes = 2 * kStage + 1024;  // + alignment slack
};

// The products of one k tile (stage st) for warpgroup g into d, added to
// it, or overwriting it with `fresh`.
template <class OA, class OB>
__device__ __forceinline__ void tile_products(float (&d)[2][32], uint32_t st,
                                              int g, bool fresh) {
  using namespace repro::tc;
  constexpr int TA = OA::kMN, TB = OB::kMN;
  const uint32_t sb = st + Layout<OA, OB>::kB;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t a_hi = OA::desc(st, 0, g, kk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t b_hi = OB::desc(sb, 0, h, kk);
      mma_ss_n64<TB, TA>(d[h], a_hi, b_hi, !(fresh && kk == 0));  // hi hi
      if constexpr (OB::kTerms == 2)                               // hi mid
        mma_ss_n64<TB, TA>(d[h], a_hi, OB::desc(sb, 1, h, kk), 1);
      if constexpr (OA::kTerms == 2)                               // mid hi
        mma_ss_n64<TB, TA>(d[h], OA::desc(st, 1, g, kk), b_hi, 1);
    }
  }
}

// acc[h] (this warpgroup's rows m0 + 64 g .. + 63, columns n0 + 64 h ..
// + 63) = sum over k < K of A(m, k) B(k, n), from the split terms. smem: the
// block's dynamic shared memory, 1024-byte aligned, Layout<OA, OB>::kBytes.
// It returns with every thread past its last read of smem, so a block may
// call it again for its next tile.
//
// PROMOTE: each k tile's products go to a fresh accumulator, added to acc
// by an f32 add after the tile. The tensor cores' f32 sums truncate, so one
// accumulator carried through thousands of k steps drifts with their
// number: dh = dl w^T over V = 128256 (8016 steps of 16, three passes)
// missed the loss backward's 1e-4 of its largest element without it.
template <class OA, class OB, bool PROMOTE>
__device__ __forceinline__ void gemm_tile(const View<typename OA::Elem>& A,
                                          const View<typename OB::Elem>& B,
                                          int m0, int n0, int K,
                                          uint32_t smem, float (&acc)[2][32]) {
  using namespace repro::tc;
  using L = Layout<OA, OB>;
  const int g = threadIdx.x / 128;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float part[2][32];  // used only with PROMOTE

  OA sa;
  OB sb;
  sa.load(A, m0, 0, smem);
  sb.load(B, n0, 0, smem + L::kB);
  cp_async_commit();
  sa.store(smem);
  sb.store(smem + L::kB);
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t st = smem + (kt & 1) * L::kStage;
    const uint32_t nx = smem + ((kt + 1) & 1) * L::kStage;
    const bool more = kt + 1 < nk;
    // the next tile's loads fly while this one multiplies; the other stage
    // was released at the end of tile kt - 1
    if (more) {
      sa.load(A, m0, (kt + 1) * BK, nx);
      sb.load(B, n0, (kt + 1) * BK, nx + L::kB);
      cp_async_commit();
    }
    auto multiply = [&](float (&d)[2][32]) {
      fence_regs(d[0]);
      fence_regs(d[1]);
      mma_fence();
      tile_products<OA, OB>(d, st, g, PROMOTE);
      mma_commit();
      fence_regs(d[0]);
      fence_regs(d[1]);
      if (more) {
        sa.store(nx);
        sb.store(nx + L::kB);
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
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
  }
}

}  // namespace sg
}  // namespace repro
