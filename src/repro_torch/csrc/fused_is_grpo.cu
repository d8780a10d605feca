// Fused IS+GRPO loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fused_is_grpo/fused_is_grpo.py::fused_is_grpo_fwd_rows
//   (body `_fwd_kernel`) and ::fused_is_grpo_bwd_rows (`_bwd_dh_kernel`,
//   `_bwd_dw_kernel`), wrapper `ops.fused_is_grpo`.
// Plain reference: repro_torch.hopper.fused_is_grpo.stats_plain / bwd_plain
// (ports of `_stats_blocked` / `_bwd_blocked`).
//
// Inputs: hidden h (R, d) float32 or bfloat16, row-major; the unembedding
// w as the logical (d, V) matrix given by two strides, so the tied
// embedding is read in its own (V, d) layout (w_stride_k 1, w_stride_v d)
// and an untied lm_head in (d, V) (w_stride_k V, w_stride_v 1) — no
// transposed copy of a 1 GB float32 matrix per step. w is float32 (the
// master weights), and every product keeps float32 accuracy, as the Pallas
// kernel's (h widened to float32, w float32).
//
// Also replaces the forward-only Pallas TPU kernel
//   src/repro/kernels/fused_logprob/fused_logprob.py::fused_logprob_rows
//   (body `_kernel`): the entry point fused_logprob_fwd below, plain
//   reference repro_torch.hopper.fused_logprob.fused_logprob_plain.
//
// Entry points:
//   fused_is_grpo_fwd     per row: loss_tok, ratio, logp, lse, entropy.
//     Kernel 1, one block per (128-row tile, vocabulary split), loops over
//     its split's 128x128 logits tiles (the TPU kernel's sequential vocab
//     grid axis) and folds each into a running (max, sumexp, target logit,
//     logit-weighted sumexp) per row. bfloat16 h (the main path):
//     fwd_partial_tc, each tile h w_hi + h w_mid on the tensor cores
//     through logits_tile, the same function bwd_dl_tc recomputes the
//     logits with, so the backward's p = exp(logit - L) sees the logits of
//     the L the forward saved; the statistics are folded in registers in
//     the wgmma fragment layout. float32 h: fwd_partial_kernel on the f32
//     FMA pipes (SIMT GEMM, 8x8 outputs per thread, 8-deep k tiles).
//     Kernel 2, one thread per row: merges the splits' partials, then
//     logp = g - lse, E[logit] = u / l, entropy = lse - E[logit], and the
//     per-token objective of core/grpo.per_token_objective.
//   fused_is_grpo_bwd_dh_tc  (bfloat16 h, the main path) two tensor-core
//     kernels on split_gemm.cuh's core: bwd_dl_tc recomputes each 128x128
//     logits tile (logits_tile) and applies the dl epilogue to the
//     accumulator in registers,
//     dl = a (onehot - p) - e p (logit - E[logit]) (times the softcap chain
//     1 - (logit/cap)^2), written float32 to the (rows, V) scratch that
//     bwd_dw reads; bwd_dh_tc computes dh = dl w^T as dl_hi w_hi + dl_hi
//     w_mid + dl_mid w_hi. The epilogue stays apart from dh: dh's rows are
//     d = 2048 wide, too wide for a row tile's accumulator in registers, and
//     bwd_dw needs dl anyway. Error model: split_gemm.cuh.
//   fused_is_grpo_bwd_dh  (float32 h) the same two steps on the f32 FMA
//     pipes: the logits recompute and dl, then dh = dl w^T (tiled SIMT GEMM,
//     float32 accumulation).
//   fused_is_grpo_bwd_dw  dw = h^T dl for the same chunk, written in w's
//     own layout (the tied embedding's gradient comes back as (V, d)),
//     accumulated over row chunks. bfloat16 h: bwd_dw_tc on the tensor
//     cores, dl_hi^T h + dl_mid^T h (h exact), each 64-deep k tile promoted
//     into f32 sums (K = R = 4064 rows, 254 k steps a pass); both operands
//     are read along m or n (the transpose bits), and the orientation is
//     chosen so that the stores are row-major: C (V x d) = dl^T h for the
//     tied (V, d) gradient, C (d x V) = h^T dl for an untied (d, V) one.
//     float32 h: the SIMT GEMM.
//   fused_logprob_fwd     per row: logp = log p(target) and lse, for the
//     legacy fused_loss=False loss. The IS-GRPO forward without its
//     epilogue: the same kernel 1 (its logit-weighted sumexp goes unused),
//     then a combine kernel that writes logp and lse only. Its gradient is
//     dl = g (onehot - p): the bwd_dh and bwd_dw entry points with a = g,
//     e = 0, and no third GEMM.
// So the backward does one logits recompute + dh + dw = 6 R d V operations
// where the TPU kernels recompute the logits in each of their two kernels.
// A row with a = e = 0 (prompt and padding positions) has dl = 0 exactly
// and adds exactly zero to dh and dw.
//
// What bounds it on the H100: 2 R d V operations per product against
// O(V d + R d) bytes (plus the R V dl scratch) — far above the card's
// operations per byte, so arithmetic. On the tensor cores (989 TFLOP/s
// dense bf16) the forward and dw take 2 bf16 passes of 2 R d V (4.317 ms at
// R 4064, d 2048, V 128256), bwd_dh 5; on the 67 TFLOP/s f32 FMA pipes one
// pass of the same product bounds the f32-h kernels (31.87 ms). The
// tensor-core kernels stage each k tile into a double buffer
// (split_gemm.cuh: h by cp.async, f32 operands split in registers): no
// TMA, producer warp or persistent schedule yet, so the epilogues, the
// splits and each tile's first loads do not overlap the products.
#include "common.cuh"
#include "split_gemm.cuh"

namespace {

using repro::kNegInf;

constexpr int BM = 128;      // rows of an output tile
constexpr int BN = 128;      // columns of an output tile
constexpr int BK = 8;        // depth of a shared-memory k tile
constexpr int TM = 8;        // outputs per thread, rows
constexpr int TN = 8;        // outputs per thread, columns
constexpr int NT = 256;      // threads per block: (BM/TM) x (BN/TN)

// Strided operand: element (i, j) at p[i * si + j * sj].
template <typename T>
struct Mat {
  const T* p;
  long long si, sj;
  __device__ __forceinline__ float at(long long i, long long j) const {
    return repro::to_f(p[i * si + j * sj]);
  }
};

// acc[i][j] = sum_k A(m0 + ty*TM + i, k) * B(k, n0 + tx*TN + j) over k in
// [0, K); A is M x K, B is K x N, out-of-range elements read as 0.
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(const Mat<TA> A, const Mat<TB> B,
                                          int M, int N, int K, int m0,
                                          int n0, float (*As)[BM],
                                          float (*Bs)[BN],
                                          float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // consecutive threads walk the operand's contiguous dimension
  const bool a_k_contig = A.sj == 1;
  const bool b_n_contig = B.sj == 1;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int mi = a_k_contig ? e / BK : e % BM;
      const int ki = a_k_contig ? e % BK : e / BM;
      const int m = m0 + mi, k = k0 + ki;
      As[ki][mi] = (m < M && k < K) ? A.at(m, k) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += NT) {
      const int ni = b_n_contig ? e % BN : e / BK;
      const int ki = b_n_contig ? e / BN : e % BK;
      const int n = n0 + ni, k = k0 + ki;
      Bs[ki][ni] = (n < N && k < K) ? B.at(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ float capped(float x, float softcap) {
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

// dl of one logit from its raw product: a (onehot - p) - e p (x - ebar),
// times the softcap chain 1 - (x / cap)^2
__device__ __forceinline__ float dlogit(float raw, bool hit, float L,
                                        float eb, float a, float e,
                                        float softcap) {
  const float x = capped(raw, softcap);
  const float p = expf(x - L);
  float v = a * ((hit ? 1.f : 0.f) - p) - e * p * (x - eb);
  if (softcap > 0.f) {
    const float c = x / softcap;
    v *= 1.f - c * c;
  }
  return v;
}

// The 16 threads sharing a row of the output tile are 16 consecutive lanes
// (one half-warp), so xor shuffles of 8, 4, 2, 1 reduce over them.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- forward ------------------------------------------------------------

__global__ void __launch_bounds__(NT)
fwd_partial_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   long long w_sk, long long w_sv,
                   const int* __restrict__ targets,
                   float4* __restrict__ partial, int R, int d, int V,
                   int tiles_per_split, float softcap) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  const int n_begin = split * tiles_per_split * BN;
  const int n_end = min(V, n_begin + tiles_per_split * BN);
  const Mat<float> A{h, d, 1};
  const Mat<float> B{w, w_sk, w_sv};

  float rm[TM], rl[TM], rg[TM], ru[TM];
  int tgt[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    rm[i] = kNegInf;
    rl[i] = rg[i] = ru[i] = 0.f;
    tgt[i] = row < R ? targets[row] : -1;
  }
  float acc[TM][TN];
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    gemm_tile(A, B, R, V, d, m0, n0, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float x[TN];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx * TN + j;
        x[j] = capped(acc[i][j], softcap);
        if (col < n_end) tmax = fmaxf(tmax, x[j]);
      }
      tmax = half_warp_max(tmax);
      const float m_new = fmaxf(rm[i], tmax);
      float ps = 0.f, pu = 0.f, pg = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx * TN + j;
        if (col < n_end) {
          const float p = expf(x[j] - m_new);
          ps += p;
          pu = fmaf(p, x[j], pu);
          if (col == tgt[i]) pg += x[j];
        }
      }
      ps = half_warp_sum(ps);
      pu = half_warp_sum(pu);
      pg = half_warp_sum(pg);
      const float corr = expf(rm[i] - m_new);
      rl[i] = rl[i] * corr + ps;
      ru[i] = ru[i] * corr + pu;
      rg[i] += pg;
      rm[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row < R)
        partial[(size_t)split * R + row] = make_float4(rm[i], rl[i], rg[i], ru[i]);
    }
  }
}

// Merges the splits' (max, sumexp, target logit, logit-weighted sumexp)
// of row r into (m, l, g, u) over the whole vocabulary.
__device__ __forceinline__ float4 merge_splits(const float4* __restrict__ partial,
                                               int splits, int R, int r) {
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, partial[(size_t)s * R + r].x);
  float l = 0.f, g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4 p = partial[(size_t)s * R + r];
    const float c = expf(p.x - m);
    l = fmaf(p.y, c, l);
    u = fmaf(p.w, c, u);
    g += p.z;
  }
  return make_float4(m, l, g, u);
}

__global__ void fwd_combine_kernel(const float4* __restrict__ partial,
                                   int splits, int R,
                                   const float* __restrict__ behaviour,
                                   const float* __restrict__ adv,
                                   float* __restrict__ loss,
                                   float* __restrict__ ratio,
                                   float* __restrict__ logp,
                                   float* __restrict__ lse,
                                   float* __restrict__ ent, float ratio_lo,
                                   float ratio_hi, int use_is, float log_cap,
                                   float entropy_coef) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float4 t = merge_splits(partial, splits, R, r);
  const float m = t.x, l = t.y, g = t.z, u = t.w;
  const float L = m + logf(l);
  const float lp = g - L;
  const float en = L - u / l;
  // core/grpo.per_token_objective, elementwise
  float lr = 0.f;
  if (use_is) lr = fminf(fmaxf(lp - behaviour[r], -log_cap), log_cap);
  const float rt = expf(lr);
  const float a = adv[r];
  const float obj = fminf(rt * a, fminf(fmaxf(rt, ratio_lo), ratio_hi) * a);
  float lt = -obj;
  if (entropy_coef > 0.f) lt -= entropy_coef * en;
  loss[r] = lt;
  ratio[r] = rt;
  logp[r] = lp;
  lse[r] = L;
  ent[r] = en;
}

__global__ void logprob_combine_kernel(const float4* __restrict__ partial,
                                       int splits, int R,
                                       float* __restrict__ logp,
                                       float* __restrict__ lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float4 t = merge_splits(partial, splits, R, r);
  const float L = t.x + logf(t.y);
  logp[r] = t.z - L;
  lse[r] = L;
}

// ---- tensor-core kernels (bfloat16 h) -------------------------------------

namespace sg = repro::sg;

// this thread's accumulator rows and columns (wgmma m64n64 f32 layout):
// register i of half h is row row0 + 8 ((i / 2) % 2), column col0 + 64 h +
// 8 (i / 4) + i % 2
struct Frag {
  int row0, col0;
  __device__ Frag(int m0, int n0) {
    const int g = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    row0 = m0 + 64 * g + 16 * warp + lane / 4;
    col0 = n0 + 2 * (lane % 4);
  }
};

__device__ __forceinline__ uint32_t dyn_smem() {
  extern __shared__ uint8_t smem_raw[];
  return (repro::tc::smem_addr(smem_raw) + 1023) & ~1023u;
}

template <bool K>
using HOp = sg::Operand<__nv_bfloat16, K>;  // bf16 h, exact
template <bool K>
using FOp = sg::Operand<float, K>;          // f32 w or dl, two bf16 terms

// One 128 x 128 tile of raw logits h w (before the softcap) from h and w's
// two bf16 terms, 2 passes (B_KMAJOR: w's rows are the vocabulary, the
// tied (V, d) embedding). The forward and the backward both take their
// logits from here, with the same order of products and sums.
template <bool B_KMAJOR>
__device__ __forceinline__ void logits_tile(const sg::View<__nv_bfloat16>& H,
                                            const sg::View<float>& W, int m0,
                                            int n0, float (&acc)[2][32]) {
  sg::gemm_tile<HOp<true>, FOp<B_KMAJOR>, false>(H, W, m0, n0, H.cols,
                                                 dyn_smem(), acc);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Kernel 1 of both forwards on the tensor cores. A thread holds 2 rows x
// 32 columns of each logits tile (Frag) and keeps its own running (max,
// sumexp, target logit, logit-weighted sumexp) over its columns, in
// registers; the 4 lanes of a quad hold a row's 128 columns and merge
// theirs once, after the split's last tile. Two blocks per SM, as
// bwd_dl_tc, whose main loop this is: at 128 registers, with some bytes
// spilled, the train-shape forward ran faster on an H100 than at one block
// per SM without spills.
template <bool B_KMAJOR>
__global__ void __launch_bounds__(sg::NT, 2)
fwd_partial_tc(const sg::View<__nv_bfloat16> H, const sg::View<float> W,
               const int* __restrict__ targets, float4* __restrict__ partial,
               int R, int V, int tiles_per_split, float softcap) {
  const int m0 = blockIdx.x * sg::BM, split = blockIdx.y;
  const int n_begin = split * tiles_per_split * sg::BN;
  const int n_end = min(V, n_begin + tiles_per_split * sg::BN);
  const Frag f(m0, 0);
  float rm[2], rl[2], rg[2], ru[2];
  int tgt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = f.row0 + 8 * r;
    rm[r] = kNegInf;
    rl[r] = rg[r] = ru[r] = 0.f;
    tgt[r] = row < R ? targets[row] : -1;
  }
  float acc[2][32];
  for (int n0 = n_begin; n0 < n_end; n0 += sg::BN) {
    logits_tile<B_KMAJOR>(H, W, m0, n0, acc);
    // register 4 j + 2 r + e of half h: row r, column c0 + 64 h + 8 j + e
    const int c0 = n0 + f.col0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = kNegInf;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = acc[h][4 * j + 2 * r + e];
            x = capped(x, softcap);
            if (c0 + 64 * h + 8 * j + e < n_end) tmax = fmaxf(tmax, x);
          }
      const float m_new = fmaxf(rm[r], tmax);
      float ps = 0.f, pu = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 64 * h + 8 * j + e;
            const float x = acc[h][4 * j + 2 * r + e];
            if (col < n_end) {
              const float p = expf(x - m_new);
              ps += p;
              pu = fmaf(p, x, pu);
              if (col == tgt[r]) rg[r] += x;
            }
          }
      const float corr = expf(rm[r] - m_new);
      rl[r] = rl[r] * corr + ps;
      ru[r] = ru[r] * corr + pu;
      rm[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(rm[r], __shfl_xor_sync(0xffffffffu, rm[r], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float c = expf(rm[r] - m);
    const float l = quad_sum(rl[r] * c), u = quad_sum(ru[r] * c);
    const float g = quad_sum(rg[r]);
    const int row = f.row0 + 8 * r;
    if (threadIdx.x % 4 == 0 && row < R)
      partial[(size_t)split * R + row] = make_float4(m, l, g, u);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// 16-byte loads of a row-major f32 matrix: stride, row length and pointer
// all multiples of 4 elements
inline int vec4(const void* p, long long stride, int cols) {
  return stride % 4 == 0 && cols % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// w as the matrix the tensor-core kernels read: the tied (V, d) embedding
// (w_sk 1: rows are the vocabulary, K-major for the logits) or an untied
// (d, V) lm_head (w_sv 1: rows are d)
inline sg::View<float> w_view(const float* w, int w_sk, int w_sv, int d,
                              int V) {
  return w_sk == 1 ? sg::View<float>{w, w_sv, V, d, vec4(w, w_sv, d)}
                   : sg::View<float>{w, w_sk, d, V, vec4(w, w_sk, V)};
}

template <bool TIED>
cudaError_t launch_fwd_tc(const sg::View<__nv_bfloat16> H,
                          const sg::View<float> W, const int* targets,
                          float4* partial, int R, int V, dim3 grid,
                          int per_split, float softcap, cudaStream_t s) {
  constexpr int bytes = sg::Layout<HOp<true>, FOp<TIED>>::kBytes;
  static const cudaError_t attr = allow_smem(fwd_partial_tc<TIED>, bytes);
  if (attr != cudaSuccess) return attr;
  fwd_partial_tc<TIED><<<grid, sg::NT, bytes, s>>>(H, W, targets, partial, R,
                                                   V, per_split, softcap);
  return cudaSuccess;
}

// Kernel 1 of both forwards: the splits' partial statistics. bfloat16 h
// takes the tensor cores (d a multiple of 8, w in one of its two layouts),
// float32 h the f32 FMA pipes.
cudaError_t launch_partial(const void* h, const void* w, const void* targets,
                           void* partial, int R, int d, int V, int w_sk,
                           int w_sv, int h_dtype, int splits, float softcap,
                           cudaStream_t s) {
  const int n_tiles = (V + BN - 1) / BN;
  if (splits < 1 || splits > n_tiles) return cudaErrorInvalidValue;
  const int per_split = (n_tiles + splits - 1) / splits;
  const int used = (n_tiles + per_split - 1) / per_split;  // every split non-empty
  if (used != splits) return cudaErrorInvalidValue;
  dim3 grid((R + BM - 1) / BM, splits);
  const float* wf = static_cast<const float*>(w);
  const int* t = static_cast<const int*>(targets);
  float4* part = static_cast<float4*>(partial);
  if (h_dtype == repro::kBFloat16) {
    if (d % 8 != 0 || (w_sk != 1 && w_sv != 1)) return cudaErrorInvalidValue;
    const sg::View<__nv_bfloat16> H{static_cast<const __nv_bfloat16*>(h), d,
                                    R, d, 1};
    const sg::View<float> W = w_view(wf, w_sk, w_sv, d, V);
    return w_sk == 1 ? launch_fwd_tc<true>(H, W, t, part, R, V, grid,
                                           per_split, softcap, s)
                     : launch_fwd_tc<false>(H, W, t, part, R, V, grid,
                                            per_split, softcap, s);
  }
  if (h_dtype != repro::kFloat32) return cudaErrorInvalidValue;
  fwd_partial_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(h), wf, w_sk, w_sv, t, part, R, d, V,
      per_split, softcap);
  return cudaSuccess;
}

// ---- backward -----------------------------------------------------------

template <typename TH>
__global__ void __launch_bounds__(NT)
bwd_dl_kernel(const TH* __restrict__ h, const float* __restrict__ w,
              long long w_sk, long long w_sv, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ ebar,
              const float* __restrict__ ca, const float* __restrict__ ce,
              float* __restrict__ dl, int R, int d, int V, float softcap) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  float acc[TM][TN];
  gemm_tile(Mat<TH>{h, d, 1}, Mat<float>{w, w_sk, w_sv}, R, V, d, m0, n0,
            As, Bs, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= R) continue;
    const float L = lse[row], eb = ebar[row], a = ca[row], e = ce[row];
    const int t = targets[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= V) continue;
      dl[(size_t)row * V + col] =
          dlogit(acc[i][j], col == t, L, eb, a, e, softcap);
    }
  }
}

// C (M x N) = A (M x K) B (K x N), or C += A B with accumulate; C(i, j) at
// c[i * c_si + j * c_sj]; float32 (the f32-h dh and dw).
__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ a, long long a_si, long long a_sj,
            const float* __restrict__ b, long long b_si, long long b_sj,
            float* __restrict__ c, long long c_si, long long c_sj, int M,
            int N, int K, int accumulate) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ty = threadIdx.x / (BN / TN), tx = threadIdx.x % (BN / TN);
  float acc[TM][TN];
  gemm_tile(Mat<float>{a, a_si, a_sj}, Mat<float>{b, b_si, b_sj}, M, N, K, m0,
            n0, As, Bs, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float* cp = c + m * c_si + n * c_sj;
      *cp = accumulate ? *cp + acc[i][j] : acc[i][j];
    }
  }
}

inline dim3 tiles(int M, int N) {
  return dim3((M + BM - 1) / BM, (N + BN - 1) / BN);
}

// logits tile (logits_tile), then dl in registers, written to dl (R, V).
// Two blocks per SM (128 registers, a few spilled) hide each other's loads:
// the whole bwd_dh ran ~7% faster than with one block of ~170 registers.
template <bool B_KMAJOR>
__global__ void __launch_bounds__(sg::NT, 2)
bwd_dl_tc(const sg::View<__nv_bfloat16> H, const sg::View<float> W,
          const int* __restrict__ targets, const float* __restrict__ lse,
          const float* __restrict__ ebar, const float* __restrict__ ca,
          const float* __restrict__ ce, float* __restrict__ dl, int R, int V,
          float softcap) {
  const int m0 = blockIdx.x * sg::BM, n0 = blockIdx.y * sg::BN;
  float acc[2][32];
  logits_tile<B_KMAJOR>(H, W, m0, n0, acc);
  const Frag f(m0, n0);
  const bool pairs = V % 2 == 0;  // two columns in one 8-byte store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = f.row0 + 8 * r;
    if (row >= R) continue;
    const float L = lse[row], eb = ebar[row], a = ca[row], e = ce[row];
    const int t = targets[row];
    float* out = dl + (size_t)row * V;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        const int col = f.col0 + 64 * h + 8 * j;
        if (col >= V) continue;
        const float v0 = dlogit(acc[h][i], col == t, L, eb, a, e, softcap);
        const float v1 = dlogit(acc[h][i + 1], col + 1 == t, L, eb, a, e,
                                softcap);
        if (pairs) {
          *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
        } else {
          out[col] = v0;
          if (col + 1 < V) out[col + 1] = v1;
        }
      }
  }
}

// dh tile = dl w^T (B_KMAJOR: w's rows are d, the untied (d, V) lm_head)
template <bool B_KMAJOR>
__global__ void __launch_bounds__(sg::NT, 1)
bwd_dh_tc(const sg::View<float> DL, const sg::View<float> W,
          float* __restrict__ dh, int R, int d) {
  const int m0 = blockIdx.x * sg::BM, n0 = blockIdx.y * sg::BN;
  float acc[2][32];
  sg::gemm_tile<FOp<true>, FOp<B_KMAJOR>, true>(DL, W, m0, n0, DL.cols,
                                                dyn_smem(), acc);
  const Frag f(m0, n0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = f.row0 + 8 * r;
    if (row >= R) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        const int col = f.col0 + 64 * h + 8 * j;
        if (col < d)  // d is a multiple of 8
          *reinterpret_cast<float2*>(dh + (size_t)row * d + col) =
              make_float2(acc[h][i], acc[h][i + 1]);
      }
  }
}

// dw = h^T dl on the tensor cores, row-major C tiles of the gradient in w's
// layout: TIED, C (V x d) = dl^T h, the (V, d) embedding's rows (A = dl^T
// read along the vocabulary, B = h along d: both MN-major); untied, C (d x
// V) = h^T dl, the (d, V) lm_head's rows (A = h^T, B = dl, both MN-major).
// dl enters as two bf16 terms, h as it is: 2 passes over K = R rows, each
// 64-deep k tile's products promoted into f32 sums. blockIdx.x walks the
// d tiles, so the blocks that read one 128-column slice of dl run together
// and dl (R x V f32, 2 GB on the main path) comes from device memory about
// once while h stays in L2. One block per SM: the promotion's second
// accumulator takes the registers of a second block.
template <bool TIED>
__global__ void __launch_bounds__(sg::NT, 1)
bwd_dw_tc(const sg::View<__nv_bfloat16> H, const sg::View<float> DL,
          float* __restrict__ dw, int d, int V, int accumulate) {
  const int j0 = blockIdx.x * sg::BN, v0 = blockIdx.y * sg::BM;
  const int m0 = TIED ? v0 : j0, n0 = TIED ? j0 : v0;
  const int M = TIED ? V : d, N = TIED ? d : V;
  float acc[2][32];
  if constexpr (TIED)
    sg::gemm_tile<FOp<false>, HOp<false>, true>(DL, H, m0, n0, H.rows,
                                                dyn_smem(), acc);
  else
    sg::gemm_tile<HOp<false>, FOp<false>, true>(H, DL, m0, n0, H.rows,
                                                dyn_smem(), acc);
  const Frag f(m0, n0);
  // two columns in one 8-byte access
  const bool pairs = N % 2 == 0 && reinterpret_cast<uintptr_t>(dw) % 8 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = f.row0 + 8 * r;
    if (row >= M) continue;
    float* out = dw + (size_t)row * N;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        const int col = f.col0 + 64 * h + 8 * j;
        if (col >= N) continue;
        float x0 = acc[h][i], x1 = acc[h][i + 1];
        if (pairs) {
          float2* p = reinterpret_cast<float2*>(out + col);
          if (accumulate) {
            const float2 o = *p;
            x0 += o.x;
            x1 += o.y;
          }
          *p = make_float2(x0, x1);
        } else {
          out[col] = accumulate ? out[col] + x0 : x0;
          if (col + 1 < N) out[col + 1] = accumulate ? out[col + 1] + x1 : x1;
        }
      }
  }
}

template <bool TIED>
cudaError_t launch_dh_tc(const __nv_bfloat16* h, const sg::View<float> W,
                         const int* targets, const float* lse,
                         const float* ebar, const float* a, const float* e,
                         float* dl, float* dh, int R, int d, int V,
                         float softcap, cudaStream_t s) {
  constexpr int dl_bytes = sg::Layout<HOp<true>, FOp<TIED>>::kBytes;
  constexpr int dh_bytes = sg::Layout<FOp<true>, FOp<!TIED>>::kBytes;
  static const cudaError_t attr =
      allow_smem(bwd_dl_tc<TIED>, dl_bytes) != cudaSuccess
          ? cudaErrorInvalidValue
          : allow_smem(bwd_dh_tc<!TIED>, dh_bytes);
  if (attr != cudaSuccess) return attr;
  const sg::View<__nv_bfloat16> H{h, d, R, d, 1};
  // the logits read w with the vocabulary as n: K-major when tied
  bwd_dl_tc<TIED><<<tiles(R, V), sg::NT, dl_bytes, s>>>(
      H, W, targets, lse, ebar, a, e, dl, R, V, softcap);
  const sg::View<float> DL{dl, V, R, V, vec4(dl, V, V)};
  // dh reads w with d as n: MN-major when tied
  bwd_dh_tc<!TIED><<<tiles(R, d), sg::NT, dh_bytes, s>>>(DL, W, dh, R, d);
  return cudaSuccess;
}

template <bool TIED>
cudaError_t launch_dw_tc(const sg::View<__nv_bfloat16> H,
                         const sg::View<float> DL, float* dw, int d, int V,
                         int accumulate, cudaStream_t s) {
  // either orientation: three subtile pairs a stage (dl's two terms, h)
  constexpr int bytes = sg::Layout<FOp<false>, HOp<false>>::kBytes;
  static const cudaError_t attr = allow_smem(bwd_dw_tc<TIED>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((d + sg::BN - 1) / sg::BN, (V + sg::BM - 1) / sg::BM);
  bwd_dw_tc<TIED><<<grid, sg::NT, bytes, s>>>(H, DL, dw, d, V, accumulate);
  return cudaSuccess;
}

}  // namespace

extern "C" int fused_is_grpo_fwd(
    const void* h, const void* w, const void* targets, const void* behaviour,
    const void* adv, void* partial, void* loss, void* ratio, void* logp,
    void* lse, void* ent, int R, int d, int V, int w_sk, int w_sv,
    int h_dtype, int splits, float softcap, float ratio_lo, float ratio_hi,
    int use_is, float log_cap, float entropy_coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_partial(h, w, targets, partial, R, d, V,
                                         w_sk, w_sv, h_dtype, splits,
                                         softcap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(
      static_cast<const float4*>(partial), splits, R, static_cast<const float*>(behaviour),
      static_cast<const float*>(adv), static_cast<float*>(loss),
      static_cast<float*>(ratio), static_cast<float*>(logp),
      static_cast<float*>(lse), static_cast<float*>(ent), ratio_lo, ratio_hi,
      use_is, log_cap, entropy_coef);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_is_grpo_bwd_dh(const void* h, const void* w,
                                    const void* targets, const void* lse,
                                    const void* ebar, const void* a,
                                    const void* e, void* dl, void* dh, int R,
                                    int d, int V, int w_sk, int w_sv,
                                    int h_dtype, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* dlf = static_cast<float*>(dl);
#define REPRO_DL(TH)                                                         \
  bwd_dl_kernel<TH><<<tiles(R, V), NT, 0, s>>>(                              \
      static_cast<const TH*>(h), wf, w_sk, w_sv,                             \
      static_cast<const int*>(targets), static_cast<const float*>(lse),      \
      static_cast<const float*>(ebar), static_cast<const float*>(a),         \
      static_cast<const float*>(e), dlf, R, d, V, softcap)
  if (h_dtype == repro::kBFloat16)
    REPRO_DL(__nv_bfloat16);
  else if (h_dtype == repro::kFloat32)
    REPRO_DL(float);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_DL
  // dh (R x d) = dl (R x V) w^T: B(k=v, n=j) = w(j, v)
  gemm_kernel<<<tiles(R, d), NT, 0, s>>>(
      dlf, V, 1, wf, w_sv, w_sk, static_cast<float*>(dh), d, 1, R, d, V, 0);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16-h backward on the tensor cores (two launches): writes dl
// (R, V) and dh (R, d), both float32. d must be a multiple of 8.
extern "C" int fused_is_grpo_bwd_dh_tc(const void* h, const void* w,
                                       const void* targets, const void* lse,
                                       const void* ebar, const void* a,
                                       const void* e, void* dl, void* dh,
                                       int R, int d, int V, int w_sk,
                                       int w_sv, float softcap,
                                       void* stream) {
  if (d % 8 != 0 || (w_sk != 1 && w_sv != 1) || R < 1 || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const bool tied = w_sk == 1;  // the (V, d) embedding: row v at v * w_sv
  const sg::View<float> W = w_view(wf, w_sk, w_sv, d, V);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  const auto* t = static_cast<const int*>(targets);
  const auto *L = static_cast<const float*>(lse),
             *eb = static_cast<const float*>(ebar),
             *ca = static_cast<const float*>(a),
             *ce = static_cast<const float*>(e);
  float *dlf = static_cast<float*>(dl), *dhf = static_cast<float*>(dh);
  const cudaError_t err =
      tied ? launch_dh_tc<true>(hb, W, t, L, eb, ca, ce, dlf, dhf, R, d, V,
                                softcap, s)
           : launch_dh_tc<false>(hb, W, t, L, eb, ca, ce, dlf, dhf, R, d, V,
                                 softcap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_is_grpo_bwd_dw(const void* h, const void* dl, void* dw,
                                    int R, int d, int V, int dw_sk,
                                    int dw_sv, int h_dtype, int accumulate,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dlf = static_cast<const float*>(dl);
  float* out = static_cast<float*>(dw);
  if (h_dtype == repro::kBFloat16) {
    // dw in w's layout: (V, d) when dw_sk is 1, else (d, V)
    if (d % 8 != 0 || (dw_sk != 1 && dw_sv != 1) || R < 1 || V < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const sg::View<__nv_bfloat16> H{static_cast<const __nv_bfloat16*>(h), d,
                                    R, d, 1};
    const sg::View<float> DL{dlf, V, R, V, vec4(dlf, V, V)};
    const cudaError_t err =
        dw_sk == 1 ? launch_dw_tc<true>(H, DL, out, d, V, accumulate, s)
                   : launch_dw_tc<false>(H, DL, out, d, V, accumulate, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (h_dtype == repro::kFloat32) {
    // dw^T (V x d) = dl^T (V x R) h (R x d): A(v, r) = dl(r, v),
    // B(r, j) = h(r, j), C(v, j) = dw(j, v)
    gemm_kernel<<<tiles(V, d), NT, 0, s>>>(
        dlf, 1, V, static_cast<const float*>(h), d, 1, out, dw_sv, dw_sk, V,
        d, R, accumulate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_logprob_fwd(const void* h, const void* w,
                                 const void* targets, void* partial,
                                 void* logp, void* lse, int R, int d, int V,
                                 int w_sk, int w_sv, int h_dtype, int splits,
                                 float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_partial(h, w, targets, partial, R, d, V,
                                         w_sk, w_sv, h_dtype, splits,
                                         softcap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  logprob_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(
      static_cast<const float4*>(partial), splits, R,
      static_cast<float*>(logp), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
