// Attention backward for Hopper (sm_90a).
//
// Replaces the reference's flash backward
//   src/repro/models/attention.py::_flash_bwd
// (the custom VJP of chunked_attention; the Pallas flash_attn family has no
// backward kernel). Plain reference:
// repro_torch.models.attention.flash_attention_bwd_plain.
//
// Inputs: q, out, dout (B, Sq, H, hd); k, v (B, Sk, KV, hd) in the model's
// layout, in float32 or bfloat16; lse float32 (B, H, Sq), written by the
// forward (flash_attn.cu). Outputs dq in q's layout and dtype, dk/dv in k's.
// Supports the forward's flags: causal, sliding window, score softcap.
// Query head h reads KV head h / (H / KV); dk/dv of a KV head sum over its
// H / KV query heads inside one block, so no atomics and no repeated heads.
//
// What bounds it on the H100: bytes. At the train shape (q (32, 127, 32,
// 64), k/v over 8 heads) it does the five products QK^T, dO V^T, dS K,
// P^T dO, dS^T Q, 10 * B * H * hd * S^2 / 2 operations (5.3 GFLOP at the
// train shape: 0.0053 ms at 989 TFLOP/s in bf16), against the bytes of q,
// out, dout, k, v, lse read and dq, dk, dv written (84 MB: 0.025 ms at
// 3.35 TB/s).
//
// Three kernels, as in _flash_bwd, with no atomics, so the gradients are the
// same bits from run to run:
//   1. delta_kernel: D = rowsum(dout * out), float32 (B, H, Sq);
//   2. dq pass, q-major; 3. dk/dv pass, kv-major: dk/dv of a KV head sum
//      over its H / KV query heads inside one block.
//
// bfloat16: tensor cores (wgmma, sm_90a; building blocks in wgmma.cuh),
// one warpgroup (128 threads) per block, 64 x 64 tiles.
//   dq pass (bwd_dq_tc): one block per (64-row q tile, head, batch row). Q
//   and dO tiles stay in swizzled shared memory; 64-key K and V tiles come
//   through a ring of two stages by cp.async with zero-fill (the next tile
//   in flight while this one computes). Per tile: S = Q K^T and dP = dO V^T
//   (wgmma m64n64k16, both operands from shared memory); on the fragments
//   P = exp(s - lse) with the softcap chain and the masks of partial tiles,
//   dS = P (dP - D); then dQ += dS K (wgmma m64n{hd}k16, dS from registers,
//   K read MN-major through the transpose bit).
//   dk/dv pass (bwd_dkv_tc): one block per (64-key tile, KV head, batch
//   row). K and V stay in shared memory; the q tiles of every query head of
//   the group (Q, dO, and their rows' lse and D) come through the two-stage
//   ring. Per q tile: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T on the
//   fragments; dV += P^T dO and dK += dS^T Q with dO and Q MN-major.
// The dk/dv pass holds two f32 accumulators and four fragment sets; it is
// capped at 168 registers (__launch_bounds__(128, 3): three blocks per SM,
// not two), and ptxas spills a few words at hd 64 (PERF.md).
// Head sizes 32, 64, 128 and 256, any H / KV, in column blocks that keep
// every hd's registers at hd 64's or below: a dq block accumulates DQC =
// min(hd, 128) columns of dQ (64 registers; dQ += dS K is m64n128k16 at hd
// 128 and 256, K read across two panels), a dk/dv block 64 columns of each
// (one panel of dO and Q). At hd 256 the grid runs 2 dq blocks per q tile
// and 4 dk/dv blocks per key tile (2 at hd 128), each computing S and dP
// over all of hd from full-width tiles (wgmma.cuh's 64-column panels):
// more products than one block holding all columns, which two f32
// accumulators of hd / 2 registers each could not fit. Each block still
// owns its gradient elements, so the bits stay the same from run to run.
// Shared memory: six tiles, 194 KB at hd 256.
// Rounding points: bf16 inputs, f32 products and sums; P and dS are passed
// to their products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi)
// (two wgmma each), so the products see them to ~2^-17 relative. Rounded
// once, as SDPA does, they put dv one bf16 ulp (0.0625 at |dv| in [8, 16))
// off the f32 plain version at the train shape, past atol 5e-2.
// Gradients are rounded to bf16 once, at the end.
//
// float32: the first version, kept for f32 callers (the GPU-against-CPU
// references need atol 1e-4, which TF32 wgmma would not meet): one thread
// per query row (dq pass) or key (dk/dv pass) on the f32 FMA pipes, with
// 32-key K/V tiles (dq; 16 at hd 256) or 16-row q/dout tiles (dk/dv)
// staged in shared memory and read as broadcasts; p = exp(s - L), ds = p
// (dp - D) (times the softcap chain 1 - tanh^2). The dk/dv pass's tiles
// are dynamic shared memory (41.6 KB at hd 64, 161 KB at 256); at hd 128
// and 256 the per-thread rows spill to local memory.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;   // dq pass: query rows per block (one per thread)
constexpr int BKV = 64;  // dk/dv pass: keys per block (one per thread)
constexpr int BQ2 = 16;  // dk/dv pass: query rows per shared-memory tile
// dq pass: keys per shared-memory tile, inside the 48 KB of static shared
// memory (32 KB at HD = 256 with 16 keys)
template <int HD>
__host__ __device__ constexpr int simt_keys() { return HD > 128 ? 16 : 32; }
// dk/dv pass: its dynamic shared memory (the block's padded K and V rows,
// the q and dout tiles, their lse and D): 41.6 KB at HD = 64, 161 KB at 256
template <int HD>
__host__ __device__ constexpr int simt_dkv_bytes() {
  return 4 * (2 * BKV * (HD + 1) + 2 * BQ2 * HD + 2 * BQ2);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

template <typename T, int HD>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int B, int Sq,
                             int H) {
  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (size_t)B * Sq * H) return;
  // rows enumerate (b, q, h) in the memory order of out
  const int h = (int)(row % H);
  const size_t bq = row / H;
  const int q = (int)(bq % Sq);
  const int b = (int)(bq / Sq);
  const T* op = o + row * HD;
  const T* dp = dout + row * HD;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(repro::to_f(op[d]), repro::to_f(dp[d]), s);
  delta[((size_t)b * H + h) * Sq + q] = s;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 64;      // rows of every operand tile
constexpr int THREADS = 128;  // one warpgroup

template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return TILE * HD * 2;
}
// Column blocks: a block accumulates dQ over DQC columns (up to 128: one
// accumulator of 64 registers a thread) and dK, dV over 64 columns each (two
// of 32), whatever HD is; at a wider HD the grid runs HD / DQC or HD / 64
// blocks per tile, each computing the tile's S and dP over all of hd.
template <int HD>
__host__ __device__ constexpr int dq_cols() { return HD > 128 ? 128 : HD; }
template <int HD>
__host__ __device__ constexpr int dkv_cols() { return HD > 64 ? 64 : HD; }
// six swizzled tiles (dq: Q, dO, K[2], V[2]; dk/dv: K, V, Q[2], dO[2]), the
// dk/dv pass's lse and D rows of two stages, and alignment slack
template <int HD>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 6 * tile_bytes<HD>() + 4 * TILE * 4 + 1024;
}

// scores of one fragment element -> (p, ds): p = exp(s - L) with the
// softcap chain, zero where masked, ds = p (dp - D)
struct Grad {
  float p, ds;
};
__device__ __forceinline__ Grad prob_grad(float s_acc, float dp, float L,
                                          float D, float scale, float softcap,
                                          bool ok) {
  using repro::tc::kLog2e;
  float x = s_acc * scale, chain = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = t * softcap;
    chain = 1.f - t * t;
  }
  const float p = ok ? exp2f((x - L) * kLog2e) : 0.f;
  return {p, p * (dp - D) * chain};
}

// d += a B for N = 32, 64 or 128 columns of an MN-major B
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128)
    repro::tc::mma_rs_n128(d, a, db);
  else if constexpr (N == 64)
    repro::tc::mma_rs_n64(d, a, db);
  else
    repro::tc::mma_rs_n32(d, a, db);
}

// d += (hi + lo) B over the four k-steps of a 64-deep product, B MN-major in
// a tile of HD columns, N of them read
template <int HD, int N>
__device__ __forceinline__ void mma_rs2(float (&d)[N / 2],
                                        const uint32_t (&hi)[4][4],
                                        const uint32_t (&lo)[4][4],
                                        uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_rs<N>(d, hi[kk], db + kk * repro::tc::kstep_mnmajor<HD>());
    mma_rs<N>(d, lo[kk], db + kk * repro::tc::kstep_mnmajor<HD>());
  }
}

// d = A B^T over hd, A and B K-major tiles in shared memory
template <int HD>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    repro::tc::mma_ss_n64(d, da + repro::tc::kmajor_off<HD>(kk),
                          db + repro::tc::kmajor_off<HD>(kk), kk > 0);
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KV,
          int causal, int window, float softcap, float scale) {
  using namespace repro::tc;
  constexpr int DQC = dq_cols<HD>();
  constexpr int NCB = HD / DQC;  // column blocks per q tile
  constexpr int NO = DQC / 2;
  constexpr int KT = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + KT, sK = base + 2 * KT,
                 sV = base + 4 * KT;

  // this block's q tile and dQ column block
  const int cb = NCB > 1 ? blockIdx.x % NCB : 0;
  const int q0 = (NCB > 1 ? blockIdx.x / NCB : blockIdx.x) * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);

  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + TILE);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / TILE) * TILE;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + TILE - 1) / TILE : 0;

  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const size_t qoff = (((size_t)b * Sq + q0) * H + h) * HD;
  const __nv_bfloat16* kbase = k + ((size_t)b * Sk * KV + g) * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * Sk * KV + g) * HD;
  load_tile<HD>(sQ, q + qoff, q_stride, Sq - q0);
  load_tile<HD>(sO, dout + qoff, q_stride, Sq - q0);
  if (ntiles > 0) {
    load_tile<HD>(sK, kbase + kv_lo * kv_stride, kv_stride, Sk - kv_lo);
    load_tile<HD>(sV, vbase + kv_lo * kv_stride, kv_stride, Sk - kv_lo);
  }
  cp_async_commit();

  float L[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = min(q0 + row0 + 8 * r, Sq - 1);
    L[r] = lse[((size_t)b * H + h) * Sq + qp];
    D[r] = delta[((size_t)b * H + h) * Sq + qp];
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const uint64_t dQ = make_desc<HD>(sQ), dO = make_desc<HD>(sO);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kv_lo + t * TILE;
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = k0 + TILE;
      load_tile<HD>(sK + (st ^ 1) * KT, kbase + k1 * kv_stride, kv_stride,
                    Sk - k1);
      load_tile<HD>(sV + (st ^ 1) * KT, vbase + k1 * kv_stride, kv_stride,
                    Sk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    // S = Q K^T, dP = dO V^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    mma_fence();
    mma_ss<HD>(s, dQ, make_desc<HD>(sK + st * KT));
    mma_ss<HD>(dp, dO, make_desc<HD>(sV + st * KT));
    mma_commit();
    mma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool full = k0 + TILE <= Sk && q0 + TILE <= Sq &&
                      (!causal || k0 + TILE - 1 <= q0) &&
                      (window <= 0 || q0 + TILE - 1 - k0 < window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const bool ok = full || visible(q0 + row0 + 8 * r,
                                      k0 + 8 * (i / 4) + col0 + i % 2, Sq,
                                      Sk, causal, window);
      s[i] = prob_grad(s[i], dp[i], L[r], D[r], scale, softcap, ok).ds;
    }
    uint32_t hi[4][4], lo[4][4];
    to_a_frags2(s, hi, lo);

    // dQ += dS K (this block's DQC columns of K)
    fence_regs(acc);
    mma_fence();
    mma_rs2<HD, DQC>(acc, hi, lo,
                     make_desc_mn<HD>(sK + st * KT +
                                      cb * (DQC / 64) * kPanelBytes));
    mma_commit();
    mma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* op = dq + (((size_t)b * Sq + qp) * H + h) * HD + cb * DQC;
#pragma unroll
    for (int j = 0; j < DQC / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(op + 8 * j + col0) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 3)
bwd_dkv_tc(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int Sq, int Sk, int H, int KV, int causal, int window,
           float softcap, float scale) {
  using namespace repro::tc;
  constexpr int KC = dkv_cols<HD>();
  constexpr int NCB = HD / KC;  // column blocks per key tile
  constexpr int NO = KC / 2;
  constexpr int KT = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + KT, sQ = base + 2 * KT,
                 sO = base + 4 * KT;
  // lse and D of the stage's q rows: [stage][0: lse, 1: D][64]
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * KT);

  // this block's key tile and dK / dV column block (one 64-column panel)
  const int cb = NCB > 1 ? blockIdx.x % NCB : 0;
  const int k0 = (NCB > 1 ? blockIdx.x / NCB : blockIdx.x) * TILE;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);

  // q rows that can see ANY key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + TILE - 1 + window);
  q_lo = (q_lo / TILE) * TILE;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + TILE - 1) / TILE : 0;
  const int nitems = rep * nq;  // (query head of the group, q tile) pairs

  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const size_t kvoff = (((size_t)b * Sk + k0) * KV + g) * HD;
  load_tile<HD>(sK, k + kvoff, kv_stride, Sk - k0);
  load_tile<HD>(sV, v + kvoff, kv_stride, Sk - k0);

  auto load_item = [&](int it, int st) {
    const int h = g * rep + it / nq;
    const int q0 = q_lo + (it % nq) * TILE;
    const size_t qoff = (((size_t)b * Sq + q0) * H + h) * HD;
    load_tile<HD>(sQ + st * KT, q + qoff, q_stride, Sq - q0);
    load_tile<HD>(sO + st * KT, dout + qoff, q_stride, Sq - q0);
    const int i = tid % TILE;
    const bool ok = q0 + i < Sq;
    const size_t lrow = ((size_t)b * H + h) * Sq + (ok ? q0 + i : 0);
    const float* src = tid < TILE ? lse + lrow : delta + lrow;
    cp_async4(smem_addr(rows + (2 * st + tid / TILE) * TILE + i), src, ok);
  };
  if (nitems > 0) load_item(0, 0);
  cp_async_commit();

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t dK = make_desc<HD>(sK), dV = make_desc<HD>(sV);

  for (int it = 0; it < nitems; ++it) {
    const int st = it & 1;
    const int q0 = q_lo + (it % nq) * TILE;
    if (it + 1 < nitems) {
      load_item(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    // S^T = K Q^T, dP^T = V dO^T: rows are keys, columns q rows
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    mma_fence();
    mma_ss<HD>(s, dK, make_desc<HD>(sQ + st * KT));
    mma_ss<HD>(dp, dV, make_desc<HD>(sO + st * KT));
    mma_commit();
    mma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool full = k0 + TILE <= Sk && q0 + TILE <= Sq &&
                      (!causal || k0 + TILE - 1 <= q0) &&
                      (window <= 0 || q0 + TILE - 1 - k0 < window);
    const float* Ls = rows + 2 * st * TILE;
    const float* Ds = Ls + TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + col0 + i % 2;  // q row within the tile
      const bool ok = full || visible(q0 + c, k0 + row0 + 8 * ((i / 2) % 2),
                                      Sq, Sk, causal, window);
      const Grad gr = prob_grad(s[i], dp[i], Ls[c], Ds[c], scale, softcap, ok);
      s[i] = gr.p;
      dp[i] = gr.ds;
    }

    // dV += P^T dO, dK += dS^T Q (this block's panel of dO and Q)
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    to_a_frags2(s, phi, plo);
    to_a_frags2(dp, dhi, dlo);
    fence_regs(dva);
    fence_regs(dka);
    mma_fence();
    mma_rs2<HD, KC>(dva, phi, plo, panel_desc_mn<HD>(sO + st * KT, cb));
    mma_rs2<HD, KC>(dka, dhi, dlo, panel_desc_mn<HD>(sQ + st * KT, cb));
    mma_commit();
    mma_wait();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(dhi);
    fence_regs(dlo);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + row0 + 8 * r;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * KV + g) * HD + cb * KC;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + col0) =
          pack_bf16(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + col0) =
          pack_bf16(dva[i], dva[i + 1]);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int bytes = bwd_smem_bytes<HD>();
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const size_t rows = (size_t)B * Sq * H;
  delta_kernel<bf, HD><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf*>(o), dot, delta, B, Sq, H);
  dim3 gq((Sq + TILE - 1) / TILE * (HD / dq_cols<HD>()), H, B);
  bwd_dq_tc<HD><<<gq, THREADS, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dq), Sq, Sk, H, KV,
      causal, window, softcap, scale);
  dim3 gk((Sk + TILE - 1) / TILE * (HD / dkv_cols<HD>()), KV, B);
  bwd_dkv_tc<HD><<<gk, THREADS, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      Sq, Sk, H, KV, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: one thread per query row or key on the FMA pipes
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int causal, int window,
                    float softcap, float scale) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int qpos = q0 + tid;
  const bool qvalid = qpos < Sq;
  constexpr int BK = simt_keys<HD>();

  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  float qr[HD], dor[HD], acc[HD];
  {
    const size_t off = ((size_t)(b * Sq + (qvalid ? qpos : 0)) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = repro::to_f(q[off + d]);
      dor[d] = repro::to_f(dout[off + d]);
      acc[d] = 0.f;
    }
  }
  const size_t lrow = ((size_t)b * H + h) * Sq + (qvalid ? qpos : 0);
  const float L = lse[lrow];
  const float Dr = delta[lrow];

  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + BQ);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * HD; e += BQ) {
      const int j = e / HD, d = e % HD;
      const int kp = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kp < Sk) {
        const size_t off = ((size_t)(b * Sk + kp) * KV + g) * HD + d;
        kval = repro::to_f(k[off]);
        vval = repro::to_f(v[off]);
      }
      ks[j][d] = kval;
      vs[j][d] = vval;
    }
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      if (!visible(qpos, kp, Sq, Sk, causal, window)) continue;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      const float s_raw = dot * scale;
      float s = s_raw, chain = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(s_raw / softcap);
        s = t * softcap;
        chain = 1.f - t * t;
      }
      const float p = expf(s - L);
      const float ds = p * (dp - Dr) * chain;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  if (qvalid) {
    T* op = dq + ((size_t)(b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = repro::from_f<T>(acc[d] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BKV)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                     int causal, int window, float softcap, float scale) {
  const int k0 = blockIdx.x * BKV;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int kpos = k0 + tid;
  const bool kvalid = kpos < Sk;

  // own rows, padded (conflict-free); the broadcast tiles; their lse and D
  extern __shared__ float smem_f[];
  float(*kt)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(smem_f);
  float(*vt)[HD + 1] = kt + BKV;
  float(*qs)[HD] = reinterpret_cast<float(*)[HD]>(vt + BKV);
  float(*dos)[HD] = qs + BQ2;
  float* Ls = reinterpret_cast<float*>(dos + BQ2);
  float* Ds = Ls + BQ2;

  {
    const size_t off = ((size_t)(b * Sk + (kvalid ? kpos : 0)) * KV + g) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      kt[tid][d] = repro::to_f(k[off + d]);
      vt[tid][d] = repro::to_f(v[off + d]);
    }
  }
  float dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;

  // query rows that can see ANY key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + BKV - 1 + window);
  q_lo = (q_lo / BQ2) * BQ2;

  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ2) {
      __syncthreads();
      for (int e = tid; e < BQ2 * HD; e += BKV) {
        const int i = e / HD, d = e % HD;
        const int qp = q0 + i;
        float qv = 0.f, dv_ = 0.f;
        if (qp < Sq) {
          const size_t off = ((size_t)(b * Sq + qp) * H + h) * HD + d;
          qv = repro::to_f(q[off]);
          dv_ = repro::to_f(dout[off]);
        }
        qs[i][d] = qv;
        dos[i][d] = dv_;
      }
      if (tid < BQ2) {
        const int qp = q0 + tid;
        const size_t lrow = ((size_t)b * H + h) * Sq + (qp < Sq ? qp : 0);
        Ls[tid] = lse[lrow];
        Ds[tid] = delta[lrow];
      }
      __syncthreads();

#pragma unroll 1
      for (int i = 0; i < BQ2; ++i) {
        if (!visible(q0 + i, kpos, Sq, Sk, causal, window)) continue;
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dot = fmaf(qs[i][d], kt[tid][d], dot);
          dp = fmaf(dos[i][d], vt[tid][d], dp);
        }
        const float s_raw = dot * scale;
        float s = s_raw, chain = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(s_raw / softcap);
          s = t * softcap;
          chain = 1.f - t * t;
        }
        const float p = expf(s - Ls[i]);
        const float dsc = p * (dp - Ds[i]) * chain;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dva[d] = fmaf(p, dos[i][d], dva[d]);
          dka[d] = fmaf(dsc, qs[i][d], dka[d]);
        }
      }
    }
  }

  if (kvalid) {
    const size_t off = ((size_t)(b * Sk + kpos) * KV + g) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[off + d] = repro::from_f<T>(dka[d] * scale);
      dv[off + d] = repro::from_f<T>(dva[d]);
    }
  }
}

template <typename T, int HD>
int launch_simt(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
                int causal, int window, float softcap, float scale,
                cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t rows = (size_t)B * Sq * H;
  delta_kernel<T, HD><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, B, Sq, H);
  dim3 gq((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, HD><<<gq, BQ, 0, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KV,
      causal, window, softcap, scale);
  constexpr int dkv_bytes = simt_dkv_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 gk((Sk + BKV - 1) / BKV, KV, B);
  flash_bwd_dkv_kernel<T, HD><<<gk, BKV, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 runs the tensor-core kernels, float32 the SIMT ones; any other
// dtype or head size is refused (cudaErrorInvalidValue), never rerouted.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int Sq, int Sk, int H,
                              int KV, int hd, int causal, int window,
                              float softcap, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_ARGS                                                          \
  q, k, v, o, l, dout, dq, dk, dv, dl, B, Sq, Sk, H, KV, causal, window,    \
      softcap, scale, s
  if (dtype == repro::kBFloat16) {
    switch (hd) {
      case 32: return launch_tc<32>(REPRO_ARGS);
      case 64: return launch_tc<64>(REPRO_ARGS);
      case 128: return launch_tc<128>(REPRO_ARGS);
      case 256: return launch_tc<256>(REPRO_ARGS);
    }
  } else if (dtype == repro::kFloat32) {
    switch (hd) {
      case 32: return launch_simt<float, 32>(REPRO_ARGS);
      case 64: return launch_simt<float, 64>(REPRO_ARGS);
      case 128: return launch_simt<float, 128>(REPRO_ARGS);
      case 256: return launch_simt<float, 256>(REPRO_ARGS);
    }
  }
#undef REPRO_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
