// Prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py::flash_attention_bhsd
//   (body `_kernel`, wrapper `ops.flash_attention`).
// Computes causal / sliding-window / softcap GQA attention with an online
// softmax, f32 accumulation, output in q's dtype. Plain reference:
// repro_torch.models.attention.chunked_attention. Optionally (lse != NULL)
// also writes each row's logsumexp m + log(l), float32 in a (B, H, Sq)
// layout, which the backward (flash_attn_bwd.cu) reads; serving passes
// NULL.
//
// Layout: the model's own (B, S, H, hd) for q/out and (B, S, KV, hd) for k/v
// — no transpose and no jnp.repeat of KV heads: query head h reads KV head
// h / (H / KV) directly.
//
// What bounds it on the H100: bytes. At the main path's shapes (train q
// (32, 127, 32, 64), prefill q (16, 512, 32 or 25, 64), k/v over 8 or 5
// heads) it does 4 * B * H * hd * S^2 / 2 operations (~17 GFLOP at the
// prefill shape, 0.017 ms at 989 TFLOP/s in bf16) against
// 2 * B * S * (2 H + 2 KV) * hd bytes (84 MB, 0.025 ms at 3.35 TB/s); at
// the wide heads' (paper-qwen-7b's 28/4 x 128, gemma2-2b's 8/4 x 256,
// granite-34b's 48/1 x 128) bytes too.
//
// Head sizes 32, 64, 128 and 256, any H / KV. bfloat16: tensor cores
// (wgmma, sm_90a), flash_fwd_tc. One block of one warpgroup (128 threads)
// per (64-row q tile, head, batch row) up to hd 128. At hd 256 O's f32
// accumulator would be 128 registers a thread beside S (32) and P (16), so
// O's columns are split over two warpgroups (256 threads), 128 each, and
// both compute the tile's S and softmax from the shared Q and K tiles (S
// done twice: 1.5x the products of one warpgroup); ptxas gives 151
// registers at hd 128 and 156 at 256, no spills. (Two warpgroups sharing
// each K/V tile across 128 q rows ran slower at every hd-64 main-path
// shape.) Tiles wider than 64 columns are stored as 64-column panels
// (wgmma.cuh). The Q tile (64 x hd bf16) and a ring of two stages of 64-key K and V tiles live in
// swizzled shared memory (wgmma.cuh), filled by cp.async with zero-fill
// past Sk, so a ragged tile never reads the next batch row; tile j + 1 is in
// flight while tile j computes. Per K/V tile: S = Q K^T by hd/16 wgmma
// m64n64k16 from shared memory (f32 accumulate); the online softmax on the
// accumulator in registers (row max and row sum across the quad of threads
// that holds a row; softcap tanh; the causal, window and Sk masks only on
// tiles that straddle them; tiles masked for the whole q tile are skipped by
// the loop bounds); then O += P V by 4 wgmma m64n{OC}k16 (OC = hd, 128 at
// hd 256: a warpgroup's columns; n128 reads V across two panels) with P rounded to
// bf16 in registers as the A operand and V read MN-major (the transpose
// bit). Rounding points: bf16 inputs, f32 products and sums, P rounded to
// bf16 once before P V (its row sum l is taken in f32), O / l rounded to
// bf16. The logsumexp m + log l is f32 from f32 scores.
//
// float32: flash_fwd_simt, one thread per query row on the f32 FMA pipes
// (the first version of this kernel), kept because f32 callers (the
// GPU-against-CPU references) need atol 1e-4, which TF32 wgmma would not
// meet. It stages 32-key K/V tiles in shared memory (16 at hd 256, inside
// the 48 KB of static shared memory), read as broadcasts. At hd 128 and 256
// a thread's q row and accumulator spill to local memory (255 registers):
// it serves the small f32 reference configs, never a bf16 main path.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro::kNegInf;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 64;  // query rows per block, keys per K/V tile

// One warpgroup holds O's HD / 2 f32 columns per thread up to HD = 128; at
// HD = 256 O's columns are split over two warpgroups (128 each), which both
// compute the tile's S and softmax from the shared Q and K tiles.
template <int HD>
struct Fwd {
  static constexpr int kWG = HD > 128 ? HD / 128 : 1;  // warpgroups
  static constexpr int kOC = HD / kWG;       // O columns per warpgroup
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kTile = TILE * HD * 2;  // bytes of one swizzled tile
  static constexpr int kBytes = 5 * kTile;     // Q, K[2], V[2]
  static constexpr int kAlloc = kBytes + 1024;  // + alignment slack
};

// O (+)= P V over the four k-steps of a 64-key tile, for N = OC columns of
// an MN-major V tile (dv: the descriptor of the warpgroup's first column)
template <int HD, int OC>
__device__ __forceinline__ void mma_pv(float (&acc)[OC / 2],
                                       const uint32_t (&pa)[4][4],
                                       uint64_t dv) {
  using namespace repro::tc;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (OC == 128)
      mma_rs_n128(acc, pa[kk], dv + kk * kstep_mnmajor<HD>());
    else if constexpr (OC == 64)
      mma_rs_n64(acc, pa[kk], dv + kk * kstep_mnmajor<HD>());
    else
      mma_rs_n32(acc, pa[kk], dv + kk * kstep_mnmajor<HD>());
  }
}

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::kThreads)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int KV,
             int causal, int window, float softcap, float scale) {
  using namespace repro::tc;
  constexpr int OC = Fwd<HD>::kOC;
  constexpr int NT = Fwd<HD>::kThreads;
  constexpr int NO = OC / 2;  // O accumulator registers per thread
  constexpr int KT = Fwd<HD>::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + KT, sV = base + 3 * KT;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  // this thread's warpgroup (its O columns) and warp within it
  const int wg = Fwd<HD>::kWG > 1 ? tid / 128 : 0;
  const int warp = (Fwd<HD>::kWG > 1 ? tid % 128 : tid) / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: +0 and +8
  const int col0 = 2 * (lane % 4);        // its columns: +8 j, +1

  // keys that can be visible to ANY row of this q tile
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + TILE);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / TILE) * TILE;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + TILE - 1) / TILE : 0;

  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const __nv_bfloat16* kbase = k + ((size_t)b * Sk * KV + g) * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * Sk * KV + g) * HD;
  load_tile<HD, NT>(sQ, q + (((size_t)b * Sq + q0) * H + h) * HD, q_stride,
                    Sq - q0);
  if (ntiles > 0) {
    load_tile<HD, NT>(sK, kbase + kv_lo * kv_stride, kv_stride, Sk - kv_lo);
    load_tile<HD, NT>(sV, vbase + kv_lo * kv_stride, kv_stride, Sk - kv_lo);
  }
  cp_async_commit();

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows row0, row0 + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const uint64_t dQ = make_desc<HD>(sQ);
  // this warpgroup's first V column: panel OC / 64 * wg of a wide tile
  const uint32_t v_col = OC >= 64 ? wg * (OC / 64) * kPanelBytes : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kv_lo + t * TILE;
    const int st = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other stage
      const int k1 = k0 + TILE;
      load_tile<HD, NT>(sK + (st ^ 1) * KT, kbase + k1 * kv_stride,
                        kv_stride, Sk - k1);
      load_tile<HD, NT>(sV + (st ^ 1) * KT, vbase + k1 * kv_stride,
                        kv_stride, Sk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    mma_fence();
    const uint64_t dK = make_desc<HD>(sK + st * KT);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss_n64(s, dQ + kmajor_off<HD>(kk), dK + kmajor_off<HD>(kk),
                 kk > 0);
    mma_commit();
    mma_wait();
    fence_regs(s);

    // scores, masks, online softmax on the fragment
    const bool full = k0 + TILE <= Sk &&
                      (!causal || k0 + TILE - 1 <= q0) &&
                      (window <= 0 || q0 + TILE - 1 - k0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if (!full) {
        const int qp = q0 + row0 + 8 * ((i / 2) % 2);
        const int kp = k0 + 8 * (i / 4) + col0 + i % 2;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = exp2f((s[i] - m[r]) * kLog2e);
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr[(i / 2) % 2];
    uint32_t pa[4][4];
    to_a_frags(s, pa);

    // O += P V (this warpgroup's OC columns)
    fence_regs(acc);
    mma_fence();
    mma_pv<HD, OC>(acc, pa, make_desc_mn<HD>(sV + st * KT + v_col));
    mma_commit();
    mma_wait();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // every warp is done with this stage before refilling
  }
  cp_async_wait<0>();  // nothing left in flight (no K/V tile: Q alone)

  // epilogue: O / l in bf16, and the logsumexp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row0 + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* op = o + (((size_t)b * Sq + qp) * H + h) * HD + wg * OC;
#pragma unroll
    for (int j = 0; j < OC / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(op + 8 * j + col0) =
          pack_bf16(acc[i] * inv, acc[i + 1] * inv);
    }
    if (lse != nullptr && wg == 0 && lane % 4 == 0)
      lse[((size_t)b * H + h) * Sq + qp] = m[r] + logf(denom);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
              int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int bytes = Fwd<HD>::kAlloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + TILE - 1) / TILE, H, B);
  flash_fwd_tc<HD><<<grid, Fwd<HD>::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Sk, H, KV, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: one thread per query row on the FMA pipes
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block (one per thread)
// keys per shared-memory tile: the K, V and score tiles stay inside the 48
// KB of static shared memory (36 KB at HD = 256 with 16 keys)
template <int HD>
__host__ __device__ constexpr int simt_keys() { return HD > 128 ? 16 : 32; }

template <int HD>
__global__ void __launch_bounds__(BQ)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, int KV,
               int causal, int window, float softcap, float scale) {
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
  __shared__ float ps[BK][BQ];

  float qr[HD];
  float acc[HD];
  {
    const float* qp = q + ((size_t)(b * Sq + (qvalid ? qpos : 0)) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = qp[d];
      acc[d] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // KV range that can be unmasked for ANY row of this q-tile
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + BQ);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += BQ) {
      const int j = e / HD, d = e % HD;
      const int kp = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kp < Sk) {
        const size_t off = ((size_t)(b * Sk + kp) * KV + g) * HD + d;
        kval = k[off];
        vval = v[off];
      }
      ks[j][d] = kval;
      vs[j][d] = vval;
    }
    __syncthreads();

    // scores, then probabilities, of this tile for this thread's row; the
    // key loops stay rolled (small code, fast build) and each thread only
    // touches its own column, so no barrier is needed around ps
    float tmax = kNegInf;
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      float sc = dot * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const int kp = k0 + j;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && (qpos - kp) < window;
      sc = ok ? sc : kNegInf;
      ps[j][tid] = sc;
      tmax = fmaxf(tmax, sc);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const float sj = ps[j][tid];
      const float p = sj > kNegInf ? expf(sj - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (qvalid) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = o + ((size_t)(b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] / denom;
    if (lse != nullptr)
      lse[((size_t)b * H + h) * Sq + qpos] = m + logf(denom);
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                int window, float softcap, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_simt<HD><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 runs the tensor-core kernel, float32 the SIMT one; any other
// dtype or head size is refused (cudaErrorInvalidValue), never rerouted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int H, int KV, int hd, int causal, int window,
                              float softcap, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_LAUNCH(FN, HD) \
  FN<HD>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window, softcap, scale, s)
  if (dtype == repro::kBFloat16) {
    switch (hd) {
      case 32: return REPRO_LAUNCH(launch_tc, 32);
      case 64: return REPRO_LAUNCH(launch_tc, 64);
      case 128: return REPRO_LAUNCH(launch_tc, 128);
      case 256: return REPRO_LAUNCH(launch_tc, 256);
    }
  } else if (dtype == repro::kFloat32) {
    switch (hd) {
      case 32: return REPRO_LAUNCH(launch_simt, 32);
      case 64: return REPRO_LAUNCH(launch_simt, 64);
      case 128: return REPRO_LAUNCH(launch_simt, 128);
      case 256: return REPRO_LAUNCH(launch_simt, 256);
    }
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
