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
// What bounds it on the H100: at prefill shapes (S up to ~600, hd 64) the
// work is ~4*B*H*S^2*hd/2 operations against ~B*S*(H+2*KV)*hd*2 bytes, far
// above the card's ~295 operations per byte, so it is bound by arithmetic.
// This first version does that arithmetic on the f32 FMA pipes, not the
// tensor cores (wgmma comes later), so expect it well below the bf16 bound.
//
// Design: one block per (q-tile of 64 rows, head, batch row); one thread per
// query row, holding its q row and its output accumulator in registers. The
// TPU kernel's sequential KV grid axis becomes a loop inside the block over
// 32-key tiles staged in shared memory; every thread of a warp reads the same
// K/V element at once (a shared-memory broadcast, no bank conflicts). Tiles
// that the causal or window mask empties for the whole q-tile are skipped by
// the loop bounds.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int BQ = 64;  // query rows per block (one per thread)
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int causal, int window, float softcap, float scale) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int qpos = q0 + tid;
  const bool qvalid = qpos < Sq;

  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  __shared__ float ps[BK][BQ];

  float qr[HD];
  float acc[HD];
  {
    const T* qp = q + ((size_t)(b * Sq + (qvalid ? qpos : 0)) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = repro::to_f(qp[d]);
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
        kval = repro::to_f(k[off]);
        vval = repro::to_f(v[off]);
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
    T* op = o + ((size_t)(b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = repro::from_f<T>(acc[d] / denom);
    if (lse != nullptr)
      lse[((size_t)b * H + h) * Sq + qpos] = m + logf(denom);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
            int window, float softcap, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV,
      causal, window, softcap, scale);
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int H, int KV, int hd, int causal, int window,
                              float softcap, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kBFloat16 && hd == 64)
    launch<__nv_bfloat16, 64>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window,
                              softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 64)
    launch<float, 64>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window,
                      softcap, scale, s);
  else if (dtype == repro::kBFloat16 && hd == 32)
    launch<__nv_bfloat16, 32>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window,
                              softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 32)
    launch<float, 32>(q, k, v, o, l, B, Sq, Sk, H, KV, causal, window,
                      softcap, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
