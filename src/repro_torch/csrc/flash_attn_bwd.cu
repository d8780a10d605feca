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
// Three kernels, as in _flash_bwd:
//   1. delta_kernel: D = rowsum(dout * out), float32 (B, H, Sq);
//   2. dq pass, q-major: one block per (64-row q tile, head, batch row),
//      one thread per query row holding q, dout and its dq accumulator in
//      registers; 32-key K/V tiles staged in shared memory and read as
//      broadcasts. Probabilities are recomputed from lse: p = exp(s - L),
//      ds = p (dp - D) (times the softcap chain 1 - tanh^2), dq += ds k.
//   3. dk/dv pass, kv-major: one block per (64-key tile, KV head, batch
//      row), one thread per key holding its dk/dv accumulators in
//      registers; its own k and v rows sit in padded shared memory
//      (conflict-free), and 16-row q/dout tiles of every query head of the
//      group are staged and broadcast. dv += p dout, dk += ds q.
//
// What bounds it on the H100: 2.5x the forward's arithmetic (QK^T, dO V^T,
// dS K, P^T dO, dS^T Q) against ~2x its bytes, so arithmetic; this first
// version runs it on the f32 FMA pipes (no tensor cores yet), like the
// forward. Masked tiles are skipped by the loop bounds.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // dq pass: query rows per block (one per thread)
constexpr int BK = 32;   // dq pass: keys per shared-memory tile
constexpr int BKV = 64;  // dk/dv pass: keys per block (one per thread)
constexpr int BQ2 = 16;  // dk/dv pass: query rows per shared-memory tile
                         // (41.6 KB of static shared memory at hd 64)

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

  __shared__ float kt[BKV][HD + 1];  // own rows, padded: conflict-free
  __shared__ float vt[BKV][HD + 1];
  __shared__ float qs[BQ2][HD];      // broadcast tiles
  __shared__ float dos[BQ2][HD];
  __shared__ float Ls[BQ2];
  __shared__ float Ds[BQ2];

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
void launch(const void* q, const void* k, const void* v, const void* o,
            const float* lse, const void* dout, void* dq, void* dk, void* dv,
            float* delta, int B, int Sq, int Sk, int H, int KV, int causal,
            int window, float softcap, float scale, cudaStream_t stream) {
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
  dim3 gk((Sk + BKV - 1) / BKV, KV, B);
  flash_bwd_dkv_kernel<T, HD><<<gk, BKV, 0, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, causal, window, softcap, scale);
}

}  // namespace

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
#define REPRO_LAUNCH(T, HD)                                                  \
  launch<T, HD>(q, k, v, o, l, dout, dq, dk, dv, dl, B, Sq, Sk, H, KV,       \
                causal, window, softcap, scale, s)
  if (dtype == repro::kBFloat16 && hd == 64)
    REPRO_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == repro::kFloat32 && hd == 64)
    REPRO_LAUNCH(float, 64);
  else if (dtype == repro::kBFloat16 && hd == 32)
    REPRO_LAUNCH(__nv_bfloat16, 32);
  else if (dtype == repro::kFloat32 && hd == 32)
    REPRO_LAUNCH(float, 32);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
