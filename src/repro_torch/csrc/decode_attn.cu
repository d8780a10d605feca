// Single-token decode attention over the dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attn/decode_attn.py::decode_attention_kernel
//   (body `_kernel`).
// Plain reference: repro_torch.models.attention.decode_attention. One query
// token per row attends to cache positions [lo, cache_len), lo = cache_len -
// window for sliding-window layers and 0 otherwise; the REP = H / KV query
// heads of a GQA group share every K/V element the block loads.
//
// Layout: the MODEL's cache layout (B, L, KV, hd) — the one
// models/attention.py writes — not the Pallas kernel's (B, KV, L, hd), so the
// cache is read in place with no transpose. q and out are (B, 1, H, hd).
//
// What bounds it on the H100: memory. Each live cache byte is used for ~REP
// multiply-adds, far below the ~295 operations per byte at which the card
// stops being memory-bound. The design therefore reads each live cache byte
// exactly once: one block per (kv head, row), looping only up to cache_len, so
// the bytes moved scale with sum(cache_len), not pool * max_len. Within a
// block, hd/VEC lanes cooperate on one cache position with 16-byte loads (a
// position's K row for one kv head is hd contiguous elements), and each
// thread starts the K and V loads of two positions before using them, to keep
// more bytes in flight. At the main path's pool of 16 and KV = 8 heads this is
// 128 blocks on 132 SMs; no split over the length axis is used in this
// version (a split with a second combine pass is the next step when the pool
// is smaller).
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int NW = 8;  // warps per block

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lens,
              T* __restrict__ o, int L, int KV, int window, float softcap,
              float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LANES = HD / VEC;       // lanes covering one position
  constexpr int GPW = 32 / LANES;       // positions per warp per step
  constexpr int NG = GPW * NW;          // positions per block per step
  static_assert(HD % VEC == 0 && 32 % LANES == 0, "head_dim layout");

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int H = KV * REP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;
  const int grp = lane / LANES;

  const int len = min(lens[b], L);
  const int lo = window > 0 ? max(0, len - window) : 0;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    repro::load_vec16<T, VEC>(
        q + ((size_t)b * H + g * REP + r) * HD + sub * VEC, qv[r]);

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  const size_t row_stride = (size_t)KV * HD;
  const T* kb = kc + (size_t)b * L * row_stride + (size_t)g * HD + sub * VEC;
  const T* vb = vc + (size_t)b * L * row_stride + (size_t)g * HD + sub * VEC;

  // `base` is warp-uniform, so every lane runs the same trip count and the
  // full-mask shuffles below are safe; positions past `len` are skipped.
  for (int base = lo + warp * GPW; base < len; base += 2 * NG) {
    int pos[2] = {base + grp, base + NG + grp};
    float kv[2][VEC], vv[2][VEC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (pos[u] < len) {
        repro::load_vec16<T, VEC>(kb + (size_t)pos[u] * row_stride, kv[u]);
        repro::load_vec16<T, VEC>(vb + (size_t)pos[u] * row_stride, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[u][e] = vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool valid = pos[u] < len;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[r][e], kv[u][e], dot);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float s = dot * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        if (valid) {
          const float m_new = fmaxf(m[r], s);
          const float corr = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * corr + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][e] = fmaf(p, vv[u][e], acc[r][e] * corr);
          m[r] = m_new;
        }
      }
    }
  }

  // combine the GPW position groups of this warp (lanes LANES apart)
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float c1 = expf(m[r] - mn), c2 = expf(mo - mn);
      l[r] = l[r] * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * c1 + ao * c2;
      }
      m[r] = mn;
    }
  }

  // combine the NW warps through shared memory
  __shared__ float sm_m[NW][REP];
  __shared__ float sm_l[NW][REP];
  __shared__ float sm_acc[NW][REP][HD];
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (sub == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][r][sub * VEC + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < REP * HD; t += NW * 32) {
    const int r = t / HD, d = t % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][r] - mm);
      ll += sm_l[w][r] * c;
      aa += sm_acc[w][r][d] * c;
    }
    o[((size_t)b * H + g * REP + r) * HD + d] =
        repro::from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int HD, int REP>
void launch(const void* q, const void* k, const void* v, const int* lens,
            void* o, int B, int L, int KV, int window, float softcap,
            float scale, cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<T, HD, REP><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), L, KV, window,
      softcap, scale);
}

template <typename T, int HD>
bool dispatch_rep(int rep, const void* q, const void* k, const void* v,
                  const int* lens, void* o, int B, int L, int KV, int window,
                  float softcap, float scale, cudaStream_t s) {
  switch (rep) {
    case 1: launch<T, HD, 1>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 2: launch<T, HD, 2>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 3: launch<T, HD, 3>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 4: launch<T, HD, 4>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" int decode_attn_fwd(const void* q, const void* k_cache,
                               const void* v_cache, const void* cache_len,
                               void* o, int B, int L, int H, int KV, int hd,
                               int window, float softcap, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  const int rep = H / KV;
  bool ok = false;
  if (dtype == repro::kBFloat16 && hd == 64)
    ok = dispatch_rep<__nv_bfloat16, 64>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 64)
    ok = dispatch_rep<float, 64>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kBFloat16 && hd == 32)
    ok = dispatch_rep<__nv_bfloat16, 32>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 32)
    ok = dispatch_rep<float, 32>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
