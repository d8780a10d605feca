// The single-token decode attention loop shared by the dense
// (decode_attn.cu) and the paged (paged_decode_attn.cu) decode kernels.
//
// One thread block owns one (row, kv head) pair; the REP = H / KV query
// heads of that GQA group share every K/V element the block loads. The
// block walks the cache positions [lo, len) once, with an online softmax in
// float32, so the bytes it reads grow with the live length only. Within a
// block, HD / VEC lanes cooperate on one position with 16-byte loads (a
// position's K row for one kv head is HD contiguous elements, in both cache
// layouts), and each thread starts the K and V loads of two positions
// before using them, to keep more bytes in flight.
//
// Where a position's row lives is the caller's: `rows(pos)` returns the
// element offset of position pos's K (= V) row for this block's kv head,
// or -1 for a position that reads as zeros (a sentinel page of the paged
// cache).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 8;

// q and o point at this block's first query head (REP rows of HD).
template <typename T, int HD, int REP, typename Rows>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ kc,
                                              const T* __restrict__ vc,
                                              const Rows rows, int lo,
                                              int len, float softcap,
                                              float scale, T* __restrict__ o) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LANES = HD / VEC;       // lanes covering one position
  constexpr int GPW = 32 / LANES;       // positions per warp per step
  constexpr int NW = kDecodeWarps;
  constexpr int NG = GPW * NW;          // positions per block per step
  static_assert(HD % VEC == 0 && 32 % LANES == 0, "head_dim layout");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;
  const int grp = lane / LANES;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) load_vec16<T, VEC>(q + r * HD + sub * VEC, qv[r]);

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // `base` is warp-uniform, so every lane runs the same trip count and the
  // full-mask shuffles below are safe; positions past `len` are skipped.
  for (int base = lo + warp * GPW; base < len; base += 2 * NG) {
    int pos[2] = {base + grp, base + NG + grp};
    float kv[2][VEC], vv[2][VEC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long off = pos[u] < len ? rows(pos[u]) : -1;
      if (off >= 0) {
        load_vec16<T, VEC>(kc + off + sub * VEC, kv[u]);
        load_vec16<T, VEC>(vc + off + sub * VEC, vv[u]);
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
    o[r * HD + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

}  // namespace repro
