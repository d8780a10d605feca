// The single-token decode attention loop shared by the dense
// (decode_attn.cu) and the paged (paged_decode_attn.cu) decode kernels:
// flash-decoding, split over the cache length.
//
// A row's positions are cut into fixed chunks of kDecodeChunk positions,
// chunk c holding [c * C, (c + 1) * C). One thread block owns one (row,
// kv head, chunk); the REP = H / KV query heads of that GQA group share every
// K/V element it loads. A block whose chunk lies wholly outside the row's
// live range [lo, len) exits at once, so the bytes read grow with the live
// length only. Inside its chunk a block issues all its K/V loads (16 bytes
// a lane; HD / VEC lanes cover one position, whose K row for one kv head is
// HD contiguous elements in both cache layouts) before it uses any, so each
// block waits for one memory round trip.
//
// Each block reduces its chunk to REP float32 partials (max, sum of
// exponentials, unnormalised output). A row whose live range fits in one
// chunk normalises and writes the output from that block. Otherwise the
// blocks write their partials to a workspace, fence, and take a ticket on
// the (row, kv head)'s counter; the block that draws the last ticket merges
// the partials in chunk-index order, writes the output, and resets the
// counter to zero for the next call. So a call stays one launch, with no
// second combine kernel and no memset.
//
// Exponentials use the hardware's __expf (ex2.approx, a few ulp): the
// accurate expf's range reduction sat on every head's dependent chain, and
// the outputs' tolerances (float32 1e-4, bfloat16 2e-2) are far wider.
//
// Determinism: chunk boundaries, the position each lane reads and the order
// of every floating-point operation are functions of the position alone —
// never of L, the pool, B or the page size — and the final merge runs in
// chunk order, not in arrival order. Repeated calls are bit-equal, and the
// dense and paged kernels give the same bits on the same live K/V.
//
// Where a position's row lives is the caller's: `rows(pos)` returns the
// element offset of position pos's K (= V) row for this block's kv head,
// or -1 for a position that reads as zeros (a sentinel page of the paged
// cache).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeChunk = 128;  // positions per block; hopper/decode_attn.py

// The split workspace of one call: per (row, kv head, chunk, query head) the
// unnormalised output acc[HD] and (max, sum) in ml; one ticket counter per
// (row, kv head), zero between calls.
struct DecodeSplit {
  float* acc;
  float2* ml;
  int* ticket;
  int chunks;  // chunk slots per (row, kv head): ceil(max length / C)
};

// q and o point at this block's first query head (REP rows of HD); `pair` is
// the (row, kv head) index b * KV + g; blockIdx.x is the chunk.
template <typename T, int HD, int REP, typename Rows>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ kc,
                                              const T* __restrict__ vc,
                                              const Rows rows, int lo,
                                              int len, float softcap,
                                              float scale, T* __restrict__ o,
                                              const DecodeSplit ws,
                                              int pair) {
  constexpr int C = kDecodeChunk;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LANES = HD / VEC;       // lanes covering one position
  constexpr int GPW = 32 / LANES;       // positions per warp per step
  constexpr int NW = kDecodeWarps;
  constexpr int NG = GPW * NW;          // positions per block per step
  constexpr int PPT = C / NG;           // positions per lane group
  static_assert(HD % VEC == 0 && 32 % LANES == 0 && C % NG == 0,
                "head_dim layout");

  const int c = blockIdx.x;
  if (len <= 0) {  // an empty row returns zeros (never made by the engine)
    if (c == 0)
      for (int t = threadIdx.x; t < REP * HD; t += NW * 32) o[t] = from_f<T>(0.f);
    return;
  }
  const int c_lo = lo / C, c_hi = (len - 1) / C;
  if (c < c_lo || c > c_hi) return;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;
  const int grp = lane / LANES;

  // every K/V load of the chunk first, kept packed as loaded; a position
  // outside [lo, len) reads as zeros and is skipped below
  uint4 kraw[PPT], vraw[PPT];
  bool valid[PPT];
#pragma unroll
  for (int u = 0; u < PPT; ++u) {
    const int pos = c * C + u * NG + warp * GPW + grp;
    valid[u] = pos >= lo && pos < len;
    const long long off = valid[u] ? rows(pos) : -1;
    if (off >= 0) {
      kraw[u] = *reinterpret_cast<const uint4*>(kc + off + sub * VEC);
      vraw[u] = *reinterpret_cast<const uint4*>(vc + off + sub * VEC);
    } else {
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
    }
  }

  // one query head at a time, to the warp's partial in shared memory: the
  // chunk's scores, their max, the sum of exponentials and the output, then
  // the combine of the warp's GPW position groups (lanes LANES apart)
  __shared__ float sm_m[NW][REP];
  __shared__ float sm_l[NW][REP];
  __shared__ float sm_acc[NW][REP][HD];
  __shared__ bool sm_last;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float qv[VEC];
    load_vec16<T, VEC>(q + r * HD + sub * VEC, qv);
    float s[PPT];
    float m = kNegInf;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      float kv[VEC];
      unpack16<T, VEC>(kraw[u], kv);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kv[e], dot);
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * scale;
      if (softcap > 0.f) s[u] = tanhf(s[u] / softcap) * softcap;
      if (valid[u]) m = fmaxf(m, s[u]);
    }
    float l = 0.f, acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      if (valid[u]) {
        float vv[VEC];
        unpack16<T, VEC>(vraw[u], vv);
        const float p = __expf(s[u] - m);
        l += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
#pragma unroll
    for (int off = LANES; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l, off);
      const float mn = fmaxf(m, mo);
      const float c1 = __expf(m - mn), c2 = __expf(mo - mn);
      l = l * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[e], off);
        acc[e] = acc[e] * c1 + ao * c2;
      }
      m = mn;
    }
    if (grp == 0) {
      if (sub == 0) {
        sm_m[warp][r] = m;
        sm_l[warp][r] = l;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][r][sub * VEC + e] = acc[e];
    }
  }

  // combine the NW warps through shared memory into the chunk's partial
  __syncthreads();
  const bool one_chunk = c_lo == c_hi;
  const size_t slot0 = ((size_t)pair * ws.chunks + c) * REP;
  for (int t = threadIdx.x; t < REP * HD; t += NW * 32) {
    const int r = t / HD, d = t % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float cw = __expf(sm_m[w][r] - mm);
      ll += sm_l[w][r] * cw;
      aa += sm_acc[w][r][d] * cw;
    }
    if (one_chunk) {
      o[r * HD + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      ws.acc[(slot0 + r) * HD + d] = aa;
      if (d == 0) ws.ml[slot0 + r] = make_float2(mm, ll);
    }
  }
  if (one_chunk) return;

  // the last of the row's live chunks to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm_last = atomicAdd(ws.ticket + pair, 1) == c_hi - c_lo;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const size_t base = (size_t)pair * ws.chunks * REP;
  for (int t = threadIdx.x; t < REP * HD; t += NW * 32) {
    const int r = t / HD, d = t % HD;
    float mm = kNegInf;
    for (int cc = c_lo; cc <= c_hi; ++cc)
      mm = fmaxf(mm, __ldcg(&ws.ml[base + (size_t)cc * REP + r]).x);
    float ll = 0.f, aa = 0.f;
    for (int cc = c_lo; cc <= c_hi; ++cc) {
      const size_t s = base + (size_t)cc * REP + r;
      const float2 p = __ldcg(&ws.ml[s]);
      const float cw = __expf(p.x - mm);
      ll += p.y * cw;
      aa += __ldcg(&ws.acc[s * HD + d]) * cw;
    }
    o[r * HD + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) ws.ticket[pair] = 0;
}

}  // namespace repro
