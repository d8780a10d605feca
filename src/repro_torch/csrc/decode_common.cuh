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
// a load; min(32, HD / VEC) lanes cover one position, whose K row for one
// kv head is HD contiguous elements in both cache layouts, with HD / (VEC
// LANES) loads a lane: 2 for float32 at hd 256) before it uses any, so each
// block waits for one memory round trip. Head sizes 32, 64, 128 and 256.
//
// Each block reduces its chunk to RG float32 partials (max, sum of
// exponentials, unnormalised output), one per query head of its group. A row whose live range fits in one
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
//
// With `lse` non-null the block that writes a head's output also writes
// its log-sum-exp, m + log(l) over the scaled, soft-capped scores it read
// (float32): the (max, sum) the writing block already holds. A caller that
// holds one slice of a row's cache (the length split over "model" ranks)
// merges the slices' outputs by it, so it takes them unrounded: the
// outputs are then float32 (else the inputs' T), a choice made at run time
// by the store (DecodeOut), so it adds no instantiation. A row whose live
// range [lo, len) is empty writes zeros and an lse of -inf.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeChunk = 128;  // positions per block; hopper/decode_attn.py

// The split workspace of one call: per (row, kv head, chunk, query head) the
// unnormalised output acc[HD] and (max, sum) in ml; one ticket counter per
// (row, kv head, head group), zero between calls.
struct DecodeSplit {
  float* acc;
  float2* ml;
  int* ticket;
  int chunks;  // chunk slots per (row, kv head): ceil(max length / C)
};

// Where a block stores its query heads' outputs (RG rows of HD from p):
// in the inputs' type T, or float32 (f32) for a caller that merges the
// slices of a length-split cache.
template <typename T>
struct DecodeOut {
  void* p;
  bool f32;
  __device__ __forceinline__ void operator()(int i, float x) const {
    if (f32)
      static_cast<float*>(p)[i] = x;
    else
      static_cast<T*>(p)[i] = from_f<T>(x);
  }
};

// Query heads one block reduces: the largest divisor of REP up to 5. A
// wider ratio is split over the grid into REP / RG groups, each block
// reading its chunk's K/V (again, from L2) for its own RG heads: REP 48
// (MQA over 48 heads) runs as 12 groups of 4 and REP 7 as 7 groups of 1,
// so no block's dependent chain grows with REP. The kernels are
// instantiated per RG, so a ratio costs no build of its own and any
// integer REP runs.
__host__ __device__ constexpr int decode_group(int rep) {
  int rg = rep < 5 ? rep : 5;
  while (rg > 1 && rep % rg != 0) --rg;
  return rg;
}

// q and o point at this block's first query head (RG rows of HD);
// blockIdx.x is the chunk. `ticket` indexes this block's (row, kv head,
// head group) counter; its partials of chunk c go to the workspace slots
// slot_base + c * rep + r, r < RG (rep = REP: the slots of a (row, kv
// head) hold every head of every chunk).
template <typename T, int HD, int RG, typename Rows>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ kc,
                                              const T* __restrict__ vc,
                                              const Rows rows, int lo,
                                              int len, float softcap,
                                              float scale,
                                              const DecodeOut<T> o,
                                              const DecodeSplit ws,
                                              int ticket, size_t slot_base,
                                              int rep,
                                              float* __restrict__ lse) {
  constexpr int C = kDecodeChunk;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LANES = HD / VEC < 32 ? HD / VEC : 32;  // lanes of a position
  constexpr int VPL = HD / (VEC * LANES);  // 16-byte loads per lane and row
  constexpr int GPW = 32 / LANES;       // positions per warp per step
  constexpr int NW = kDecodeWarps;
  constexpr int NG = GPW * NW;          // positions per block per step
  constexpr int PPT = C / NG;           // positions per lane group
  static_assert(HD % (VEC * LANES) == 0 && 32 % LANES == 0 && C % NG == 0,
                "head_dim layout");

  const int c = blockIdx.x;
  if (len <= lo) {  // an empty range returns zeros (and an lse of -inf)
    if (c == 0) {
      for (int t = threadIdx.x; t < RG * HD; t += NW * 32) o(t, 0.f);
      if (lse != nullptr && threadIdx.x < RG) lse[threadIdx.x] = __int_as_float(0xff800000);  // -inf
    }
    return;
  }
  const int c_lo = lo / C, c_hi = (len - 1) / C;
  if (c < c_lo || c > c_hi) return;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;
  const int grp = lane / LANES;

  // every K/V load of the chunk first, kept packed as loaded; a position
  // outside [lo, len) reads as zeros and is skipped below. Load j of a lane
  // holds elements (j LANES + sub) VEC ..: neighbouring lanes read
  // neighbouring 16 bytes.
  uint4 kraw[PPT][VPL], vraw[PPT][VPL];
  bool valid[PPT];
#pragma unroll
  for (int u = 0; u < PPT; ++u) {
    const int pos = c * C + u * NG + warp * GPW + grp;
    valid[u] = pos >= lo && pos < len;
    const long long off = valid[u] ? rows(pos) : -1;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (off >= 0) {
        const long long e = off + (j * LANES + sub) * VEC;
        kraw[u][j] = *reinterpret_cast<const uint4*>(kc + e);
        vraw[u][j] = *reinterpret_cast<const uint4*>(vc + e);
      } else {
        kraw[u][j] = vraw[u][j] = make_uint4(0, 0, 0, 0);
      }
    }
  }

  // one query head at a time, to the warp's partial in shared memory: the
  // chunk's scores, their max, the sum of exponentials and the output, then
  // the combine of the warp's GPW position groups (lanes LANES apart)
  __shared__ float sm_m[NW][RG];
  __shared__ float sm_l[NW][RG];
  __shared__ float sm_acc[NW][RG][HD];
  __shared__ bool sm_last;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    float qv[VPL][VEC];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      load_vec16<T, VEC>(q + r * HD + (j * LANES + sub) * VEC, qv[j]);
    float s[PPT];
    float m = kNegInf;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float kv[VEC];
        unpack16<T, VEC>(kraw[u][j], kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[j][e], kv[e], dot);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * scale;
      if (softcap > 0.f) s[u] = tanhf(s[u] / softcap) * softcap;
      if (valid[u]) m = fmaxf(m, s[u]);
    }
    float l = 0.f, acc[VPL][VEC];
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      if (valid[u]) {
        const float p = __expf(s[u] - m);
        l += p;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          float vv[VEC];
          unpack16<T, VEC>(vraw[u][j], vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
        }
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
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
          acc[j][e] = acc[j][e] * c1 + ao * c2;
        }
      m = mn;
    }
    if (grp == 0) {
      if (sub == 0) {
        sm_m[warp][r] = m;
        sm_l[warp][r] = l;
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][r][(j * LANES + sub) * VEC + e] = acc[j][e];
    }
  }

  // combine the NW warps through shared memory into the chunk's partial
  __syncthreads();
  const bool one_chunk = c_lo == c_hi;
  const size_t slot0 = slot_base + (size_t)c * rep;
  for (int t = threadIdx.x; t < RG * HD; t += NW * 32) {
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
      o(r * HD + d, aa / fmaxf(ll, 1e-30f));
      if (lse != nullptr && d == 0) lse[r] = mm + logf(ll);
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
    sm_last = atomicAdd(ws.ticket + ticket, 1) == c_hi - c_lo;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  for (int t = threadIdx.x; t < RG * HD; t += NW * 32) {
    const int r = t / HD, d = t % HD;
    float mm = kNegInf;
    for (int cc = c_lo; cc <= c_hi; ++cc)
      mm = fmaxf(mm, __ldcg(&ws.ml[slot_base + (size_t)cc * rep + r]).x);
    float ll = 0.f, aa = 0.f;
    for (int cc = c_lo; cc <= c_hi; ++cc) {
      const size_t s = slot_base + (size_t)cc * rep + r;
      const float2 p = __ldcg(&ws.ml[s]);
      const float cw = __expf(p.x - mm);
      ll += p.y * cw;
      aa += __ldcg(&ws.acc[s * HD + d]) * cw;
    }
    o(r * HD + d, aa / fmaxf(ll, 1e-30f));
    if (lse != nullptr && d == 0) lse[r] = mm + logf(ll);
  }
  if (threadIdx.x == 0) ws.ticket[ticket] = 0;
}

}  // namespace repro
