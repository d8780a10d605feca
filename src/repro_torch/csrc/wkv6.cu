// WKV6 recurrence (the RWKV6 "Finch" time-mix core) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/rwkv6_scan.py::wkv6_bh
//   (body `_kernel`, wrapper `ops.wkv6`).
// Plain reference: repro_torch.hopper.rwkv6_scan.wkv6_plain, the copy of
// repro/models/rwkv6.py::wkv6_scan. Per batch row b and head h, with the
// (hd, hd) f32 state S (row i = key index, column j = value index):
//
//   y_t[j]   = sum_i r_t[i] * S[i][j] + v_t[j] * Q_t,  Q_t = sum_i r_t[i] u[i] k_t[i]
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Layout: the MODEL's (B, T, H, hd) for r, k, v, w and y, read in place with
// its strides: the Pallas wrapper transposes all five to (B*H, T, hd) and
// back, which on the card would be two extra copies of each per layer. u is
// (H, hd) f32; the state (B, H, hd, hd) f32 is read once and written back in
// place.
//
// Both kernels cut the state the same way: a lane owns RT consecutive rows
// i by 4 consecutive columns j in registers; the hd / 4 lanes of a row slice
// span the row, a warp holds 32 / (hd / 4) slices, and a head's warps follow
// down the rows. y's row sum is taken in that order, fixed: each lane sums
// its RT rows in order, the slices of a warp merge by xor shuffles (lanes
// hd / 4, hd / 2, .. 16 apart), the warps add up in warp order through
// shared memory; Q is summed by one warp, lane l over rows l and l + 32,
// merged by xor shuffles 16, 8, 4, 2, 1. tests/test_torch_rwkv6.py emulates
// the order of both.
//
// Decode (T = 1), `wkv6_step_kernel`: bound by the state's bytes (B * H *
// hd * hd * 8 read and written per step against 3 operations per element).
// Every state access is a 16-byte load or store (RT = hd / 16 rows a lane),
// so a warp covers two whole 256-byte rows of S per access; 4 * hd threads
// a head (4x the first version's one thread a column), every state load
// issued before any arithmetic. No staging and one barrier: the warps'
// partial sums of y meet in 2 KB of shared memory. On the H100 it takes as
// long as PyTorch's copy of the same state (chip_smoke.py times both).
//
// Prefill (T > 1), `wkv6_scan_kernel`: the state stays in registers, and
// the 3 float32 instructions per state element and step (r S into y, k v,
// w S + k v) bound it. The first version (one thread a column) read r, k,
// u and w from shared memory for every element and step; here a lane owns
// RT = hd / 8 rows by 4 columns, so per step it reads its rows of r, k and
// w and its 4 values of v with one load each (16 bytes of bf16 at hd 64),
// for 4 * RT elements, and widens them in registers. A block (one head of
// one row; 128 threads at hd 64, 2x the first version's, each with 32
// elements) stages kChunk steps a chunk by cp.async into one of four
// buffers and runs one barrier a chunk: after it, chunk c + 2 loads, chunk
// c + 1's Qs are formed, chunk c computes and chunk c - 1's y is summed
// from the warps' partial sums. Nothing waits on device memory, and the
// Qs and the y sums overlap the other warps' steps.
//
// Backward (`wkv6_bwd_kernel`, entry `wkv6_bwd`; JAX differentiates the
// lax.scan reference, repro/models/rwkv6.py::wkv6_scan, as the Pallas kernel
// is forward only; plain version repro_torch.hopper.rwkv6_scan.
// wkv6_bwd_plain). With G_t = dL/dS_t, G_{t-1} = w_t G_t + r_t dy_t^T (from
// the final state's gradient), Q_t = sum_i r_t[i] u_i k_t[i] and
// P_t = v_t . dy_t:
//
//   dr_t[i] = sum_j S_{t-1}[i,j] dy_t[j] + u_i k_t[i] P_t
//   dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] P_t
//   dv_t[j] = sum_i G_t[i,j] k_t[i] + Q_t dy_t[j]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i] = sum_{b,t} r_t[i] k_t[i] P_t        dstate0 = G_0
//
// One block a (head, row) in the prefill kernel's layout (RT = hd / 8 rows
// by 4 columns a lane, a head's row slices over its warps), walking time in
// reverse with G in registers. dw needs S_{t-1} beside G_t, and S is never
// recovered by dividing by a decay (decays reach 1e-8): a first pass runs
// the recurrence forward and stores the state at every chunk boundary
// (kBwdChunk steps) in a scratch buffer, each lane its own elements; the
// reverse pass reloads a chunk's boundary state, recomputes the chunk's
// states into shared memory (each lane's own, in a lane-major layout
// without bank conflicts) and walks the chunk backwards. Row sums (dr, dk,
// dw) run across a row slice's lanes by a reduce-scatter of xor shuffles
// (row_scatter: 24 shuffles a step at hd 64 where an all-reduce takes 96);
// column sums (dv) by xor shuffles across the slices of a warp, then
// across warps in warp order through shared memory, as the forward's y;
// Q_t and P_t by one warp a step. du is one partial a row, summed by the
// wrapper in a fixed order: no float atomics, so two runs are bit-equal.
// What bounds it on the H100 is latency: each step is a chain of products
// and shuffles, so the warps an SM holds set the pace. Chunks of 3 steps
// (55 KB of shared memory a block) and a launch bound of four blocks an SM
// (<= 128 registers, no spills) measured fastest (chip_variants.py times
// the alternatives; PERF.md), still far above the FP32 work's bound (about
// 14 operations a state element and step).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro::tc::cp_async16;
using repro::tc::cp_async_commit;
using repro::tc::cp_async_wait;
using repro::tc::smem_addr;

// The layout of a head: RT rows by 4 columns a lane; the CG = hd / 4 lanes
// of a row slice span the row, a warp holds 32 / CG slices, and the head's
// warps follow down the rows.
template <int HD, int ROWS>
struct Tile {
  static constexpr int RT = ROWS;
  static constexpr int CG = HD / 4;     // lanes across one row slice
  static constexpr int RGW = 32 / CG;   // row slices a warp holds
  static constexpr int NW = HD / RT / RGW;
  static constexpr int THREADS = 32 * NW;
};
template <int HD>
using StepTile = Tile<HD, HD / 16>;   // decode: 16-byte state accesses
template <int HD>
using ScanTile = Tile<HD, HD / 8>;    // prefill: 32 elements a lane at hd 64

// merges a partial sum over the row slices of a warp (lanes CG apart)
template <int CG>
__device__ __forceinline__ float merge_slices(float p) {
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
    p += __shfl_xor_sync(0xffffffffu, p, off);
  return p;
}

// Q = sum_i r[i] u[i] k[i] over one warp: lane l takes rows l and l + 32
template <int HD>
__device__ __forceinline__ float ruk_sum(float r0, float k0, float u0,
                                         float r1, float k1, float u1) {
  float q = r0 * k0 * u0;
  if (HD > 32) q = fmaf(r1 * k1, u1, q);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    q += __shfl_xor_sync(0xffffffffu, q, off);
  return q;
}

__device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}

constexpr int kStepThreads = 256;  // 1, 2 or 4 heads of hd 64, 32, 16

template <typename T, int HD>
__global__ void __launch_bounds__(kStepThreads)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ state,
                 T* __restrict__ y, int BH, int H) {
  using L = StepTile<HD>;
  constexpr int RT = L::RT;
  constexpr int HPB = kStepThreads / L::THREADS;  // heads a block
  __shared__ float4 part[HPB][L::NW][L::CG];

  const int hl = threadIdx.x / L::THREADS;
  const int wi = threadIdx.x % L::THREADS / 32;    // warp within the head
  const int lane = threadIdx.x % 32;
  const int cg = lane % L::CG;
  const int i0 = RT * (wi * L::RGW + lane / L::CG);  // first row owned
  const int bh = blockIdx.x * HPB + hl;
  const bool live = bh < BH;                       // uniform over the head
  const size_t base = (size_t)(live ? bh : 0) * HD;  // (B, 1, H, hd)
  float4* st = reinterpret_cast<float4*>(state + base * HD);

  float4 S[RT];
  float ri[RT], ki[RT], wv[RT], vj[4];
  if (live) {
#pragma unroll
    for (int m = 0; m < RT; ++m) S[m] = st[((i0 + m) * HD + 4 * cg) / 4];
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      ri[m] = repro::to_f(r[base + i0 + m]);
      ki[m] = repro::to_f(k[base + i0 + m]);
      wv[m] = repro::to_f(w[base + i0 + m]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) vj[n] = repro::to_f(v[base + 4 * cg + n]);
  }

  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      float s[4] = {S[m].x, S[m].y, S[m].z, S[m].w};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        p[n] = fmaf(ri[m], s[n], p[n]);
        s[n] = fmaf(wv[m], s[n], ki[m] * vj[n]);
      }
      st[((i0 + m) * HD + 4 * cg) / 4] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) p[n] = merge_slices<L::CG>(p[n]);
  if (lane < L::CG) part[hl][wi][cg] = make_float4(p[0], p[1], p[2], p[3]);

  float q = 0.f;
  if (wi == 0) {
    float a[6] = {};
    if (live) {
      const size_t hu = (size_t)(bh % H) * HD;
      if (lane < HD) {
        a[0] = repro::to_f(r[base + lane]);
        a[1] = repro::to_f(k[base + lane]);
        a[2] = u[hu + lane];
      }
      if (HD > 32) {
        a[3] = repro::to_f(r[base + lane + 32]);
        a[4] = repro::to_f(k[base + lane + 32]);
        a[5] = u[hu + lane + 32];
      }
    }
    q = ruk_sum<HD>(a[0], a[1], a[2], a[3], a[4], a[5]);
  }
  __syncthreads();
  if (wi == 0 && lane < L::CG && live) {
    float4 t = part[hl][0][cg];
    float acc[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int x = 1; x < L::NW; ++x) {
      t = part[hl][x][cg];
      acc[0] += t.x; acc[1] += t.y; acc[2] += t.z; acc[3] += t.w;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n] = fmaf(vj[n], q, acc[n]);
    store4(y + base + 4 * cg, acc);
  }
}

constexpr int kChunk = 8;  // steps staged per chunk

template <typename T, int HD>
struct ScanSmem {
  alignas(16) T raw[4][4][kChunk][HD];  // r, k, w, v as loaded, 4 buffers
  float q[4][kChunk];                   // Q of each step
  alignas(16) float part[2][kChunk][ScanTile<HD>::NW][HD];  // warps' y sums
};

// NV consecutive floats, 16, 8 or 4 bytes at a time
template <int NV>
__device__ __forceinline__ void load_f(const float* p, float (&out)[NV]) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int x = 0; x < NV / 4; ++x) {
      const float4 t = reinterpret_cast<const float4*>(p)[x];
      out[4 * x] = t.x; out[4 * x + 1] = t.y;
      out[4 * x + 2] = t.z; out[4 * x + 3] = t.w;
    }
  } else if constexpr (NV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

// NV consecutive elements of the compute dtype, widened to float: bf16 in
// 16-byte loads (or one of 2 NV bytes), half the shared-memory traffic of
// float; the widening is a shift or a mask on the integer pipe
template <int NV>
__device__ __forceinline__ void load_t(const float* p, float (&out)[NV]) {
  load_f<NV>(p, out);
}
template <int NV>
__device__ __forceinline__ void load_t(const __nv_bfloat16* p,
                                       float (&out)[NV]) {
  uint32_t b[(NV + 1) / 2];
  if constexpr (NV % 8 == 0) {
#pragma unroll
    for (int x = 0; x < NV / 8; ++x) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[x];
      b[4 * x] = t.x; b[4 * x + 1] = t.y;
      b[4 * x + 2] = t.z; b[4 * x + 3] = t.w;
    }
  } else if constexpr (NV == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    b[0] = t.x; b[1] = t.y;
  } else if constexpr (NV == 2) {
    b[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    b[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int x = 0; x < NV; ++x)
    out[x] = __uint_as_float(x % 2 ? b[x / 2] & 0xffff0000u : b[x / 2] << 16);
}

template <typename T, int HD>
__global__ void __launch_bounds__(ScanTile<HD>::THREADS, 4)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ state,
                 T* __restrict__ y, int len, int H, int vec) {
  using L = ScanTile<HD>;
  constexpr int RT = L::RT, NT = L::THREADS;
  constexpr int E = 16 / sizeof(T);         // elements a 16-byte copy
  constexpr int PR = HD / E;                // 16-byte pieces a step's row
  extern __shared__ __align__(16) unsigned char smem[];
  ScanSmem<T, HD>& sm = *reinterpret_cast<ScanSmem<T, HD>*>(smem);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32;
  const int cg = lane % L::CG;
  const int i0 = RT * (wi * L::RGW + lane / L::CG);   // first row owned
  const size_t tstride = (size_t)H * HD;
  const size_t base = (size_t)b * len * tstride + (size_t)h * HD;
  float* st = state + ((size_t)b * H + h) * HD * HD;

  float S[RT][4];
#pragma unroll
  for (int m = 0; m < RT; ++m) load_f<4>(st + (i0 + m) * HD + 4 * cg, S[m]);
  const float u0 = lane < HD ? u[(size_t)h * HD + lane] : 0.f;
  const float u1 = HD > 32 ? u[(size_t)h * HD + lane + 32] : 0.f;

  // chunk c's r, k, w, v into raw[buf]; the loop runs over a whole chunk's
  // index space (compile-time divisors), skipping steps past the end
  auto stage = [&](int c, int buf) {
    const int t0 = c * kChunk, nt = min(kChunk, len - t0);
    for (int i = tid; i < 4 * kChunk * PR; i += NT) {
      const int a = i / (kChunk * PR), s = i / PR % kChunk, pc = i % PR;
      if (s >= nt) continue;
      const T* g = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v) + base +
                   (size_t)(t0 + s) * tstride + pc * E;
      T* d = &sm.raw[buf][a][s][pc * E];
      if (vec) {
        cp_async16(smem_addr(d), g, true);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = g[e];
      }
    }
  };
  // chunk c's Qs, one warp a step
  auto qs = [&](int c) {
    const int nt = min(kChunk, len - c * kChunk), cb = c & 3;
    for (int s = wi; s < nt; s += L::NW) {
      float a[4] = {};
      if (lane < HD) {
        a[0] = repro::to_f(sm.raw[cb][0][s][lane]);
        a[1] = repro::to_f(sm.raw[cb][1][s][lane]);
      }
      if (HD > 32) {
        a[2] = repro::to_f(sm.raw[cb][0][s][lane + 32]);
        a[3] = repro::to_f(sm.raw[cb][1][s][lane + 32]);
      }
      const float q = ruk_sum<HD>(a[0], a[1], u0, a[2], a[3], u1);
      if (lane == 0) sm.q[cb][s] = q;
    }
  };
  // y of chunk c: the warps' partial sums in warp order, + v Q; 4 columns
  // of one step a thread
  auto reduce = [&](int c) {
    const int t0 = c * kChunk, nt = min(kChunk, len - t0), vb = c & 3;
    for (int i = tid; i < kChunk * (HD / 4); i += NT) {
      const int s = i / (HD / 4), j = 4 * (i % (HD / 4));
      if (s >= nt) break;
      float acc[4];
      load_f<4>(&sm.part[c & 1][s][0][j], acc);
#pragma unroll
      for (int x = 1; x < L::NW; ++x) {
        float t[4];
        load_f<4>(&sm.part[c & 1][s][x][j], t);
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[n] += t[n];
      }
      float vv[4];
      load_t<4>(&sm.raw[vb][3][s][j], vv);
      const float q = sm.q[vb][s];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n] = fmaf(vv[n], q, acc[n]);
      store4(y + base + (size_t)(t0 + s) * tstride + j, acc);
    }
  };

  // one barrier a chunk: after it, chunk c + 2 loads, chunk c + 1's Qs are
  // formed, chunk c computes and chunk c - 1's y is written, each from its
  // own buffer
  const int nchunks = (len + kChunk - 1) / kChunk;
  stage(0, 0);
  cp_async_commit();
  if (nchunks > 1) stage(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  qs(0);
  for (int c = 0; c <= nchunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c and its Qs, c + 1 landed; c - 1 computed
    if (c + 2 < nchunks) stage(c + 2, (c + 2) & 3);
    cp_async_commit();
    if (c + 1 < nchunks) qs(c + 1);
    if (c > 0) reduce(c - 1);
    if (c == nchunks) break;
    const int nt = min(kChunk, len - c * kChunk), cb = c & 3;
    for (int s = 0; s < nt; ++s) {
      float rr[RT], kk[RT], ww[RT], vv[4];
      load_t<RT>(&sm.raw[cb][0][s][i0], rr);
      load_t<RT>(&sm.raw[cb][1][s][i0], kk);
      load_t<RT>(&sm.raw[cb][2][s][i0], ww);
      load_t<4>(&sm.raw[cb][3][s][4 * cg], vv);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < RT; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          p[n] = fmaf(rr[m], S[m][n], p[n]);
          S[m][n] = fmaf(ww[m], S[m][n], kk[m] * vv[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) p[n] = merge_slices<L::CG>(p[n]);
      if (lane < L::CG)
        *reinterpret_cast<float4*>(&sm.part[c & 1][s][wi][4 * cg]) =
            make_float4(p[0], p[1], p[2], p[3]);
    }
  }
#pragma unroll
  for (int m = 0; m < RT; ++m)
    *reinterpret_cast<float4*>(st + (i0 + m) * HD + 4 * cg) =
        make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
}

constexpr int kBwdChunk = 3;      // steps a chunk of the backward
constexpr int kBwdMinBlocks = 4;  // blocks an SM: <= 128 registers a thread

// The three row sums (dr, dk, dw) of a lane's M rows, over the CG = 2 M
// lanes of its row slice, by a reduce-scatter in fixed order: at each level
// half the rows go to the partner M, M / 2, .. 2 lanes apart, then a last
// xor 1 completes the sums; 3 M shuffles in place of the 3 M log2(CG) of an
// all-reduce. Lane cg ends with row cg >> 1's sums.
template <int M>
__device__ __forceinline__ void row_scatter(const float (&v)[3][M], int cg,
                                            float (&out)[3]) {
  if constexpr (M == 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      out[a] = v[a][0] + __shfl_xor_sync(0xffffffffu, v[a][0], 1);
  } else {
    constexpr int H = M / 2;
    const bool up = cg & M;
    float nv[3][H];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int i = 0; i < H; ++i)
        nv[a][i] = (up ? v[a][i + H] : v[a][i]) +
                   __shfl_xor_sync(0xffffffffu, up ? v[a][i] : v[a][i + H],
                                   M);
    }
    row_scatter<H>(nv, cg, out);
  }
}

// the backward's layout: the prefill kernel's, RT = hd / 8 rows a lane, so
// a row slice spans CG = 2 RT lanes (what row_scatter takes)
template <int HD>
using BwdTile = Tile<HD, HD / 8>;

template <int HD>
struct BwdSmem {
  using L = BwdTile<HD>;
  float4 hist[kBwdChunk][L::RT][L::THREADS];   // S_{t-1}, the lanes' own
  float in[5][kBwdChunk][HD];                  // r, k, v, w, dy widened
  float q[kBwdChunk], p[kBwdChunk];            // Q_t and P_t
  float part[kBwdChunk][L::NW][HD];            // the warps' dv sums
};

template <typename T, int HD>
__global__ void __launch_bounds__(BwdTile<HD>::THREADS, kBwdMinBlocks)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ state0,
                const T* __restrict__ dy, const float* __restrict__ dstate,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ pu,
                float* __restrict__ ds0, float* __restrict__ ckpt, int len,
                int H) {
  using L = BwdTile<HD>;
  constexpr int RT = L::RT, NT = L::THREADS, NW = L::NW, K = kBwdChunk;
  static_assert(L::CG == 2 * RT, "a row slice of 2 RT lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  BwdSmem<HD>& sm = *reinterpret_cast<BwdSmem<HD>*>(smem);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32;
  const int cg = lane % L::CG;
  const int i0 = RT * (wi * L::RGW + lane / L::CG);   // first row owned
  const size_t tstride = (size_t)H * HD;
  const size_t base = (size_t)b * len * tstride + (size_t)h * HD;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;  // this head's state
  const int nchk = (len + K - 1) / K;

  float S[RT][4], G[RT][4];
#pragma unroll
  for (int m = 0; m < RT; ++m) {
    load_f<4>(state0 + sbase + (i0 + m) * HD + 4 * cg, S[m]);
    if (dstate != nullptr) {
      load_f<4>(dstate + sbase + (i0 + m) * HD + 4 * cg, G[m]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) G[m][n] = 0.f;
    }
  }
  const float u0 = lane < HD ? u[(size_t)h * HD + lane] : 0.f;
  const float u1 = HD > 32 ? u[(size_t)h * HD + lane + 32] : 0.f;
  const int mi = cg >> 1;                   // the row of the scattered sums
  const float ui = u[(size_t)h * HD + i0 + mi];

  // chunk c's inputs a0 .. a1 - 1 of (r, k, v, w, dy), widened; plain loads
  auto stage = [&](int c, int a0, int a1) {
    const int t0 = c * K, nt = min(K, len - t0);
    for (int i = tid; i < 5 * K * HD; i += NT) {
      const int a = i / (K * HD), s = i / HD % K, j = i % HD;
      if (s >= nt || a < a0 || a >= a1) continue;
      const T* g = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w : dy;
      sm.in[a][s][j] = repro::to_f(g[base + (size_t)(t0 + s) * tstride + j]);
    }
  };
  // the boundary state before chunk c (c >= 1), this lane's row m
  auto ck = [&](int c, int m) {
    return ckpt + ((((size_t)b * H + h) * (nchk - 1) + (c - 1)) * HD + i0 + m)
                      * HD + 4 * cg;
  };

  // pass 1: the recurrence forward, the state stored at every chunk start
  for (int c = 0; c < nchk; ++c) {
    if (c > 0) {
#pragma unroll
      for (int m = 0; m < RT; ++m)
        *reinterpret_cast<float4*>(ck(c, m)) =
            make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
    }
    __syncthreads();
    stage(c, 1, 4);
    __syncthreads();
    const int nt = min(K, len - c * K);
    for (int s = 0; s < nt; ++s) {
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const float kk = sm.in[1][s][i0 + m], ww = sm.in[3][s][i0 + m];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          S[m][n] = fmaf(ww, S[m][n], kk * sm.in[2][s][4 * cg + n]);
      }
    }
  }

  // pass 2: chunks in reverse; each chunk's states recomputed, then walked
  // backwards
  float du = 0.f;                           // row mi's du partial
  for (int c = nchk - 1; c >= 0; --c) {
    const int t0 = c * K, nt = min(K, len - t0);
    __syncthreads();  // the previous chunk's dv sums are written
    stage(c, 0, 5);
    __syncthreads();
    // Q_t and P_t, one warp a step
    for (int s = wi; s < nt; s += NW) {
      float a[6] = {};
      if (lane < HD) {
        a[0] = sm.in[0][s][lane]; a[1] = sm.in[1][s][lane];
        a[3] = sm.in[2][s][lane]; a[4] = sm.in[4][s][lane];
      }
      if (HD > 32) {
        a[2] = sm.in[0][s][lane + 32]; a[5] = sm.in[1][s][lane + 32];
      }
      const float qv = ruk_sum<HD>(a[0], a[1], u0, a[2], a[5], u1);
      const float pv = ruk_sum<HD>(a[3], a[4], 1.f,
                                   HD > 32 ? sm.in[2][s][lane + 32] : 0.f,
                                   HD > 32 ? sm.in[4][s][lane + 32] : 0.f,
                                   1.f);
      if (lane == 0) {
        sm.q[s] = qv;
        sm.p[s] = pv;
      }
    }
    // this chunk's states S_{t-1}, from its boundary state
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < RT; ++m)
        load_f<4>(state0 + sbase + (i0 + m) * HD + 4 * cg, S[m]);
    } else {
#pragma unroll
      for (int m = 0; m < RT; ++m) load_f<4>(ck(c, m), S[m]);
    }
    for (int s = 0; s < nt; ++s) {
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        sm.hist[s][m][tid] = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
        const float kk = sm.in[1][s][i0 + m], ww = sm.in[3][s][i0 + m];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          S[m][n] = fmaf(ww, S[m][n], kk * sm.in[2][s][4 * cg + n]);
      }
    }
    __syncthreads();  // Q_t, P_t
    for (int s = nt - 1; s >= 0; --s) {
      float vv[4], dyv[4], pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        vv[n] = sm.in[2][s][4 * cg + n];
        dyv[n] = sm.in[4][s][4 * cg + n];
      }
      const float P = sm.p[s];
      const size_t o = base + (size_t)(t0 + s) * tstride;
      float acc[3][RT];                         // dr, dk, dw partials
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const float rr = sm.in[0][s][i0 + m], kk = sm.in[1][s][i0 + m];
        const float ww = sm.in[3][s][i0 + m];
        const float4 p4 = sm.hist[s][m][tid];
        const float sp[4] = {p4.x, p4.y, p4.z, p4.w};
        float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          a_r = fmaf(sp[n], dyv[n], a_r);
          a_k = fmaf(G[m][n], vv[n], a_k);
          a_w = fmaf(G[m][n], sp[n], a_w);
          pv[n] = fmaf(G[m][n], kk, pv[n]);
          G[m][n] = fmaf(ww, G[m][n], rr * dyv[n]);
        }
        acc[0][m] = a_r;
        acc[1][m] = a_k;
        acc[2][m] = a_w;
      }
      // row mi's sums; the lane pair splits the stores
      float sums[3];
      row_scatter<RT>(acc, cg, sums);
      const float rr = sm.in[0][s][i0 + mi], kk = sm.in[1][s][i0 + mi];
      du = fmaf(rr * kk, P, du);
      if (cg & 1) {
        dw[o + i0 + mi] = repro::from_f<T>(sums[2]);
      } else {
        dr[o + i0 + mi] = repro::from_f<T>(fmaf(ui * kk, P, sums[0]));
        dk[o + i0 + mi] = repro::from_f<T>(fmaf(ui * rr, P, sums[1]));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) pv[n] = merge_slices<L::CG>(pv[n]);
      if (lane < L::CG) {
#pragma unroll
        for (int n = 0; n < 4; ++n) sm.part[s][wi][4 * cg + n] = pv[n];
      }
    }
    __syncthreads();
    // dv of the chunk: the warps' sums in warp order, + Q_t dy_t
    for (int i = tid; i < nt * HD; i += NT) {
      const int s = i / HD, j = i % HD;
      float acc = sm.part[s][0][j];
#pragma unroll
      for (int x = 1; x < NW; ++x) acc += sm.part[s][x][j];
      acc = fmaf(sm.q[s], sm.in[4][s][j], acc);
      dv[base + (size_t)(t0 + s) * tstride + j] = repro::from_f<T>(acc);
    }
  }
#pragma unroll
  for (int m = 0; m < RT; ++m)
    *reinterpret_cast<float4*>(ds0 + sbase + (i0 + m) * HD + 4 * cg) =
        make_float4(G[m][0], G[m][1], G[m][2], G[m][3]);
  if ((cg & 1) == 0) pu[((size_t)b * H + h) * HD + i0 + mi] = du;
}

template <typename T, int HD>
void launch_bwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* state0, const void* dy,
                const void* dstate, void* dr, void* dk, void* dv, void* dw,
                void* pu, void* ds0, void* ckpt, int B, int len, int H,
                cudaStream_t s) {
  constexpr int kSmem = sizeof(BwdSmem<HD>);
  cudaFuncSetAttribute(wkv6_bwd_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  dim3 grid(H, B);
  wkv6_bwd_kernel<T, HD><<<grid, BwdTile<HD>::THREADS, kSmem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<const T*>(dy), static_cast<const float*>(dstate),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), static_cast<float*>(pu), static_cast<float*>(ds0),
      static_cast<float*>(ckpt), len, H);
}

template <typename T>
bool dispatch_bwd(int hd, const void* r, const void* k, const void* v,
                  const void* w, const void* u, const void* state0,
                  const void* dy, const void* dstate, void* dr, void* dk,
                  void* dv, void* dw, void* pu, void* ds0, void* ckpt, int B,
                  int len, int H, cudaStream_t s) {
  switch (hd) {
    case 16: launch_bwd<T, 16>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s); return true;
    case 32: launch_bwd<T, 32>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s); return true;
    case 64: launch_bwd<T, 64>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s); return true;
    default: return false;
  }
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* state, void* y, int B, int len, int H,
            bool decode, cudaStream_t s) {
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* w_ = static_cast<const T*>(w);
  const float* u_ = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  T* y_ = static_cast<T*>(y);
  if (decode) {
    constexpr int HPB = kStepThreads / StepTile<HD>::THREADS;
    wkv6_step_kernel<T, HD><<<(B * H + HPB - 1) / HPB, kStepThreads, 0, s>>>(
        r_, k_, v_, w_, u_, st, y_, B * H, H);
    return;
  }
  // cp.async takes 16-byte aligned rows: every base pointer aligned (a
  // step's row of a head is hd * sizeof(T) bytes, a multiple of 16)
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(w);
  const bool vec = any % 16 == 0;
  // dynamic shared memory: above the 48 KB a static array may take
  constexpr int kSmem = sizeof(ScanSmem<T, HD>);
  cudaFuncSetAttribute(wkv6_scan_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  dim3 grid(H, B);
  wkv6_scan_kernel<T, HD><<<grid, ScanTile<HD>::THREADS, kSmem, s>>>(
      r_, k_, v_, w_, u_, st, y_, len, H, vec);
}

template <typename T>
bool dispatch_hd(int hd, const void* r, const void* k, const void* v,
                 const void* w, const void* u, void* state, void* y, int B,
                 int len, int H, bool decode, cudaStream_t s) {
  switch (hd) {
    case 16: launch<T, 16>(r, k, v, w, u, state, y, B, len, H, decode, s); return true;
    case 32: launch<T, 32>(r, k, v, w, u, state, y, B, len, H, decode, s); return true;
    case 64: launch<T, 64>(r, k, v, w, u, state, y, B, len, H, decode, s); return true;
    default: return false;
  }
}

}  // namespace

// prefill_only: run the prefill kernel at T = 1 too (tests and chip_smoke.py
// compare the two kernels); otherwise T = 1 takes the decode kernel, which
// reads and writes the state 16 bytes at a time (16-byte aligned).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* state, void* y,
                        int B, int len, int H, int hd, int dtype,
                        int prefill_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool decode = len == 1 && !prefill_only;
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, state, y, B, len, H, decode, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_hd<float>(hd, r, k, v, w, u, state, y, B, len, H, decode, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward's chunk length: the wrapper sizes the boundary states by it.
// *smem, when not null, gets the dynamic shared memory the kernel launches
// with at head size hd (chip_smoke.py records it), or -1.
extern "C" int wkv6_bwd_chunk(int hd, int* smem) {
  if (smem) {
    switch (hd) {
      case 16: *smem = sizeof(BwdSmem<16>); break;
      case 32: *smem = sizeof(BwdSmem<32>); break;
      case 64: *smem = sizeof(BwdSmem<64>); break;
      default: *smem = -1;
    }
  }
  return kBwdChunk;
}

// The backward: every pointer as the wrapper allocates it (dstate may be
// null: a zero gradient of the final state); du's per-row partials are
// summed by the wrapper. The states are read and written 16 bytes at a time
// (16-byte aligned).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* state0,
                        const void* dy, const void* dstate, void* dr,
                        void* dk, void* dv, void* dw, void* pu, void* ds0,
                        void* ckpt, int B, int len, int H, int hd, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_bwd<__nv_bfloat16>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_bwd<float>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
