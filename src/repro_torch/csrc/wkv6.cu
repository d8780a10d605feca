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
// by 4 columns a lane, 32 elements of S and of G in registers at hd 64, a
// head's row slices over its warps), walking time in reverse with G in
// registers. dw needs S_{t-1} beside G_t, and S is never recovered by
// dividing by a decay (decays reach 1e-8): the forward under autograd
// (wkv6_scan_save_kernel, entry `wkv6_fwd_save`) stores the state at every
// boundary of kBwdChunk = 8 steps in a scratch buffer, which the backward
// reads; the wrapper, given none, runs that kernel on a copy of the state
// first. The backward takes an interval of 8 steps a job, from the last,
// its inputs staged an interval ahead by cp.async (16-byte copies) with one
// barrier a job before the walk and one after, and walks it back in halves
// of kBwdHist = 4 steps: S from the interval's boundary (kept in shared
// memory), advanced over the half's earlier steps, then the half's states
// S_{t-1} kept in shared memory (16 KB a step at hd 64, each lane its own)
// and walked backwards. Row sums (dr, dk, dw) run across a row slice's
// lanes by a reduce-scatter of xor shuffles (row_scatter) and are stored
// as they complete; column sums (dv) over the warp's slices (col_scatter),
// then across warps in warp order through shared memory, + Q_t dy_t; Q_t
// and P_t by each warp for the interval's steps (lane s + 8 p over a
// quarter of step s's elements, merged by xor shuffles). du is one partial
// a row, summed by the wrapper in a fixed order: no float atomics, so two
// runs are bit-equal. What bounds the kernel is latency and issue: each
// step is a chain of products and shuffles, about 14 float32 operations a
// state element and step, two blocks an SM (98 KB of shared memory a
// block in bf16).
// Splitting a head's columns over a thread-block cluster (exact: S and G
// evolve element by element with row scalars r, k, w and column scalars v,
// dy; the row sums then merged in rank order through distributed shared
// memory) lost on the H100: chip_variants.py builds it from
// variants/wkv6_bwd_cluster.cu and times it beside this kernel (PERF.md).
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
template <int HD>
using BwdTile = Tile<HD, HD / 8>;     // backward: RT = CG / 2 rows a lane

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

// the backward's boundary interval: the state is kept every kBwdChunk steps
constexpr int kBwdChunk = 8;

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

// The prefill kernel's body; with SAVE (the forward under autograd) it also
// stores the state before every step t = kBwdChunk m, m >= 1, into ckpt
// (B, H, ceil(len / kBwdChunk) - 1, hd, hd): the boundaries the backward
// would otherwise recompute. Serving instantiates it without.
template <typename T, int HD, bool SAVE>
__device__ __forceinline__ void scan_body(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    float* __restrict__ state, T* __restrict__ y, int len, int H, int vec,
    float* __restrict__ ckpt) {
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
      if constexpr (SAVE) {
        const int t = c * kChunk + s;
        if (t > 0 && t % kBwdChunk == 0) {
          const int nb = (len + kBwdChunk - 1) / kBwdChunk - 1;
          float* ck = ckpt + (((size_t)b * H + h) * nb + t / kBwdChunk - 1)
                                 * HD * HD;
#pragma unroll
          for (int m = 0; m < RT; ++m)
            *reinterpret_cast<float4*>(ck + (i0 + m) * HD + 4 * cg) =
                make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
        }
      }
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

template <typename T, int HD>
__global__ void __launch_bounds__(ScanTile<HD>::THREADS, 4)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ state,
                 T* __restrict__ y, int len, int H, int vec) {
  scan_body<T, HD, false>(r, k, v, w, u, state, y, len, H, vec, nullptr);
}

template <typename T, int HD>
__global__ void __launch_bounds__(ScanTile<HD>::THREADS, 4)
wkv6_scan_save_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u, float* __restrict__ state,
                      T* __restrict__ y, int len, int H, int vec,
                      float* __restrict__ ckpt) {
  scan_body<T, HD, true>(r, k, v, w, u, state, y, len, H, vec, ckpt);
}

constexpr int kBwdHist = 4;       // steps of S_{t-1} a block keeps
constexpr int kBwdMinBlocks = 2;  // blocks an SM

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

// KB steps an interval between boundary states, KH of S_{t-1} kept
template <typename T, int HD, int KH, int KB>
struct BwdSmem {
  using L = BwdTile<HD>;
  float4 hist[KH][L::RT][L::THREADS];  // S_{t-1}, each lane its own
  alignas(16) T raw[2][5][KB][HD];     // r, k, v, w, dy as loaded, 2 buffers
  float part[KB][L::NW][HD];           // the warps' dv sums
  float q[KB];                         // Q_t
  float u[HD];
  float4 bnd[KB > KH ? L::RT : 1][L::THREADS];  // the interval's boundary
};

// Sums each of a lane's 4 column partials over the 32 / CG row slices of a
// warp (lanes CG apart) by a reduce-scatter in fixed order and stores the
// warp's sums at out[0 .. 4 CG): at xor 16 two of the four go to the
// partner, at xor 8 one (with 4 or more slices a warp), then an all-reduce
// over the slices left; one lane of each column stores it.
template <int CG>
__device__ __forceinline__ void col_scatter(const float (&v)[4], int lane,
                                            float* out) {
  const bool u16 = lane & 16;
  float a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a[i] = (u16 ? v[i + 2] : v[i]) +
           __shfl_xor_sync(0xffffffffu, u16 ? v[i] : v[i + 2], 16);
  const int col = 4 * (lane % CG) + (u16 ? 2 : 0);
  if constexpr (CG == 16) {
    out[col] = a[0];
    out[col + 1] = a[1];
  } else {
    const bool u8 = lane & 8;
    float x = (u8 ? a[1] : a[0]) +
              __shfl_xor_sync(0xffffffffu, u8 ? a[0] : a[1], 8);
#pragma unroll
    for (int off = CG; off < 8; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((lane & (8 - CG)) == 0) out[col + (u8 ? 1 : 0)] = x;
  }
}

// ckpt (B, H, ceil(len / KB) - 1, hd, hd): the state before interval
// c >= 1, as wkv6_scan_save_kernel stores it. A job is one interval of KB
// steps, from the last, walked back in sub-chunks of KH.
template <typename T, int HD, int KH, int KB>
__global__ void __launch_bounds__(BwdTile<HD>::THREADS, kBwdMinBlocks)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ state0,
                const T* __restrict__ dy, const float* __restrict__ dstate,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ pu,
                float* __restrict__ ds0, const float* __restrict__ ckpt,
                int len, int H, int vec) {
  using L = BwdTile<HD>;
  using Sm = BwdSmem<T, HD, KH, KB>;
  constexpr int K = KB;
  constexpr int RT = L::RT, CG = L::CG, NT = L::THREADS, NW = L::NW;
  constexpr int E = 16 / sizeof(T), PR = HD / E;   // 16-byte pieces a row
  constexpr int EP = HD / (32 / K);                // Q, P: elements a lane
  constexpr int EV = EP < 4 ? EP : 4;              // ... a load
  static_assert(CG == 2 * RT && RT >= 1 && 32 % K == 0 && EP >= 1,
                "2 RT lanes a row slice; K divides a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32;
  const int cg = lane % CG, mi = cg >> 1;   // mi: the row of the row sums
  const int i0 = RT * (wi * L::RGW + lane / CG);   // first row owned
  const int jc = 4 * cg;                           // first column owned
  const size_t tstride = (size_t)H * HD;
  const size_t base = (size_t)b * len * tstride + (size_t)h * HD;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;  // this head's state
  const int nchk = (len + K - 1) / K;

  float S[RT][4], G[RT][4];
#pragma unroll
  for (int m = 0; m < RT; ++m) {
    if (dstate != nullptr) {
      load_f<4>(dstate + sbase + (i0 + m) * HD + jc, G[m]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) G[m][n] = 0.f;
    }
  }
  for (int i = tid; i < HD; i += NT) sm.u[i] = u[(size_t)h * HD + i];
  const float ui = u[(size_t)h * HD + i0 + mi];

  // job j: interval nchk - 1 - j; its inputs go to raw[j & 1]
  auto stage = [&](int j) {
    const int t0 = (nchk - 1 - j) * K, nt = min(K, len - t0);
    for (int i = tid; i < 5 * K * PR; i += NT) {
      const int a = i / (K * PR), s = i / PR % K, pc = i % PR;
      if (s >= nt) continue;
      const T* g = (a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w : dy) +
                   base + (size_t)(t0 + s) * tstride + pc * E;
      T* d = &sm.raw[j & 1][a][s][pc * E];
      if (vec) {
        cp_async16(smem_addr(d), g, true);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = g[e];
      }
    }
  };
  // this lane's rows of the boundary state before interval c
  auto load_bound = [&](int c, float (&dst)[RT][4]) {
#pragma unroll
    for (int m = 0; m < RT; ++m)
      load_f<4>(c == 0 ? state0 + sbase + (i0 + m) * HD + jc
                       : ckpt + ((((size_t)b * H + h) * (nchk - 1) + (c - 1))
                                 * HD + i0 + m) * HD + jc,
                dst[m]);
  };

  // one block barrier a job: after it job j's inputs have landed and job
  // j + 1's load; a second after the walk, before the interval's dv
  float du = 0.f;                           // row mi's du partial
  // the boundary state of the next interval, loaded an interval ahead
  float Sb[RT][4];
  load_bound(nchk - 1, Sb);
  stage(0);
  cp_async_commit();
  for (int j = 0; j < nchk; ++j) {
    const int c = nchk - 1 - j, buf = j & 1;
    const int t0 = c * K, nt = min(K, len - t0);
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nchk) stage(j + 1);
    cp_async_commit();
    // Q_t and P_t of the interval's steps: lane s + K p sums the p-th share
    // of step s's elements in order, merged by xor shuffles K, 2 K, .. 16
    float qv = 0.f, pv = 0.f;
    {
      const int s = lane % K, e0 = lane / K * EP;
      if (s < nt) {
#pragma unroll
        for (int e = 0; e < EP; e += EV) {
          float rr[EV], kk[EV], vv[EV], dd[EV];
          load_t<EV>(&sm.raw[buf][0][s][e0 + e], rr);
          load_t<EV>(&sm.raw[buf][1][s][e0 + e], kk);
          load_t<EV>(&sm.raw[buf][2][s][e0 + e], vv);
          load_t<EV>(&sm.raw[buf][4][s][e0 + e], dd);
#pragma unroll
          for (int x = 0; x < EV; ++x) {
            qv = fmaf(rr[x] * kk[x], sm.u[e0 + e + x], qv);
            pv = fmaf(vv[x], dd[x], pv);
          }
        }
      }
#pragma unroll
      for (int off = K; off < 32; off <<= 1) {
        qv += __shfl_xor_sync(0xffffffffu, qv, off);
        pv += __shfl_xor_sync(0xffffffffu, pv, off);
      }
      if (wi == 0 && lane < K) sm.q[lane] = qv;
    }
    // the interval backwards, in sub-chunks of KH steps from the last: S
    // from the interval's boundary (kept in shared memory), advanced without
    // keeping over the sub-chunk's earlier steps, then the sub-chunk's
    // states S_{t-1} kept in hist and walked backwards; the next interval's
    // boundary loads meanwhile
#pragma unroll
    for (int m = 0; m < RT; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) S[m][n] = Sb[m][n];
    }
    if constexpr (KB > KH) {
      if (nt > KH) {
#pragma unroll
        for (int m = 0; m < RT; ++m)
          sm.bnd[m][tid] = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
      }
    }
    if (c > 0) load_bound(c - 1, Sb);
    auto advance = [&](int t) {           // S over step t of the interval
      float kk[RT], ww[RT], vv[4];
      load_t<RT>(&sm.raw[buf][1][t][i0], kk);
      load_t<RT>(&sm.raw[buf][3][t][i0], ww);
      load_t<4>(&sm.raw[buf][2][t][jc], vv);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          S[m][n] = fmaf(ww[m], S[m][n], kk[m] * vv[n]);
      }
    };
    const int last = (nt - 1) / KH;
    for (int q = last; q >= 0; --q) {
      const int s0 = q * KH, ns = min(KH, nt - s0);
      if constexpr (KB > KH) {
        if (q != last) {
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float4 b4 = sm.bnd[m][tid];
            S[m][0] = b4.x; S[m][1] = b4.y; S[m][2] = b4.z; S[m][3] = b4.w;
          }
        }
      }
      for (int t = 0; t < s0; ++t) advance(t);
#pragma unroll
      for (int s = 0; s < KH; ++s) {
        if (s >= ns) break;
#pragma unroll
        for (int m = 0; m < RT; ++m)
          sm.hist[s][m][tid] = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
        advance(s0 + s);
      }
#pragma unroll
      for (int s = KH - 1; s >= 0; --s) {
        if (s >= ns) continue;                    // uniform over the block
        const int t = s0 + s;                     // the step in the interval
        float rr[RT], kk[RT], ww[RT], vv[4], dyv[4];
        load_t<RT>(&sm.raw[buf][0][t][i0], rr);
        load_t<RT>(&sm.raw[buf][1][t][i0], kk);
        load_t<RT>(&sm.raw[buf][3][t][i0], ww);
        load_t<4>(&sm.raw[buf][2][t][jc], vv);
        load_t<4>(&sm.raw[buf][4][t][jc], dyv);
        const float P = __shfl_sync(0xffffffffu, pv, t);
        float acc[3][RT], cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const float4 p4 = sm.hist[s][m][tid];
          const float sp[4] = {p4.x, p4.y, p4.z, p4.w};
          float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            a_r = fmaf(sp[n], dyv[n], a_r);
            a_k = fmaf(G[m][n], vv[n], a_k);
            a_w = fmaf(G[m][n], sp[n], a_w);
            cs[n] = fmaf(G[m][n], kk[m], cs[n]);
            G[m][n] = fmaf(ww[m], G[m][n], rr[m] * dyv[n]);
          }
          acc[0][m] = a_r;
          acc[1][m] = a_k;
          acc[2][m] = a_w;
        }
        // row mi's sums plus the u terms; the lane pair splits the stores
        float sums[3];
        row_scatter<RT>(acc, cg, sums);
        const float rm = repro::to_f(sm.raw[buf][0][t][i0 + mi]);
        const float km = repro::to_f(sm.raw[buf][1][t][i0 + mi]);
        const size_t o = base + (size_t)(t0 + t) * tstride + i0 + mi;
        if (cg & 1) {
          dw[o] = repro::from_f<T>(sums[2]);
        } else {
          dr[o] = repro::from_f<T>(fmaf(ui * km, P, sums[0]));
          dk[o] = repro::from_f<T>(fmaf(ui * rm, P, sums[1]));
        }
        du = fmaf(rm * km, P, du);
        col_scatter<CG>(cs, lane, &sm.part[t][wi][0]);
      }
    }
    __syncthreads();
    // dv of the interval: the warps' sums in warp order, + Q_t dy_t
    for (int i = tid; i < nt * HD; i += NT) {
      const int s = i / HD, jj = i % HD;
      float acc = sm.part[s][0][jj];
#pragma unroll
      for (int x = 1; x < NW; ++x) acc += sm.part[s][x][jj];
      acc = fmaf(sm.q[s], repro::to_f(sm.raw[buf][4][s][jj]), acc);
      dv[base + (size_t)(t0 + s) * tstride + jj] = repro::from_f<T>(acc);
    }
  }
#pragma unroll
  for (int m = 0; m < RT; ++m)
    *reinterpret_cast<float4*>(ds0 + sbase + (i0 + m) * HD + jc) =
        make_float4(G[m][0], G[m][1], G[m][2], G[m][3]);
  if ((cg & 1) == 0) pu[((size_t)b * H + h) * HD + i0 + mi] = du;
}

// the backward's dynamic shared memory at head size HD
template <typename T, int HD>
constexpr int kBwdSmem = sizeof(BwdSmem<T, HD, kBwdHist, kBwdChunk>);

template <typename T, int HD>
int launch_bwd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* state0, const void* dy,
               const void* dstate, void* dr, void* dk, void* dv, void* dw,
               void* pu, void* ds0, const void* ckpt, int B, int len, int H,
               cudaStream_t s) {
  constexpr auto kernel = wkv6_bwd_kernel<T, HD, kBwdHist, kBwdChunk>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem<T, HD>);
  if (e != cudaSuccess) return static_cast<int>(e);
  // cp.async takes 16-byte aligned rows
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(dy);
  kernel<<<dim3(H, B), BwdTile<HD>::THREADS, kBwdSmem<T, HD>, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<const T*>(dy), static_cast<const float*>(dstate),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), static_cast<float*>(pu), static_cast<float*>(ds0),
      static_cast<const float*>(ckpt), len, H,
      static_cast<int>(any % 16 == 0));
  return 0;
}

template <typename T>
int dispatch_bwd(int hd, const void* r, const void* k, const void* v,
                 const void* w, const void* u, const void* state0,
                 const void* dy, const void* dstate, void* dr, void* dk,
                 void* dv, void* dw, void* pu, void* ds0, const void* ckpt,
                 int B, int len, int H, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    case 32: return launch_bwd<T, 32>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    case 64: return launch_bwd<T, 64>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* state, void* y, int B, int len, int H,
            bool decode, float* ckpt, cudaStream_t s) {
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
  dim3 grid(H, B);
  if (ckpt != nullptr) {
    cudaFuncSetAttribute(wkv6_scan_save_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    wkv6_scan_save_kernel<T, HD><<<grid, ScanTile<HD>::THREADS, kSmem, s>>>(
        r_, k_, v_, w_, u_, st, y_, len, H, vec, ckpt);
    return;
  }
  cudaFuncSetAttribute(wkv6_scan_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  wkv6_scan_kernel<T, HD><<<grid, ScanTile<HD>::THREADS, kSmem, s>>>(
      r_, k_, v_, w_, u_, st, y_, len, H, vec);
}

template <typename T>
bool dispatch_hd(int hd, const void* r, const void* k, const void* v,
                 const void* w, const void* u, void* state, void* y, int B,
                 int len, int H, bool decode, float* ckpt, cudaStream_t s) {
  switch (hd) {
    case 16: launch<T, 16>(r, k, v, w, u, state, y, B, len, H, decode, ckpt, s); return true;
    case 32: launch<T, 32>(r, k, v, w, u, state, y, B, len, H, decode, ckpt, s); return true;
    case 64: launch<T, 64>(r, k, v, w, u, state, y, B, len, H, decode, ckpt, s); return true;
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
    ok = dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, state, y, B, len, H, decode, nullptr, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_hd<float>(hd, r, k, v, w, u, state, y, B, len, H, decode, nullptr, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The forward under autograd: the prefill kernel at any len, storing the
// backward's boundary states into ckpt (B, H, ceil(len / chunk) - 1, hd,
// hd) f32, 16-byte aligned, as wkv6_bwd reads them.
extern "C" int wkv6_fwd_save(const void* r, const void* k, const void* v,
                             const void* w, const void* u, void* state,
                             void* y, void* ckpt, int B, int len, int H,
                             int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ck = static_cast<float*>(ckpt);
  if (ck == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, state, y, B, len, H, false, ck, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_hd<float>(hd, r, k, v, w, u, state, y, B, len, H, false, ck, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward's chunk length (the boundary interval): the wrapper sizes
// the boundary states by it. *smem, when not null, gets the dynamic shared
// memory the kernel launches with at head size hd and dtype (chip_smoke.py
// records it), or -1.
extern "C" int wkv6_bwd_chunk(int hd, int dtype, int* smem) {
  if (smem) {
    const bool bf16 = dtype == repro::kBFloat16;
    switch (hd) {
      case 16: *smem = bf16 ? kBwdSmem<__nv_bfloat16, 16> : kBwdSmem<float, 16>; break;
      case 32: *smem = bf16 ? kBwdSmem<__nv_bfloat16, 32> : kBwdSmem<float, 32>; break;
      case 64: *smem = bf16 ? kBwdSmem<__nv_bfloat16, 64> : kBwdSmem<float, 64>; break;
      default: *smem = -1;
    }
  }
  return kBwdChunk;
}

// The backward: every pointer as the wrapper allocates it (dstate may be
// null: a zero gradient of the final state); du's per-row partials are
// summed by the wrapper. ckpt: the boundary states wkv6_fwd_save stored,
// null only when len fits in one interval. The states are read and
// written 16 bytes at a time (16-byte aligned).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* state0,
                        const void* dy, const void* dstate, void* dr,
                        void* dk, void* dv, void* dw, void* pu, void* ds0,
                        const void* ckpt, int B, int len, int H, int hd,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1 || (ckpt == nullptr && len > kBwdChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kBFloat16)
    err = dispatch_bwd<__nv_bfloat16>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  else if (dtype == repro::kFloat32)
    err = dispatch_bwd<float>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
