// Selective scan (the Mamba recurrence of the hymba block) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/ssm_scan.py::selective_scan_kernel
//   (body `_kernel`, wrapper `ops.selective_scan`).
// Plain reference: repro_torch.hopper.ssm_scan.selective_scan_plain, the copy
// of repro/models/ssm.py::selective_scan. Per batch row b and channel c:
//
//   h_t[n] = exp(-exp(A_log[c, n]) * dt_t) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n] + D[c] * x_t
//
// with f32 state and arithmetic; x, dt, B, C and y in the compute dtype.
//
// Layout: the MODEL's (B, T, di) for x, dt and y (channel contiguous), read
// in place: the Pallas wrapper pads di and T, the kernel guards the channel
// tail and loops to T instead. B and C are (B, T, N) views with their own
// batch and time strides (slices of the x_proj output), read without a copy.
// The state (B, di, N) f32 is read once and written back in place.
//
// What bounds it on the H100: at decode (T = 1) the bytes: the state is read
// and written once per step (B * di * N * 8 bytes) against ~8 operations per
// state element. At prefill the state stays in registers for the whole
// sequence and the bytes are x, dt, y; the B * T * di * N exponentials then
// bound it: each issues on the MUFU pipe (16 a clock per SM), twice the
// time of the bytes at hymba-1.5b's prefill.
//
// Two kernels; the C entry point takes the decode kernel when T = 1. Both
// split a channel's N states over N / 4 neighbouring lanes, 4 states a lane,
// and merge y's partial sums by xor shuffles 1 and 2 in fixed order, plus
// D x (tests/test_torch_ssm.py emulates the order).
//
// Prefill (T > 1), `ssm_scan_kernel`: a block of 320 threads covers 80
// channels (N 16; 160 of N 8) of one batch row, each lane holding its 4
// states and 4 values of -exp(A_log) log2(e) in registers: 4x the threads
// of the first version (one thread a channel). The first version loaded x
// and dt from device memory inside its step loop, a global-load latency on
// each of the T sequential steps; here the block stages N steps (a chunk)
// of x and dt (its channels) and of B_t, C_t with cp.async, 16- and 4-byte
// copies (plain loads where an address is not aligned for them, never on
// the model path), so no step waits on device memory. One barrier a
// chunk: after it, chunk c + 2 loads (three buffers), chunk c + 1's B_t and
// C_t are widened to float32 once for every channel (two buffers), and
// chunk c computes. The exponential is one MUFU ex2 of a log2(e)-scaled
// argument: the accurate expf spends 8 instructions on it, and took the
// kernel from 0.27 to 0.40 ms on the H100 (PERF.md); both hold the f32
// cases at 1e-4. At <= 32 registers, at least five blocks fit an SM, so
// hymba-1.5b's 16 rows x 40 blocks run in one wave. The TPU kernel's
// sequential time-chunk grid axis becomes the chunk loop; nothing is
// carried between blocks.
//
// Decode (T = 1), `ssm_step_kernel`: the step is bound by the state's bytes,
// so every state access is coalesced. One thread per (batch row, channel,
// group of 4 states): each lane reads its 4 states and its 4 A_log values as
// one 16-byte load (a warp covers 512 contiguous bytes of each) and stores
// its states back the same way; B_t and C_t are read by scalar loads
// through their strides (views of the x_proj output, with no alignment to
// count on). No shared memory and no barrier.
//
// Backward (`ssm_scan_bwd_kernel`, entry `ssm_scan_bwd`; JAX differentiates
// the lax.scan reference, repro/models/ssm.py::selective_scan, as the Pallas
// kernel is forward only; plain version
// repro_torch.hopper.ssm_scan.selective_scan_bwd_plain). With a_t =
// exp(-exp(A_log) dt_t) and G_t = dL/dh_t = dy_t C_t + a_{t+1} G_{t+1}
// (from the final state's gradient):
//
//   dC_t = sum_c h_t dy_t                 dB_t = sum_c G_t dt_t x_t
//   dx_t = dt_t (G_t . B_t) + D dy_t      dA_log = sum_{b,t} gA_t dt_t
//   ddt_t = x_t (G_t . B_t) + sum_n gA_t, gA_t = G_t h_{t-1} a_t (-exp A_log)
//   dD = sum_{b,t} dy_t x_t               dstate0 = a_1 G_1
//
// A block of 160 threads covers 40 channels of one row (80 at N 8), 4
// states a lane, and walks time in reverse. The states are never recovered
// by dividing by a decay (decays reach 1e-8): the state at every boundary
// of kBwdChunk steps is stored in a scratch buffer by the forward under
// autograd (ssm_scan_save_kernel, entry `ssm_scan_fwd_save`; the wrapper,
// given none, runs that kernel on a copy of the state first); the backward
// reloads a chunk's boundary state, recomputes the chunk's states h_t and
// decays a_t into shared memory (lane-major, each lane its own), so the
// reverse walk spends no exponential: one an element-step, where the first
// design spent three. x, dt, dy and B_t, C_t are staged a chunk ahead by
// cp.async (16- and 4-byte copies), one barrier a chunk before its walk
// and one after. Sums over channels (dB_t, dC_t): once step t is walked,
// each lane stores its 8 terms in the place of its h_t and a_t, and after
// the chunk the block sums each (step, n) over its channels in channel
// order, into one partial a block (the first design's warp reduce-scatter
// of xor shuffles issued a quarter of the walk's instructions); the sums
// over rows and steps (dA_log, dD) are per-row partials. The wrapper adds
// the partials with torch.sum in a fixed order: no float atomics, so two
// runs are bit-equal. What bounds it on the H100 is latency, not a pipe's
// rate: each step is a dependent chain (products, shuffles), so the warps
// an SM holds set the pace: 45 KB of shared memory a block and a launch
// bound of four blocks an SM (<= 102 registers, no spills; chip_variants.py
// times the alternatives, PERF.md).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro::tc::cp_async16;
using repro::tc::cp_async4;
using repro::tc::cp_async_commit;
using repro::tc::cp_async_wait;
using repro::tc::smem_addr;

constexpr int kScanThreads = 320;  // (row, channel, 4 states) per thread

// 2^x on the MUFU pipe (ex2.approx, flushing subnormal results to zero):
// exp(a dt) = 2^((a log2 e) dt), with a log2 e formed once per state
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int N>
struct ScanSmem {
  static constexpr int L = N / 4;                 // lanes a channel
  static constexpr int CB = kScanThreads / L;     // channels a block
  static constexpr int STEPS = N;                 // steps a chunk
  alignas(16) T xd[3][2][STEPS][CB];     // x, dt as loaded, 3 buffers
  alignas(16) T bc_raw[3][2][STEPS][N];  // B_t, C_t as loaded, 3 buffers
  alignas(16) float bc[2][2][STEPS][N];  // B_t, C_t widened, 2 buffers
};

// the backward's boundary interval: the state is kept every kBwdChunk steps
constexpr int kBwdChunk = 8;

// The prefill kernel's body; with SAVE (the forward under autograd) it also
// stores the state before every step t = kBwdChunk m, m >= 1, into ckpt
// (B, ceil(len / kBwdChunk) - 1, di, N): the boundaries the backward would
// otherwise recompute. Serving instantiates it without.
template <typename T, int N, bool SAVE>
__device__ __forceinline__ void scan_body(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A_log, const T* __restrict__ Bc,
    const T* __restrict__ Cc, const float* __restrict__ D,
    float* __restrict__ state, T* __restrict__ y, int len, int di, int b_sb,
    int b_st, int c_sb, int c_st, int xvec, int bcvec,
    float* __restrict__ ckpt) {
  using Sm = ScanSmem<T, N>;
  constexpr int L = Sm::L, CB = Sm::CB, STEPS = Sm::STEPS;
  static_assert(N % 4 == 0 && (L == 2 || L == 4), "N = 8 or 16");
  constexpr int E16 = 16 / sizeof(T), E4 = 4 / sizeof(T);
  __shared__ Sm sm;

  const int b = blockIdx.y, c0 = blockIdx.x * CB;
  const int tid = threadIdx.x, cl = tid / L, q = tid % L;
  const int c = c0 + cl;
  const bool live = c < di;
  const int nch = min(CB, di - c0);      // channels of this block

  float h[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
  float Dc = 0.f;
  float4* st = reinterpret_cast<float4*>(state) +
                ((size_t)b * di + (live ? c : 0)) * L + q;
  if (live) {
    const float4 h4 = *st;
    const float4 a4 = reinterpret_cast<const float4*>(A_log)[(size_t)c * L + q];
    h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
    a2[0] = -expf(a4.x) * repro::tc::kLog2e;
    a2[1] = -expf(a4.y) * repro::tc::kLog2e;
    a2[2] = -expf(a4.z) * repro::tc::kLog2e;
    a2[3] = -expf(a4.w) * repro::tc::kLog2e;
    Dc = D[c];
  }

  // chunk ch's x, dt, B_t, C_t into buffer buf. The loops run over a whole
  // chunk's index space (compile-time divisors), skipping the steps past
  // the end and the channels past di; the pointers are recomputed from the
  // kernel's parameters, so the step loop keeps its registers.
  auto stage = [&](int ch, int buf) {
    const int t0 = ch * STEPS, nt = min(STEPS, len - t0);
    const size_t xrow = ((size_t)b * len + t0) * di + c0;
    if (xvec) {                 // nch * sizeof(T) is a multiple of 16
      constexpr int PM = CB / E16;
      for (int i = tid; i < 2 * STEPS * PM; i += kScanThreads) {
        const int a = i / (STEPS * PM), s = i / PM % STEPS, pc = i % PM;
        if (s >= nt || pc * E16 >= nch) continue;
        cp_async16(smem_addr(&sm.xd[buf][a][s][pc * E16]),
                   (a ? dt : x) + xrow + (size_t)s * di + pc * E16, true);
      }
    } else {
      for (int i = tid; i < 2 * STEPS * CB; i += kScanThreads) {
        const int a = i / (STEPS * CB), s = i / CB % STEPS, e = i % CB;
        if (s >= nt || e >= nch) continue;
        sm.xd[buf][a][s][e] = (a ? dt : x)[xrow + (size_t)s * di + e];
      }
    }
    constexpr int PB = N / E4;
    for (int i = tid; i < 2 * STEPS * PB; i += kScanThreads) {
      const int a = i / (STEPS * PB), s = i / PB % STEPS, pc = i % PB;
      if (s >= nt) continue;
      const T* g = a ? Cc + (size_t)b * c_sb + (size_t)(t0 + s) * c_st
                     : Bc + (size_t)b * b_sb + (size_t)(t0 + s) * b_st;
      T* d = &sm.bc_raw[buf][a][s][pc * E4];
      if (bcvec) {              // 4-byte aligned views
        cp_async4(smem_addr(d), g + pc * E4, true);
      } else {
#pragma unroll
        for (int e = 0; e < E4; ++e) d[e] = g[pc * E4 + e];
      }
    }
  };
  // chunk ch's B_t, C_t widened once (they are read by every channel)
  auto widen = [&](int ch) {
    const int nt = min(STEPS, len - ch * STEPS);
    for (int i = tid; i < 2 * STEPS * N; i += kScanThreads) {
      const int a = i / (STEPS * N), s = i / N % STEPS, n = i % N;
      if (s < nt)
        sm.bc[ch & 1][a][s][n] = repro::to_f(sm.bc_raw[ch % 3][a][s][n]);
    }
  };

  // one barrier a chunk: after it, chunk ch + 2 loads, chunk ch + 1 is
  // widened and chunk ch computes, each from its own buffer
  const int nchunks = (len + STEPS - 1) / STEPS;
  T* yp = y + (size_t)b * len * di + c;   // y at (b, t, c), t advancing
  stage(0, 0);
  cp_async_commit();
  if (nchunks > 1) stage(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  widen(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch widened, ch + 1 landed, ch - 1 computed
    if (ch + 2 < nchunks) stage(ch + 2, (ch + 2) % 3);
    cp_async_commit();
    if (ch + 1 < nchunks) widen(ch + 1);
    const int nt = min(STEPS, len - ch * STEPS), xb = ch % 3, bb = ch & 1;
    for (int s = 0; s < nt; ++s, yp += di) {
      if constexpr (SAVE) {
        const int t = ch * STEPS + s;
        if (t > 0 && t % kBwdChunk == 0 && live) {
          const int nb = (len + kBwdChunk - 1) / kBwdChunk - 1;
          reinterpret_cast<float4*>(ckpt)[(((size_t)b * nb + t / kBwdChunk - 1)
                                           * di + c) * L + q] =
              make_float4(h[0], h[1], h[2], h[3]);
        }
      }
      const float xv = repro::to_f(sm.xd[xb][0][s][cl]);
      const float dv = repro::to_f(sm.xd[xb][1][s][cl]);
      const float4 b4 = reinterpret_cast<const float4*>(sm.bc[bb][0][s])[q];
      const float4 c4 = reinterpret_cast<const float4*>(sm.bc[bb][1][s])[q];
      const float bn[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cn[4] = {c4.x, c4.y, c4.z, c4.w};
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[k] = ex2(a2[k] * dv) * h[k] + dx * bn[k];
        acc += h[k] * cn[k];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (L == 4) acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && q == 0) *yp = repro::from_f<T>(acc + xv * Dc);
    }
  }
  if (live) *st = make_float4(h[0], h[1], h[2], h[3]);
}

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads, 5)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bc,
                const T* __restrict__ Cc, const float* __restrict__ D,
                float* __restrict__ state, T* __restrict__ y, int len,
                int di, int b_sb, int b_st, int c_sb, int c_st, int xvec,
                int bcvec) {
  scan_body<T, N, false>(x, dt, A_log, Bc, Cc, D, state, y, len, di, b_sb,
                         b_st, c_sb, c_st, xvec, bcvec, nullptr);
}

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads, 5)
ssm_scan_save_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A_log, const T* __restrict__ Bc,
                     const T* __restrict__ Cc, const float* __restrict__ D,
                     float* __restrict__ state, T* __restrict__ y, int len,
                     int di, int b_sb, int b_st, int c_sb, int c_st, int xvec,
                     int bcvec, float* __restrict__ ckpt) {
  scan_body<T, N, true>(x, dt, A_log, Bc, Cc, D, state, y, len, di, b_sb,
                        b_st, c_sb, c_st, xvec, bcvec, ckpt);
}

constexpr int kStepThreads = 256;  // (row, channel, 4 states) per thread

template <typename T, int N>
__global__ void __launch_bounds__(kStepThreads)
ssm_step_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bc,
                const T* __restrict__ Cc, const float* __restrict__ D,
                float* __restrict__ state, T* __restrict__ y, int B, int di,
                int b_sb, int c_sb) {
  constexpr int L = N / 4;  // lanes per channel
  static_assert(N % 4 == 0 && (L == 2 || L == 4), "N = 8 or 16");
  const long long g = (long long)blockIdx.x * kStepThreads + threadIdx.x;
  const bool live = g < (long long)B * di * L;
  const long long gg = live ? g : 0;
  const int q = (int)(gg % L);           // which 4 states of the channel
  const long long bc = gg / L;           // b * di + c: x, dt, y (T = 1)
  const int c = (int)(bc % di), b = (int)(bc / di);

  float4 h4 = make_float4(0.f, 0.f, 0.f, 0.f), a4 = h4;
  float xv = 0.f, dv = 0.f, Dc = 0.f, bn[4] = {}, cn[4] = {};
  if (live) {
    h4 = reinterpret_cast<const float4*>(state)[gg];
    a4 = reinterpret_cast<const float4*>(A_log)[(long long)c * L + q];
    xv = repro::to_f(x[bc]);
    dv = repro::to_f(dt[bc]);
    Dc = D[c];
    const T* bp = Bc + (size_t)b * b_sb + 4 * q;
    const T* cp = Cc + (size_t)b * c_sb + 4 * q;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bn[k] = repro::to_f(bp[k]);
      cn[k] = repro::to_f(cp[k]);
    }
  }
  float h[4] = {h4.x, h4.y, h4.z, h4.w};
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float dx = dv * xv;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float negA = -expf(a[k]);
    h[k] = expf(negA * dv) * h[k] + dx * bn[k];
    acc += h[k] * cn[k];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (L == 4) acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (live) {
    reinterpret_cast<float4*>(state)[gg] = make_float4(h[0], h[1], h[2], h[3]);
    if (q == 0) y[bc] = repro::from_f<T>(acc + xv * Dc);
  }
}

constexpr int kBwdThreads = 160;  // (row, channel, 4 states) a thread

// 4 consecutive elements of shared memory (16- or 8-byte aligned), widened
__device__ __forceinline__ void load_t4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load_t4(const __nv_bfloat16* p,
                                        float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(t.x << 16);
  o[1] = __uint_as_float(t.x & 0xffff0000u);
  o[2] = __uint_as_float(t.y << 16);
  o[3] = __uint_as_float(t.y & 0xffff0000u);
}
constexpr int kBwdMinBlocks = 4;  // blocks an SM

template <typename T, int N>
struct BwdSmem {
  static constexpr int L = N / 4;                 // lanes a channel
  static constexpr int CB = kBwdThreads / L;      // channels a block
  // h_t and a_t, each lane its own; once step t is walked, the lane's
  // terms of dB_t and dC_t in their place
  float4 hist[kBwdChunk][2][kBwdThreads];
  alignas(16) T xdd[2][3][kBwdChunk][CB];   // x, dt, dy as loaded, 2 buffers
  alignas(16) T bc[2][2][kBwdChunk][N];     // B_t, C_t as loaded, 2 buffers
};

// ckpt (B, ceil(len / K) - 1, di, N): the state before chunk ch >= 1, as
// ssm_scan_save_kernel stores it. A job is one chunk, from the last.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A_log, const T* __restrict__ Bc,
                    const T* __restrict__ Cc, const float* __restrict__ D,
                    const float* __restrict__ state0, const T* __restrict__ dy,
                    const float* __restrict__ dstate, T* __restrict__ dx,
                    T* __restrict__ ddt, float* __restrict__ pbc,
                    float* __restrict__ pA, float* __restrict__ pD,
                    float* __restrict__ ds0, const float* __restrict__ ckpt,
                    int len, int di, int b_sb, int b_st, int c_sb,
                    int c_st, int xvec, int bcvec) {
  using Sm = BwdSmem<T, N>;
  constexpr int L = Sm::L, CB = Sm::CB, K = kBwdChunk;
  constexpr int NT = kBwdThreads;
  constexpr int E16 = 16 / sizeof(T), E4 = 4 / sizeof(T);
  static_assert(N % 4 == 0 && (L == 2 || L == 4), "N = 8 or 16");
  static_assert((CB * sizeof(T)) % 16 == 0, "blocks of whole 16-byte pieces");
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);

  const int blk = blockIdx.x, b = blockIdx.y, nrows = gridDim.y;
  const int c0 = blk * CB;
  const int tid = threadIdx.x, cl = tid / L, q = tid % L;
  const int c = c0 + cl;
  const bool live = c < di;
  const int nch = min(CB, di - c0);                 // channels of this block
  const int nchk = (len + K - 1) / K;
  const size_t lq = ((size_t)b * di + (live ? c : 0)) * L + q;  // float4s

  float negA[4] = {}, a2[4] = {}, h[4] = {}, g[4] = {};
  float Dc = 0.f;
  if (live) {
    const float4 a4 = reinterpret_cast<const float4*>(A_log)[(size_t)c * L + q];
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      negA[k] = -expf(av[k]);
      a2[k] = negA[k] * repro::tc::kLog2e;
    }
    const float4 h4 = reinterpret_cast<const float4*>(state0)[lq];
    h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
    if (dstate != nullptr) {
      const float4 g4 = reinterpret_cast<const float4*>(dstate)[lq];
      g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
    }
    Dc = D[c];
  }

  // job j: chunk nchk - 1 - j; x, dt, dy, B_t and C_t into buffer j & 1 by
  // cp.async (plain loads where the addresses are not aligned for it)
  auto stage = [&](int j) {
    const int ch = nchk - 1 - j, t0 = ch * K, nt = min(K, len - t0);
    const int buf = j & 1;
    const size_t xrow = ((size_t)b * len + t0) * di + c0;
    if (xvec) {                 // nch * sizeof(T) is a multiple of 16
      constexpr int PM = CB / E16;
      for (int i = tid; i < 3 * K * PM; i += NT) {
        const int a = i / (K * PM), s = i / PM % K, pc = i % PM;
        if (s >= nt || pc * E16 >= nch) continue;
        cp_async16(smem_addr(&sm.xdd[buf][a][s][pc * E16]),
                   (a == 0 ? x : a == 1 ? dt : dy) + xrow + (size_t)s * di
                       + pc * E16, true);
      }
    } else {
      for (int i = tid; i < 3 * K * CB; i += NT) {
        const int a = i / (K * CB), s = i / CB % K, e = i % CB;
        if (s >= nt || e >= nch) continue;
        sm.xdd[buf][a][s][e] =
            (a == 0 ? x : a == 1 ? dt : dy)[xrow + (size_t)s * di + e];
      }
    }
    constexpr int PB = N / E4;
    for (int i = tid; i < 2 * K * PB; i += NT) {
      const int a = i / (K * PB), s = i / PB % K, pc = i % PB;
      if (s >= nt) continue;
      const T* p = a ? Cc + (size_t)b * c_sb + (size_t)(t0 + s) * c_st
                     : Bc + (size_t)b * b_sb + (size_t)(t0 + s) * b_st;
      T* d = &sm.bc[buf][a][s][pc * E4];
      if (bcvec) {              // 4-byte aligned views
        cp_async4(smem_addr(d), p + pc * E4, true);
      } else {
#pragma unroll
        for (int e = 0; e < E4; ++e) d[e] = p[pc * E4 + e];
      }
    }
  };
  // the block's dB_t, dC_t of chunk ch: its channels' terms in channel
  // order (lane q of channel cl holds states 4 q .. 4 q + 3)
  auto block_sum = [&](int ch) {
    const int t0 = ch * K, nt = min(K, len - t0);
    for (int i = tid; i < nt * 2 * N; i += NT) {
      const int s = i / (2 * N), a = i / N % 2, n = i % N;
      const float* v = reinterpret_cast<const float*>(&sm.hist[s][a][0]) + n;
      float acc = v[0];
      for (int e = 1; e < CB; ++e) acc += v[e * N];
      pbc[((((size_t)blk * nrows + b) * len + t0 + s) * 2 + a) * N + n] = acc;
    }
  };
  const float4* ck = reinterpret_cast<const float4*>(ckpt);
  auto ck_at = [&](int ch) {   // the boundary state before chunk ch >= 1
    return (((size_t)b * (nchk - 1) + ch - 1) * di + c) * L + q;
  };

  // one barrier a job: after it job j's inputs have landed and job j + 1's
  // load; a second after the reverse walk, before the chunk's sums
  float dA[4] = {0.f, 0.f, 0.f, 0.f}, dD = 0.f;
  // the boundary state of the next chunk, loaded a chunk ahead
  float4 hb = make_float4(h[0], h[1], h[2], h[3]);
  if (nchk > 1 && live) hb = ck[ck_at(nchk - 1)];
  stage(0);
  cp_async_commit();
  for (int j = 0; j < nchk; ++j) {
    const int ch = nchk - 1 - j, buf = j & 1;
    const int t0 = ch * K, nt = min(K, len - t0);
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nchk) stage(j + 1);
    cp_async_commit();
    // the chunk's states h_t and decays a_t from its boundary state, into
    // shared memory (each lane its own): the reverse walk spends no
    // exponential
    const float4 hc = hb;
    if (ch > 0 && live)
      hb = ch == 1 ? reinterpret_cast<const float4*>(state0)[lq]
                   : ck[ck_at(ch - 1)];
    {
      float hh[4] = {hc.x, hc.y, hc.z, hc.w};
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s >= nt) break;
        const float xv = live ? repro::to_f(sm.xdd[buf][0][s][cl]) : 0.f;
        const float dv = live ? repro::to_f(sm.xdd[buf][1][s][cl]) : 0.f;
        float bn[4], av[4];
        load_t4(&sm.bc[buf][0][s][4 * q], bn);
        const float dx_ = dv * xv;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          av[k] = ex2(a2[k] * dv);
          hh[k] = av[k] * hh[k] + dx_ * bn[k];
        }
        sm.hist[s][0][tid] = make_float4(hh[0], hh[1], hh[2], hh[3]);
        sm.hist[s][1][tid] = make_float4(av[0], av[1], av[2], av[3]);
      }
    }
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      if (s >= nt) continue;                      // uniform over the block
      const float xv = live ? repro::to_f(sm.xdd[buf][0][s][cl]) : 0.f;
      const float dtv = live ? repro::to_f(sm.xdd[buf][1][s][cl]) : 0.f;
      const float dyv = live ? repro::to_f(sm.xdd[buf][2][s][cl]) : 0.f;
      // the states after steps s - 1 and s, and step s's decays
      const float4 p4 = s ? sm.hist[s ? s - 1 : 0][0][tid] : hc;
      const float4 n4 = sm.hist[s][0][tid];
      const float4 a4 = sm.hist[s][1][tid];
      const float hp[4] = {p4.x, p4.y, p4.z, p4.w};
      const float hn[4] = {n4.x, n4.y, n4.z, n4.w};
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bn[4], cn[4];
      load_t4(&sm.bc[buf][0][s][4 * q], bn);
      load_t4(&sm.bc[buf][1][s][4 * q], cn);
      float G[4], pbv[4], pcv[4], gA[4];
      float gb = 0.f, sA = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        G[k] = fmaf(dyv, cn[k], g[k]);
        pcv[k] = hn[k] * dyv;
        pbv[k] = G[k] * (dtv * xv);
        gb = fmaf(G[k], bn[k], gb);
        gA[k] = G[k] * hp[k] * a[k] * negA[k];
        sA += gA[k];
        dA[k] = fmaf(gA[k], dtv, dA[k]);
        g[k] = a[k] * G[k];
      }
      gb += __shfl_xor_sync(0xffffffffu, gb, 1);
      sA += __shfl_xor_sync(0xffffffffu, sA, 1);
      if (L == 4) {
        gb += __shfl_xor_sync(0xffffffffu, gb, 2);
        sA += __shfl_xor_sync(0xffffffffu, sA, 2);
      }
      if (live && q == 0) {
        const size_t o = ((size_t)b * len + t0 + s) * di + c;
        dx[o] = repro::from_f<T>(fmaf(dtv, gb, Dc * dyv));
        ddt[o] = repro::from_f<T>(fmaf(xv, gb, sA));
        dD = fmaf(dyv, xv, dD);
      }
      // this step's h_t and a_t are read: its terms of dB_t, dC_t go there
      sm.hist[s][0][tid] = make_float4(pbv[0], pbv[1], pbv[2], pbv[3]);
      sm.hist[s][1][tid] = make_float4(pcv[0], pcv[1], pcv[2], pcv[3]);
    }
    __syncthreads();
    block_sum(ch);
  }
  if (live) {
    reinterpret_cast<float4*>(ds0)[lq] = make_float4(g[0], g[1], g[2], g[3]);
    reinterpret_cast<float4*>(pA)[lq] = make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (q == 0) pD[(size_t)b * di + c] = dD;
  }
}

template <typename T, int N>
int launch_bwd(const void* x, const void* dt, const void* A_log,
               const void* Bc, const void* Cc, const void* D,
               const void* state0, const void* dy, const void* dstate,
               void* dx, void* ddt, void* pbc, void* pA, void* pD, void* ds0,
               const void* ckpt, int B, int len, int di, int b_sb, int b_st,
               int c_sb, int c_st, cudaStream_t s) {
  constexpr int CB = BwdSmem<T, N>::CB;
  constexpr int kSmem = sizeof(BwdSmem<T, N>);
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // x, dt, dy: 16-byte copies when every row and block of channels is
  // 16-byte aligned; B, C: 4-byte copies when the views are 4-byte aligned
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(dt) |
                       reinterpret_cast<uintptr_t>(dy);
  const bool xvec = (xa % 16) == 0 && (di * sizeof(T)) % 16 == 0;
  const uintptr_t ba =
      reinterpret_cast<uintptr_t>(Bc) | reinterpret_cast<uintptr_t>(Cc);
  const bool bcvec = (ba % 4) == 0 &&
                     ((size_t)(b_sb | b_st | c_sb | c_st) * sizeof(T)) % 4 == 0;
  dim3 grid((di + CB - 1) / CB, B);
  ssm_scan_bwd_kernel<T, N><<<grid, kBwdThreads, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<const float*>(state0), static_cast<const T*>(dy),
      static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<T*>(ddt), static_cast<float*>(pbc),
      static_cast<float*>(pA), static_cast<float*>(pD),
      static_cast<float*>(ds0), static_cast<const float*>(ckpt), len, di,
      b_sb, b_st, c_sb, c_st, xvec, bcvec);
  return 0;
}

template <typename T>
int dispatch_bwd(int N, const void* x, const void* dt, const void* A_log,
                 const void* Bc, const void* Cc, const void* D,
                 const void* state0, const void* dy, const void* dstate,
                 void* dx, void* ddt, void* pbc, void* pA, void* pD,
                 void* ds0, const void* ckpt, int B, int len, int di,
                 int b_sb, int b_st, int c_sb, int c_st, cudaStream_t s) {
  switch (N) {
    case 8: return launch_bwd<T, 8>(x, dt, A_log, Bc, Cc, D, state0, dy, dstate, dx, ddt, pbc, pA, pD, ds0, ckpt, B, len, di, b_sb, b_st, c_sb, c_st, s);
    case 16: return launch_bwd<T, 16>(x, dt, A_log, Bc, Cc, D, state0, dy, dstate, dx, ddt, pbc, pA, pD, ds0, ckpt, B, len, di, b_sb, b_st, c_sb, c_st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int N>
void launch(const void* x, const void* dt, const void* A_log, const void* Bc,
            const void* Cc, const void* D, void* state, void* y, int B,
            int len, int di, int b_sb, int b_st, int c_sb, int c_st,
            bool decode, float* ckpt, cudaStream_t s) {
  if (decode) {
    const long long threads = (long long)B * di * (N / 4);
    ssm_step_kernel<T, N><<<(unsigned)((threads + kStepThreads - 1) / kStepThreads),
                            kStepThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A_log), static_cast<const T*>(Bc),
        static_cast<const T*>(Cc), static_cast<const float*>(D),
        static_cast<float*>(state), static_cast<T*>(y), B, di, b_sb, c_sb);
    return;
  }
  // x, dt: 16-byte copies when every row and block of channels is
  // 16-byte aligned; B, C: 4-byte copies when the views are 4-byte aligned
  constexpr int CB = ScanSmem<T, N>::CB;
  const uintptr_t xa =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt);
  const bool xvec = (xa % 16) == 0 && (di * sizeof(T)) % 16 == 0;
  const uintptr_t ba =
      reinterpret_cast<uintptr_t>(Bc) | reinterpret_cast<uintptr_t>(Cc);
  const bool bcvec = (ba % 4) == 0 &&
                     ((size_t)(b_sb | b_st | c_sb | c_st) * sizeof(T)) % 4 == 0;
  static_assert((CB * sizeof(T)) % 16 == 0, "blocks of whole 16-byte pieces");
  dim3 grid((di + CB - 1) / CB, B);
  if (ckpt != nullptr) {
    ssm_scan_save_kernel<T, N><<<grid, kScanThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A_log), static_cast<const T*>(Bc),
        static_cast<const T*>(Cc), static_cast<const float*>(D),
        static_cast<float*>(state), static_cast<T*>(y), len, di, b_sb, b_st,
        c_sb, c_st, xvec, bcvec, ckpt);
    return;
  }
  ssm_scan_kernel<T, N><<<grid, kScanThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<float*>(state), static_cast<T*>(y), len, di, b_sb, b_st,
      c_sb, c_st, xvec, bcvec);
}

template <typename T>
bool dispatch_n(int N, const void* x, const void* dt, const void* A_log,
                const void* Bc, const void* Cc, const void* D, void* state,
                void* y, int B, int len, int di, int b_sb, int b_st, int c_sb,
                int c_st, bool decode, float* ckpt, cudaStream_t s) {
  switch (N) {
    case 8: launch<T, 8>(x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, ckpt, s); return true;
    case 16: launch<T, 16>(x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, ckpt, s); return true;
    default: return false;
  }
}

}  // namespace

// prefill_only: run the prefill kernel at T = 1 too (tests and
// chip_smoke.py compare the two kernels); otherwise T = 1 takes the decode
// kernel. Both kernels read the state and A_log 16 bytes at a time: both
// 16-byte aligned.
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A_log,
                            const void* Bc, const void* Cc, const void* D,
                            void* state, void* y, int B, int len, int di,
                            int N, int b_sb, int b_st, int c_sb, int c_st,
                            int dtype, int prefill_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool decode = len == 1 && !prefill_only;
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_n<__nv_bfloat16>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, nullptr, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_n<float>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, nullptr, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The forward under autograd: the prefill kernel at any len, storing the
// backward's boundary states into ckpt (B, ceil(len / chunk) - 1, di, N)
// f32, 16-byte aligned, as ssm_scan_bwd reads them.
extern "C" int ssm_scan_fwd_save(const void* x, const void* dt,
                                 const void* A_log, const void* Bc,
                                 const void* Cc, const void* D, void* state,
                                 void* y, void* ckpt, int B, int len, int di,
                                 int N, int b_sb, int b_st, int c_sb,
                                 int c_st, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ck = static_cast<float*>(ckpt);
  if (ck == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_n<__nv_bfloat16>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, false, ck, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_n<float>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, false, ck, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The backward's chunk length (the boundary interval): the wrapper sizes
// the boundary states by it. *smem, when not null, gets the dynamic shared
// memory the kernel launches with for N and dtype (chip_smoke.py records
// it), or -1.
extern "C" int ssm_scan_bwd_chunk(int N, int dtype, int* smem) {
  if (smem) {
    const bool bf16 = dtype == repro::kBFloat16;
    switch (N) {
      case 8: *smem = bf16 ? sizeof(BwdSmem<__nv_bfloat16, 8>) : sizeof(BwdSmem<float, 8>); break;
      case 16: *smem = bf16 ? sizeof(BwdSmem<__nv_bfloat16, 16>) : sizeof(BwdSmem<float, 16>); break;
      default: *smem = -1;
    }
  }
  return kBwdChunk;
}

// The channels a block of the backward covers at state size N: the
// wrapper sizes the per-block partials of dB and dC by it.
extern "C" int ssm_scan_bwd_channels(int N) {
  return N == 8 ? BwdSmem<float, 8>::CB : BwdSmem<float, 16>::CB;
}

// The backward: every pointer as the wrapper allocates it (dstate may be
// null: a zero gradient of the final state); the partials are summed by the
// wrapper. ckpt: the boundary states ssm_scan_fwd_save stored, null only
// when len fits in one chunk. state0, dstate, ds0, ckpt and A_log are read
// 16 bytes at a time.
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A_log,
                            const void* Bc, const void* Cc, const void* D,
                            const void* state0, const void* dy,
                            const void* dstate, void* dx, void* ddt,
                            void* pbc, void* pA, void* pD, void* ds0,
                            const void* ckpt, int B, int len, int di, int N,
                            int b_sb, int b_st, int c_sb, int c_st, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1 || (ckpt == nullptr && len > kBwdChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kBFloat16)
    err = dispatch_bwd<__nv_bfloat16>(N, x, dt, A_log, Bc, Cc, D, state0, dy, dstate, dx, ddt, pbc, pA, pD, ds0, ckpt, B, len, di, b_sb, b_st, c_sb, c_st, s);
  else if (dtype == repro::kFloat32)
    err = dispatch_bwd<float>(N, x, dt, A_log, Bc, Cc, D, state0, dy, dstate, dx, ddt, pbc, pA, pD, ds0, ckpt, B, len, di, b_sb, b_st, c_sb, c_st, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
