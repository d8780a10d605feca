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

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads, 5)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bc,
                const T* __restrict__ Cc, const float* __restrict__ D,
                float* __restrict__ state, T* __restrict__ y, int len,
                int di, int b_sb, int b_st, int c_sb, int c_st, int xvec,
                int bcvec) {
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

template <typename T, int N>
void launch(const void* x, const void* dt, const void* A_log, const void* Bc,
            const void* Cc, const void* D, void* state, void* y, int B,
            int len, int di, int b_sb, int b_st, int c_sb, int c_st,
            bool decode, cudaStream_t s) {
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
                int c_st, bool decode, cudaStream_t s) {
  switch (N) {
    case 8: launch<T, 8>(x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, s); return true;
    case 16: launch<T, 16>(x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, s); return true;
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
    ok = dispatch_n<__nv_bfloat16>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_n<float>(N, x, dt, A_log, Bc, Cc, D, state, y, B, len, di, b_sb, b_st, c_sb, c_st, decode, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
