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
// weigh about as much as those bytes, so the two bounds are close.
//
// Two kernels; the C entry point takes the decode kernel when T = 1.
//
// Prefill (T > 1): one thread per (batch row, channel) holds its N states and
// its N values of -exp(A_log) in registers; a block of 128 threads covers 128
// channels of one row, so x, dt and y accesses are coalesced across the warp.
// B_t and C_t (N values shared by every channel of the row) are staged in
// shared memory for kSteps steps at a time, so a block synchronises twice per
// kSteps steps and not per step. The TPU kernel's sequential time-chunk grid
// axis becomes this loop; nothing is carried between blocks.
//
// Decode (T = 1): the step is bound by the state's bytes, so every state
// access is coalesced. One thread per (batch row, channel, group of 4
// states): the N / 4 lanes of a channel are neighbours in a warp, each reads
// its 4 states and its 4 A_log values as one 16-byte load (a warp covers 512
// contiguous bytes of each) and stores its states back the same way; B_t and
// C_t are read by scalar loads through their strides (views of the x_proj
// output, with no alignment to count on). y is the lanes' partial sums over
// their 4 states merged by xor shuffles 1 and 2 in fixed order, plus D x.
// No shared memory and no barrier; 4x the threads of the prefill kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kSteps = 32;     // time steps of B_t, C_t staged per sync

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bc,
                const T* __restrict__ Cc, const float* __restrict__ D,
                float* __restrict__ state, T* __restrict__ y, int len,
                int di, int b_sb, int b_st, int c_sb, int c_st) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < di;

  __shared__ float bs[kSteps][N];
  __shared__ float cs[kSteps][N];

  float h[N];
  float negA[N];
  float Dc = 0.f;
  float* st = state + ((size_t)b * di + (live ? c : 0)) * N;
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      negA[n] = -expf(A_log[(size_t)c * N + n]);
      h[n] = st[n];
    }
    Dc = D[c];
  }
  const size_t row = (size_t)b * len * di;
  const T* bb = Bc + (size_t)b * b_sb;
  const T* cb = Cc + (size_t)b * c_sb;

  for (int t0 = 0; t0 < len; t0 += kSteps) {
    const int nt = min(kSteps, len - t0);
    __syncthreads();  // the previous chunk's reads of bs / cs are done
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int s = i / N, n = i % N;
      bs[s][n] = repro::to_f(bb[(size_t)(t0 + s) * b_st + n]);
      cs[s][n] = repro::to_f(cb[(size_t)(t0 + s) * c_st + n]);
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < nt; ++s) {
      const size_t off = row + (size_t)(t0 + s) * di + c;
      const float xv = repro::to_f(x[off]);
      const float dv = repro::to_f(dt[off]);
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(negA[n] * dv) * h[n] + dx * bs[s][n];
        acc += h[n] * cs[s][n];
      }
      y[off] = repro::from_f<T>(acc + xv * Dc);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) st[n] = h[n];
  }
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
  dim3 grid((di + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(D),
      static_cast<float*>(state), static_cast<T*>(y), len, di, b_sb, b_st,
      c_sb, c_st);
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

// prefill_only: run the prefill kernel at T = 1 too (a test compares the
// two kernels); otherwise T = 1 takes the decode kernel. The decode kernel
// reads the state and A_log 16 bytes at a time: both 16-byte aligned.
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
