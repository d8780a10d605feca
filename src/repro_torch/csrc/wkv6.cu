// WKV6 recurrence (the RWKV6 "Finch" time-mix core) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/rwkv6_scan.py::wkv6_bh
//   (body `_kernel`, wrapper `ops.wkv6`).
// Plain reference: repro_torch.hopper.rwkv6_scan.wkv6_plain, the copy of
// repro/models/rwkv6.py::wkv6_scan. Per batch row b and head h, with the
// (hd, hd) f32 state S (row i = key index, column j = value index):
//
//   y_t[j]   = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Layout: the MODEL's (B, T, H, hd) for r, k, v, w and y, read in place with
// its strides: the Pallas wrapper transposes all five to (B*H, T, hd) and
// back, which on the card would be two extra copies of each per layer. u is
// (H, hd) f32; the state (B, H, hd, hd) f32 is read once and written back in
// place.
//
// What bounds it on the H100: at decode (T = 1) the bytes of the state, read
// and written once per step (B * H * hd * hd * 8 bytes), against ~6
// operations per state element. At prefill the state stays in registers and
// the bytes are r, k, v, w and y; the 6 * B * T * H * hd * hd operations
// then bound it at the float32 rate.
//
// Design: one block per (head, batch row) with hd threads; thread j owns
// column j of S in hd registers, so the update needs no reduction across
// threads. r_t, k_t and w_t (hd values each, read by every thread) are
// staged in shared memory for kSteps steps at a time, 24 KB at any hd, and
// every thread of a warp then reads the same element (a broadcast); v_t[j]
// and y_t[j] are one coalesced element per thread. The TPU kernel's
// sequential time-chunk grid axis becomes the loop over t.
#include "common.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            T* __restrict__ y, int len, int H) {
  constexpr int kSteps = 2048 / HD;  // steps staged per sync: 24 KB of smem
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;

  __shared__ float rs[kSteps][HD];
  __shared__ float ks[kSteps][HD];
  __shared__ float ws[kSteps][HD];
  __shared__ float us[HD];

  us[j] = u[(size_t)h * HD + j];
  float S[HD];
  float* st = state + (size_t)(b * H + h) * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = st[(size_t)i * HD + j];

  const size_t tstride = (size_t)H * HD;
  const size_t base = (size_t)b * len * tstride + (size_t)h * HD + j;

  for (int t0 = 0; t0 < len; t0 += kSteps) {
    const int nt = min(kSteps, len - t0);
    __syncthreads();  // the previous chunk's reads (and us[]) are settled
    for (int s = 0; s < nt; ++s) {
      const size_t off = base + (size_t)(t0 + s) * tstride;
      rs[s][j] = repro::to_f(r[off]);
      ks[s][j] = repro::to_f(k[off]);
      ws[s][j] = repro::to_f(w[off]);
    }
    __syncthreads();
    for (int s = 0; s < nt; ++s) {
      const size_t off = base + (size_t)(t0 + s) * tstride;
      const float vj = repro::to_f(v[off]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[s][i] * vj;
        acc += rs[s][i] * (S[i] + us[i] * kv);
        S[i] = ws[s][i] * S[i] + kv;
      }
      y[off] = repro::from_f<T>(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) st[(size_t)i * HD + j] = S[i];
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* state, void* y, int B, int len, int H,
            cudaStream_t s) {
  dim3 grid(H, B);
  wkv6_kernel<T, HD><<<grid, HD, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<T*>(y), len, H);
}

template <typename T>
bool dispatch_hd(int hd, const void* r, const void* k, const void* v,
                 const void* w, const void* u, void* state, void* y, int B,
                 int len, int H, cudaStream_t s) {
  switch (hd) {
    case 16: launch<T, 16>(r, k, v, w, u, state, y, B, len, H, s); return true;
    case 32: launch<T, 32>(r, k, v, w, u, state, y, B, len, H, s); return true;
    case 64: launch<T, 64>(r, k, v, w, u, state, y, B, len, H, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* state, void* y,
                        int B, int len, int H, int hd, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == repro::kBFloat16)
    ok = dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, state, y, B, len, H, s);
  else if (dtype == repro::kFloat32)
    ok = dispatch_hd<float>(hd, r, k, v, w, u, state, y, B, len, H, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
