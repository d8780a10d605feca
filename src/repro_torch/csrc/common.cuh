// Small device helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface (see repro_torch/hopper/build.py); the C entry
// points launch on the caller's stream and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked scores use the reference's finite NEG_INF (models/attention.py).
constexpr float kNegInf = -1e30f;

// dtype codes passed from the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widens 16 loaded bytes (VEC = 16 / sizeof(T) elements) to float.
template <typename T, int VEC>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[VEC]) {
  static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

// Loads 16 bytes (VEC = 16 / sizeof(T) elements) and widens them to float.
// The address must be 16-byte aligned; the wrappers check the base pointers.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec16(const T* p, float (&out)[VEC]) {
  unpack16<T, VEC>(*reinterpret_cast<const uint4*>(p), out);
}

}  // namespace repro
