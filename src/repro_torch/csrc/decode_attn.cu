// Single-token decode attention over the dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attn/decode_attn.py::decode_attention_kernel
//   (body `_kernel`).
// Plain reference: repro_torch.models.attention.decode_attention. One query
// token per row attends to cache positions [lo, cache_len), lo = cache_len -
// window for sliding-window layers and 0 otherwise; the REP = H / KV query
// heads of a GQA group share every K/V element the block loads.
//
// Layout: the MODEL's cache layout (B, L, KV, hd) — the one
// models/attention.py writes — not the Pallas kernel's (B, KV, L, hd), so the
// cache is read in place with no transpose. q and out are (B, 1, H, hd).
//
// What bounds it on the H100: memory. Each live cache byte is used for ~REP
// multiply-adds, far below the ~295 operations per byte at which the card
// stops being memory-bound. The design therefore reads each live cache byte
// exactly once: one block per (kv head, row), looping only up to cache_len, so
// the bytes moved scale with sum(cache_len), not pool * max_len. The loop
// itself (16-byte loads, two positions in flight per thread, online softmax,
// warp and block combines) is decode_common.cuh's, shared with the paged
// kernel. At the main path's pool of 16 and KV = 8 heads this is 128 blocks on
// 132 SMs; no split over the length axis is used in this version (a split with
// a second combine pass is the next step when the pool is smaller).
#include "decode_common.cuh"

namespace {

// Element offset of a position's row: the cache is (B, L, KV, HD).
struct DenseRows {
  long long base, stride;  // row b, kv head g; one position
  __device__ __forceinline__ long long operator()(int pos) const {
    return base + pos * stride;
  }
};

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(repro::kDecodeWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lens,
              T* __restrict__ o, int L, int KV, int window, float softcap,
              float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(lens[b], L);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const long long stride = (long long)KV * HD;
  const DenseRows rows{(long long)b * L * stride + (long long)g * HD, stride};
  const size_t head = ((size_t)b * KV * REP + g * REP) * HD;
  repro::decode_attend<T, HD, REP>(q + head, kc, vc, rows, lo, len, softcap,
                                   scale, o + head);
}

template <typename T, int HD, int REP>
void launch(const void* q, const void* k, const void* v, const int* lens,
            void* o, int B, int L, int KV, int window, float softcap,
            float scale, cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<T, HD, REP><<<grid, repro::kDecodeWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), L, KV, window,
      softcap, scale);
}

template <typename T, int HD>
bool dispatch_rep(int rep, const void* q, const void* k, const void* v,
                  const int* lens, void* o, int B, int L, int KV, int window,
                  float softcap, float scale, cudaStream_t s) {
  switch (rep) {
    case 1: launch<T, HD, 1>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 2: launch<T, HD, 2>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 3: launch<T, HD, 3>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 4: launch<T, HD, 4>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    case 5: launch<T, HD, 5>(q, k, v, lens, o, B, L, KV, window, softcap, scale, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" int decode_attn_fwd(const void* q, const void* k_cache,
                               const void* v_cache, const void* cache_len,
                               void* o, int B, int L, int H, int KV, int hd,
                               int window, float softcap, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(cache_len);
  const int rep = H / KV;
  bool ok = false;
  if (dtype == repro::kBFloat16 && hd == 64)
    ok = dispatch_rep<__nv_bfloat16, 64>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 64)
    ok = dispatch_rep<float, 64>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kBFloat16 && hd == 32)
    ok = dispatch_rep<__nv_bfloat16, 32>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  else if (dtype == repro::kFloat32 && hd == 32)
    ok = dispatch_rep<float, 32>(rep, q, k_cache, v_cache, lens, o, B, L, KV, window, softcap, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
