// Single-token decode attention over the dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attn/decode_attn.py::decode_attention_kernel
//   (body `_kernel`).
// Plain reference: repro_torch.models.attention.decode_attention. One query
// token per row attends to cache positions [lo, cache_len), lo = cache_len -
// window for sliding-window layers and 0 otherwise; the query heads of a
// block's head group (REP = H / KV up to 5; a wider ratio as REP / RG groups
// over the grid, e.g. REP 7 as 7 groups of 1, REP 8, 16 and 48 as groups of
// 4) share every K/V element the block loads. Head sizes 32, 64, 128, 256
// (any other raises) and any integer REP.
//
// Layout: the MODEL's cache layout (B, L, KV, hd) — the one
// models/attention.py writes — not the Pallas kernel's (B, KV, L, hd), so the
// cache is read in place with no transpose. q and out are (B, 1, H, hd).
//
// What bounds it on the H100: memory. Each live cache byte is used for ~REP
// multiply-adds, far below the ~295 operations per byte at which the card
// stops being memory-bound, so the kernel reads each live cache byte once
// and the bytes moved scale with sum(cache_len), not pool * max_len. At the
// serve pool of 16 rows a grid of one block per (kv head, row) is only 80
// (hymba, KV = 5) to 128 (llama, KV = 8) blocks on 132 SMs, each walking up
// to 640 positions in dependent steps: latency, not bytes, set the time. So
// the grid is split over the cache length as well (flash-decoding): one block
// of 8 warps per (chunk of 128 positions, kv head, row), 400-640 blocks at
// max_len 640, of which those over the live range each wait for one round
// trip of loads; the merge of a row's chunk partials rides in the same
// launch (decode_common.cuh, shared with the paged kernel). Chunks of 32 to
// 256 positions under 2 to 16 warps timed within a few percent of one
// another at the serve shapes (NVIDIA H100 80GB HBM3, 700 W): the time is a
// fixed dependent chain, not the grid's shape.
#include "decode_common.cuh"

namespace {

// Element offset of a position's row: the cache is (B, L, KV, HD).
struct DenseRows {
  long long base, stride;  // row b, kv head g; one position
  __device__ __forceinline__ long long operator()(int pos) const {
    return base + pos * stride;
  }
};

template <typename T, int HD, int RG>
__global__ void __launch_bounds__(repro::kDecodeWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lens,
              T* __restrict__ o, int L, int KV, int NG, int window,
              float softcap, float scale, repro::DecodeSplit ws) {
  const int REP = RG * NG;  // NG: groups of RG query heads per kv head
  const int g = blockIdx.y / NG;
  const int gi = blockIdx.y % NG;
  const int b = blockIdx.z;
  const int len = min(lens[b], L);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const long long stride = (long long)KV * HD;
  const DenseRows rows{(long long)b * L * stride + (long long)g * HD, stride};
  const size_t head = ((size_t)b * KV * REP + g * REP + gi * RG) * HD;
  const int pair = b * KV + g;
  repro::decode_attend<T, HD, RG>(
      q + head, kc, vc, rows, lo, len, softcap, scale, o + head, ws,
      pair * NG + gi, (size_t)pair * ws.chunks * REP + gi * RG, REP);
}

struct Args {
  const void *q, *k, *v;
  const int* lens;
  void* o;
  int B, L, KV, NG, window;
  float softcap, scale;
  repro::DecodeSplit ws;
  cudaStream_t stream;
};

template <typename T, int HD, int RG>
void launch(const Args& a) {
  dim3 grid(a.ws.chunks, a.KV * a.NG, a.B);
  decode_kernel<T, HD, RG><<<grid, repro::kDecodeWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, static_cast<T*>(a.o), a.L, a.KV,
      a.NG, a.window, a.softcap, a.scale, a.ws);
}

// one instantiation per head-group size RG; a.NG groups per kv head
template <typename T, int HD>
bool dispatch_group(int rg, const Args& a) {
  switch (rg) {
    case 1: launch<T, HD, 1>(a); return true;
    case 2: launch<T, HD, 2>(a); return true;
    case 3: launch<T, HD, 3>(a); return true;
    case 4: launch<T, HD, 4>(a); return true;
    case 5: launch<T, HD, 5>(a); return true;
    default: return false;
  }
}

}  // namespace

// ws: the split workspace, ws_floats float32 (acc, then (max, sum) pairs);
// tickets: B * H int32 counters (one per row, kv head and head group),
// zero between calls (decode_common.cuh)
extern "C" int decode_attn_fwd(const void* q, const void* k_cache,
                               const void* v_cache, const void* cache_len,
                               void* o, void* ws, long long ws_floats,
                               void* tickets, int B, int L, int H, int KV,
                               int hd, int window, float softcap, float scale,
                               int dtype, void* stream) {
  if (KV < 1 || H % KV != 0 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (L + repro::kDecodeChunk - 1) / repro::kDecodeChunk;
  const long long slots = (long long)B * H * chunks;
  if (ws_floats < slots * (hd + 2)) return static_cast<int>(cudaErrorInvalidValue);
  float* acc = static_cast<float*>(ws);
  const repro::DecodeSplit split{acc, reinterpret_cast<float2*>(acc + slots * hd),
                                 static_cast<int*>(tickets), chunks};
  const int rep = H / KV, rg = repro::decode_group(rep);
  const Args a{q, k_cache, v_cache, static_cast<const int*>(cache_len), o, B,
               L, KV, rep / rg, window, softcap, scale, split,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (dtype == repro::kBFloat16) {
    switch (hd) {
      case 32: ok = dispatch_group<__nv_bfloat16, 32>(rg, a); break;
      case 64: ok = dispatch_group<__nv_bfloat16, 64>(rg, a); break;
      case 128: ok = dispatch_group<__nv_bfloat16, 128>(rg, a); break;
      case 256: ok = dispatch_group<__nv_bfloat16, 256>(rg, a); break;
    }
  } else if (dtype == repro::kFloat32) {
    switch (hd) {
      case 32: ok = dispatch_group<float, 32>(rg, a); break;
      case 64: ok = dispatch_group<float, 64>(rg, a); break;
      case 128: ok = dispatch_group<float, 128>(rg, a); break;
      case 256: ok = dispatch_group<float, 256>(rg, a); break;
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
