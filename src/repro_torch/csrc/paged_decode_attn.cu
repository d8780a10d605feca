// Single-token decode attention over the paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_decode_attn/paged_decode_attn.py::
//   paged_decode_attention_kernel (body `_kernel`), wrapper
//   `ops.paged_decode_attention`.
// Plain reference: repro_torch.hopper.paged_decode_attn.
// paged_decode_attention_plain (paged_gather_kv, then decode_attention — the
// Pallas kernel's oracle `ref.paged_decode_attention`).
//
// Layout: the MODEL's page pools (NP, ps, KV, hd), one per layer, read in
// place. The Pallas wrapper transposes them to (NP, KV, ps, hd) on every call;
// here a position's row for one kv head is hd contiguous elements at
// ((page * ps + offset) * KV + g) * hd, so no copy of the pool is ever made.
// The block table is (B, max_pages) int32; an entry outside [0, NP) is the
// sentinel of an unmapped page. q and out are (B, 1, H, hd).
//
// One block per (chunk of 128 positions, kv head, row), with the merge of a
// row's chunk partials in the same launch: decode_common.cuh's loop, shared
// with the dense kernel, so on the same live K/V the two give the same bits.
// The TPU kernel's sequential page grid axis becomes the chunk grid axis:
// only the chunks over [max(0, cache_len - window), cache_len) do work, each
// looking its positions' pages up in the row's block table, so the bytes read
// grow with sum(min(cache_len, window)), never with NP or max_pages. A sentinel
// entry is never dereferenced: inside the live range it reads as zeros, as
// paged_gather_kv fills it (the allocator never produces one there); the Pallas
// kernel clamps it to NP - 1 for its DMA instead.
//
// What bounds it on the H100: memory, as for the dense kernel — ~REP
// multiply-adds per live cache byte. It takes the dense kernel's head sizes
// and GQA ratios, split into the same head groups.
#include "decode_common.cuh"

namespace {

// Element offset of a position's row through the block table row `bt`.
struct PagedRows {
  const int* bt;
  int num_pages, shift, mask;  // page_size = 1 << shift
  long long stride, head;      // KV * HD; g * HD
  __device__ __forceinline__ long long operator()(int pos) const {
    const int page = __ldg(bt + (pos >> shift));
    if (page < 0 || page >= num_pages) return -1;
    return ((((long long)page) << shift) + (pos & mask)) * stride + head;
  }
};

template <typename T, int HD, int RG>
__global__ void __launch_bounds__(repro::kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lens, T* __restrict__ o, int NP,
                    int shift, int max_pages, int KV, int NG, int window,
                    float softcap, float scale, repro::DecodeSplit ws) {
  const int REP = RG * NG;  // NG: groups of RG query heads per kv head
  const int g = blockIdx.y / NG;
  const int gi = blockIdx.y % NG;
  const int b = blockIdx.z;
  const int len = min(lens[b], max_pages << shift);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const PagedRows rows{bt + (size_t)b * max_pages, NP, shift,
                       (1 << shift) - 1, (long long)KV * HD,
                       (long long)g * HD};
  const size_t head = ((size_t)b * KV * REP + g * REP + gi * RG) * HD;
  const int pair = b * KV + g;
  repro::decode_attend<T, HD, RG>(
      q + head, kp, vp, rows, lo, len, softcap, scale, o + head, ws,
      pair * NG + gi, (size_t)pair * ws.chunks * REP + gi * RG, REP);
}

struct Args {
  const void *q, *k, *v;
  const int *bt, *lens;
  void* o;
  int B, NP, shift, max_pages, KV, NG, window;
  float softcap, scale;
  repro::DecodeSplit ws;
  cudaStream_t stream;
};

template <typename T, int HD, int RG>
void launch(const Args& a) {
  dim3 grid(a.ws.chunks, a.KV * a.NG, a.B);
  paged_decode_kernel<T, HD, RG><<<grid, repro::kDecodeWarps * 32, 0,
                                   a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bt, a.lens, static_cast<T*>(a.o), a.NP,
      a.shift, a.max_pages, a.KV, a.NG, a.window, a.softcap, a.scale, a.ws);
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

// ws, ws_floats, tickets: the split workspace, as decode_attn_fwd's
extern "C" int paged_decode_attn_fwd(const void* q, const void* k_pool,
                                     const void* v_pool,
                                     const void* block_table,
                                     const void* cache_len, void* o, void* ws,
                                     long long ws_floats, void* tickets,
                                     int B, int NP, int page_size,
                                     int max_pages, int H, int KV, int hd,
                                     int window, float softcap, float scale,
                                     int dtype, void* stream) {
  int shift = -1;
  if (page_size == 8) shift = 3;
  else if (page_size == 16) shift = 4;
  else if (page_size == 32) shift = 5;
  if (shift < 0 || KV < 1 || H % KV != 0 || max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = ((max_pages << shift) + repro::kDecodeChunk - 1) /
                     repro::kDecodeChunk;
  const long long slots = (long long)B * H * chunks;
  if (ws_floats < slots * (hd + 2)) return static_cast<int>(cudaErrorInvalidValue);
  float* acc = static_cast<float*>(ws);
  const repro::DecodeSplit split{acc, reinterpret_cast<float2*>(acc + slots * hd),
                                 static_cast<int*>(tickets), chunks};
  const int rep = H / KV, rg = repro::decode_group(rep);
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_table),
               static_cast<const int*>(cache_len), o, B, NP, shift,
               max_pages, KV, rep / rg, window, softcap, scale, split,
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
