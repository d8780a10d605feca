// Fused top-k / top-p sampling with an in-kernel threefry Gumbel draw, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_sample/fused_sample.py::fused_sample_rows_kernel
//   (body `_sample_kernel`, helpers `_threefry2x32`, `_sortable`,
//   `_histogram`, `_mass_above`).
// Plain reference: repro_torch.sampling.sampler.sample_rows, itself the port
// of repro.sampling.sampler.sample_rows. Per row: l = logits / temperature;
// the exact k-th largest value (ties kept) and the top-p threshold (the
// smallest value whose strictly-higher softmax mass is < p) are found with a
// radix select over the order-preserving uint32 encoding of f32, without a
// full-vocab sort; then one pass draws argmax(l + Gumbel) over the kept set
// and the kept-set logsumexp for the token's log-probability.
//
// Random bits: jax's PARTITIONABLE threefry layout (jax_threefry_partitionable
// = True): bits[i] = y0 ^ y1 with (y0, y1) = threefry2x32(key, (0, i)). The
// Pallas kernel's `_gumbel_bits` rebuilds the older non-partitionable layout
// and is deliberately not copied. The bits -> uniform(tiny, 1) -> -log(-log u)
// transform is jax.random.gumbel's, bit for bit; logf is the accurate libm
// version (no fast-math), as torch's own CUDA log is.
//
// What bounds it on the H100: memory traffic per row. A row is V f32 logits
// (~500 KB at V = 128256), read once from device memory and re-read from the
// 50 MB L2 by the later phases (2 passes without truncation, 6 with top-k or
// top-p, 10 with both); the arithmetic is a few dozen integer operations per
// element for the threefry draw. The design is one 1024-thread block per row,
// streaming the row with consecutive threads on consecutive elements in every
// phase. Radix histograms use integer shared-memory atomics (counts for top-k,
// 2^-40 fixed-point softmax mass for top-p) so the thresholds do not depend
// on the order in which threads add: the same row always gives the same
// token. Eight copies of each histogram spread the atomics of 32 warps.
// Greedy (temperature <= 0) is an argmax pass with logp 0.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int NT = 1024;     // threads per block (one block per row)
constexpr int NWARP = NT / 32;
constexpr int NCOPY = 8;     // histogram copies (warp w uses copy w % NCOPY)
constexpr float kMassScale = 1099511627776.0f;  // 2^40 fixed-point mass

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax's threefry2x32 (20 rounds, key injection every 4 rounds).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float gumbel(uint32_t k0, uint32_t k1, int i) {
  const uint2 y = threefry2x32(k0, k1, 0u, (uint32_t)i);
  const uint32_t bits = y.x ^ y.y;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  // jax: f * (1 - tiny) + tiny, where 1 - tiny rounds to 1 in f32
  const float u = fmaxf(FLT_MIN, f + FLT_MIN);
  return -logf(-logf(u));
}

__device__ __forceinline__ uint32_t sortable(float x) {
  const uint32_t s = __float_as_uint(x);
  return (s >> 31) ? ~s : (s | 0x80000000u);
}

__device__ __forceinline__ float unsortable(uint32_t s) {
  return __uint_as_float((s & 0x80000000u) ? (s ^ 0x80000000u) : ~s);
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NWARP ? red[lane] : -INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;  // every thread holds the block max
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NWARP ? red[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (value, index) argmax; ties go to the lower index, as jnp/torch argmax.
__device__ __forceinline__ void argmax_pair(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void block_argmax(float& v, int& i, float* redv,
                                             int* redi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_pair(v, i, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  v = lane < NWARP ? redv[lane] : -INFINITY;
  i = lane < NWARP ? redi[lane] : 0x7fffffff;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_pair(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(NT)
sample_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ logits,
              int32_t* __restrict__ tok_out, float* __restrict__ logp_out, int V,
              float temperature, int top_k, float top_p, int greedy) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const float* x = logits + (size_t)row * V;

  __shared__ float redf[NWARP];
  __shared__ int redi[NWARP];
  __shared__ unsigned int cnt[NCOPY][256];
  __shared__ unsigned long long mass[NCOPY][256];
  __shared__ uint32_t sh_prefix;
  __shared__ int sh_rem;
  __shared__ unsigned long long sh_above;
  __shared__ double sh_target;

  if (greedy) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < V; i += NT) argmax_pair(bv, bi, x[i], i);
    block_argmax(bv, bi, redf, redi);
    if (tid == 0) {
      tok_out[row] = bi;
      logp_out[row] = 0.f;
    }
    return;
  }

  // phase 1: row max of the tempered logits (the softmax reference point)
  float mx = -INFINITY;
  for (int i = tid; i < V; i += NT) mx = fmaxf(mx, x[i] / temperature);
  mx = block_max(mx, redf);

  float tau = -INFINITY;  // kept set: l >= tau

  // phase 2: exact k-th largest value by a 4 x 8-bit radix select on counts
  if (top_k > 0 && top_k < V) {
    if (tid == 0) {
      sh_prefix = 0u;
      sh_rem = top_k;
    }
    for (int lvl = 0; lvl < 4; ++lvl) {
      const int shift = 24 - 8 * lvl;
      for (int e = tid; e < NCOPY * 256; e += NT) (&cnt[0][0])[e] = 0u;
      __syncthreads();
      const uint32_t prefix = sh_prefix;
      unsigned int* h = cnt[warp % NCOPY];
      for (int i = tid; i < V; i += NT) {
        const uint32_t u = sortable(x[i] / temperature);
        if (lvl == 0 || (u >> (shift + 8)) == prefix)
          atomicAdd(&h[(u >> shift) & 0xFFu], 1u);
      }
      __syncthreads();
      if (tid < 256) {
        unsigned int c = 0;
        for (int cp = 0; cp < NCOPY; ++cp) c += cnt[cp][tid];
        cnt[0][tid] = c;
      }
      __syncthreads();
      if (tid == 0) {
        // the k-th largest lives in the bin whose strictly-above count is
        // < rem <= inclusive count
        const int rem = sh_rem;
        unsigned int above = 0;
        int pick = 0;
        for (int bin = 255; bin >= 0; --bin) {
          const unsigned int c = cnt[0][bin];
          if ((int)above < rem && (int)(above + c) >= rem) {
            pick = bin;
            break;
          }
          above += c;
        }
        sh_rem = rem - (int)above;
        sh_prefix = (prefix << 8) | (uint32_t)pick;
      }
      __syncthreads();
    }
    tau = unsortable(sh_prefix);
  }

  // phase 3: top-p threshold by a radix descent on fixed-point softmax mass
  // over the top-k survivors: the smallest value v with mass(l > v) < p * Z
  if (top_p < 1.0f) {
    if (tid == 0) {
      sh_prefix = 0u;
      sh_above = 0ull;
    }
    for (int lvl = 0; lvl < 4; ++lvl) {
      const int shift = 24 - 8 * lvl;
      for (int e = tid; e < NCOPY * 256; e += NT) (&mass[0][0])[e] = 0ull;
      __syncthreads();
      const uint32_t prefix = sh_prefix;
      unsigned long long* h = mass[warp % NCOPY];
      for (int i = tid; i < V; i += NT) {
        const float l = x[i] / temperature;
        if (l < tau) continue;
        const uint32_t u = sortable(l);
        if (lvl == 0 || (u >> (shift + 8)) == prefix) {
          const unsigned long long w =
              __float2ull_rn(expf(l - mx) * kMassScale);
          atomicAdd(&h[(u >> shift) & 0xFFu], w);
        }
      }
      __syncthreads();
      if (tid < 256) {
        unsigned long long c = 0;
        for (int cp = 0; cp < NCOPY; ++cp) c += mass[cp][tid];
        mass[0][tid] = c;
      }
      __syncthreads();
      if (tid == 0) {
        if (lvl == 0) {
          unsigned long long z = 0;
          for (int bin = 0; bin < 256; ++bin) z += mass[0][bin];
          sh_target = (double)top_p * (double)z;
        }
        const unsigned long long am = sh_above;
        const double target = sh_target;
        unsigned long long above = 0, pick_above = 0;
        int pick = -1;
        // walk bins from the highest value down while the mass strictly
        // above the bin stays below target; keep the lowest non-empty one
        for (int bin = 255; bin >= 0; --bin) {
          if ((double)(am + above) >= target) break;
          const unsigned long long c = mass[0][bin];
          if (c > 0) {
            pick = bin;
            pick_above = above;
          }
          above += c;
        }
        if (pick < 0) pick = 0;  // unreachable for top_p > 0
        sh_above = am + pick_above;
        sh_prefix = (prefix << 8) | (uint32_t)pick;
      }
      __syncthreads();
    }
    tau = fmaxf(tau, unsortable(sh_prefix));
  }

  // phase 4: Gumbel-max draw over the kept set + kept-set logsumexp
  const uint32_t k0 = keys[2 * row], k1 = keys[2 * row + 1];
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  float sum = 0.f;
  for (int i = tid; i < V; i += NT) {
    const float l = x[i] / temperature;
    if (l >= tau) {
      argmax_pair(bv, bi, l + gumbel(k0, k1, i), i);
      sum += expf(l - mx);
    }
  }
  block_argmax(bv, bi, redf, redi);
  __syncthreads();
  sum = block_sum(sum, redf);
  if (tid == 0) {
    tok_out[row] = bi;
    logp_out[row] = (x[bi] / temperature - mx) - logf(sum);
  }
}

}  // namespace

extern "C" int fused_sample_rows(const void* keys, const void* logits,
                                 void* tok, void* logp, int R, int V,
                                 float temperature, int top_k, float top_p,
                                 int greedy, void* stream) {
  if (R <= 0) return 0;
  sample_kernel<<<R, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(logits),
      static_cast<int32_t*>(tok), static_cast<float*>(logp), V, temperature,
      top_k, top_p, greedy);
  return static_cast<int>(cudaGetLastError());
}
