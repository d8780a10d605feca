// Fused top-k / top-p sampling with an in-kernel threefry Gumbel draw, for
// Hopper (sm_90a): one thread-block cluster per row.
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
// What bounds it on the H100. With top-k or top-p (the serve configuration):
// the bytes, one read of the row's V f32 logits. Untruncated (the train
// configuration, temperature 1): the threefry draw for every element, some
// 70 32-bit integer instructions each (20 rounds of add, rotate and xor,
// five key injections, the bits-to-float steps) at 64 integer results per
// clock per SM: at 16 rows of 128256 that is about four times the byte
// bound, and it needs every SM of the card. The kernel this replaces ran
// one 1024-thread block per row: 16 of 132 SMs at the serve pool, re-reading
// and re-dividing the row from L2 in every pass.
//
// Design: one cluster of C blocks per row (the wrapper takes the largest C
// of 16, 8, 7, 6, 4, 2, 1 whose R clusters the card holds at once). Block r
// owns the r-th slice of ceil(V / C) elements: it reads its logits from
// device memory once, divides them by the temperature once (__fdiv_rn, IEEE
// as the plain version's division) and keeps them in dynamic shared memory,
// so every later pass reads shared memory. The row max is a cluster max
// through distributed shared memory (DSMEM). Top-k's level-0 counts are
// taken in the same pass as the load. Each radix level is a 256-bin
// histogram per block (counts for top-k, 2^-40 fixed-point softmax mass for
// top-p); a warp merges the lanes that hit the same bin first
// (__match_any_sync: the leader adds the popcount or the group's sum), and
// level 0's counts go to 8 copies, because the top levels of f32 logits
// fall into a handful of bins. After one cluster.sync() per level
// (histograms double-buffered) every block reads the C histograms through
// DSMEM and computes the same pick with one warp's suffix scan, so nothing
// is broadcast; the sums are integers, so no threshold depends on timing.
// After level 0 each block lists its elements at or above the chosen bin;
// the later levels, top-p and the draw read only that list. After level 1,
// when at most 64 elements of the row lie at or above the chosen bin (top-k
// 50 almost always), the blocks gather them and one warp sorts them and
// finishes top-k and top-p exactly, in place of six more levels. Each block
// then draws over its kept elements (Gumbel-max, ties to the lower index)
// and sums their mass in 2^-40 units; rank 0 merges the C results and
// writes the token and logp. Every sum is an integer sum, so a row gives the
// same token and logp whatever the order of lists and blocks. Greedy
// (temperature <= 0) is an argmax over the raw logits with logp 0.
//
// A block serves the remote reads of DSMEM one at a time, so every merge
// spreads them over the reading block's threads and no step has many lanes
// read one remote word.
#include <cfloat>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoBin = 0xffffffffu;
constexpr int NT = 1024;     // threads per block (one block per SM)
constexpr int kUnroll = 8;  // loads in flight per thread while filling a slice
constexpr int kMaxCluster = 16;
constexpr int kCopies = 8;      // copies of the level-0 count histogram
constexpr int kListCap = 2048;  // slice indices a block lists per list
constexpr int kGather = 64;     // the most candidates one warp sorts
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

// (value, index) argmax; ties go to the lower index, as jnp/torch argmax.
__device__ __forceinline__ void argmax_pair(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : -INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;  // every thread holds the block max
}

__device__ __forceinline__ void block_argmax(float& v, int& i, float* redv,
                                             int* redi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    argmax_pair(v, i, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  v = lane < NT / 32 ? redv[lane] : -INFINITY;
  i = lane < NT / 32 ? redi[lane] : INT_MAX;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    argmax_pair(v, i, ov, oi);
  }
}

// A block's static shared memory; the other blocks of the cluster read its
// histograms and its results through distributed shared memory.
struct Shared {
  unsigned int cnt0[kCopies][256];    // level-0 top-k counts, per copy
  unsigned int cnt[2][256];           // top-k counts, double-buffered
  unsigned long long mass[2][256];    // top-p 2^-40 masses, double-buffered
  unsigned int cnt_all[256];          // the cluster's merged level
  unsigned long long mass_all[256];
  unsigned long long part[4][256];    // a merge's partial sums
  float redf[32];
  int redi[32];
  unsigned long long redu[32];
  float bmax, bval, mx;               // this block's max, argmax; the row's
  int bidx;
  unsigned long long bsum;            // this block's kept mass, 2^-40 units
  uint32_t kprefix, pprefix;          // radix prefixes found so far
  int krem;                           // top-k rank left inside the prefix
  unsigned long long pabove;          // top-p mass above the prefix
  double ptarget;                     // top_p * total kept mass
  int nlist[2];
  int list[2][kListCap];              // slice indices the later passes read
  int kcnt;                           // count in the top-k bin just picked
  int gn;                             // this block's gathered candidates
  float gv[kGather];
  float tau;
};

// The elements a pass reads: the whole slice (list == nullptr) or the
// listed slice indices.
struct Elems {
  const int* list;
  int m;
  __device__ __forceinline__ int at(int t) const { return list ? list[t] : t; }
};

// Lists the elements j of `src` with pred(sl[j]) in list `which`, in no
// fixed order (every sum the kernel takes is an integer sum); the whole
// slice if more than kListCap qualify.
template <typename Pred>
__device__ __forceinline__ Elems list_elems(const float* sl, int n, Elems src,
                                            Pred pred, Shared& sm, int which) {
  const int lane = threadIdx.x & 31;
  int* list = sm.list[which];
  if (threadIdx.x == 0) sm.nlist[which] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < src.m; t0 += NT) {
    const int t = t0 + threadIdx.x;
    const int j = t < src.m ? src.at(t) : 0;
    const bool p = t < src.m && pred(sl[j]);
    const unsigned ball = __ballot_sync(kFull, p);
    if (ball == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&sm.nlist[which], __popc(ball));
    base = __shfl_sync(kFull, base, 0) + __popc(ball & ((1u << lane) - 1));
    if (p && base < kListCap) list[base] = j;
  }
  __syncthreads();
  const int m = sm.nlist[which];
  return m <= kListCap ? Elems{list, m} : Elems{nullptr, n};
}

// Adds 1 to h[bin] for each lane whose bin is not kNoBin: one atomic per
// distinct bin of the warp, its lanes' popcount.
__device__ __forceinline__ void warp_count(unsigned* h, uint32_t bin);

// List A, in the pass after top-k's level 0: the slice indices j whose top
// byte is at or above level 0's bin `top` (in no fixed order), and the
// level-1 counts of those in that bin, into h; the whole slice if more than
// kListCap qualify.
__device__ __forceinline__ Elems list_top(const float* sl, int n,
                                          uint32_t top, unsigned* h,
                                          Shared& sm) {
  const int lane = threadIdx.x & 31;
  int* list = sm.list[0];
  if (threadIdx.x == 0) sm.nlist[0] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const uint32_t u = j < n ? sortable(sl[j]) : 0u;
    const bool p = j < n && (u >> 24) >= top;
    const unsigned ball = __ballot_sync(kFull, p);
    if (ball == 0) continue;
    warp_count(h, p && (u >> 24) == top ? (u >> 16) & 0xFFu : kNoBin);
    int base = 0;
    if (lane == 0) base = atomicAdd(&sm.nlist[0], __popc(ball));
    base = __shfl_sync(kFull, base, 0) + __popc(ball & ((1u << lane) - 1));
    if (p && base < kListCap) list[base] = j;
  }
  __syncthreads();
  const int m = sm.nlist[0];
  return m <= kListCap ? Elems{list, m} : Elems{nullptr, n};
}

__device__ __forceinline__ void warp_count(unsigned* h, uint32_t bin) {
  if (__ballot_sync(kFull, bin != kNoBin) == 0) return;
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin != kNoBin && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], (unsigned)__popc(peers));
}

// Level `lvl` (1-3) histogram of top-k counts over the elements `e`.
__device__ __forceinline__ void hist_counts(const float* sl, Elems e, int lvl,
                                            uint32_t prefix, unsigned* h) {
  const int shift = 24 - 8 * lvl;
  for (int t0 = 0; t0 < e.m; t0 += NT) {
    const int t = t0 + threadIdx.x;
    uint32_t bin = kNoBin;
    if (t < e.m) {
      const uint32_t u = sortable(sl[e.at(t)]);
      if ((u >> (shift + 8)) == prefix) bin = (u >> shift) & 0xFFu;
    }
    warp_count(h, bin);
  }
}

// Level `lvl` histogram of fixed-point softmax mass over the kept (l >= tau)
// elements among `e`. A mass is at most 2^40, so each group of lanes sums
// its 20-bit low and high halves as 32-bit integers, exactly.
__device__ __forceinline__ void hist_mass(const float* sl, Elems e, int lvl,
                                          uint32_t prefix, float tau,
                                          float mx, unsigned long long* h) {
  const int lane = threadIdx.x & 31, shift = 24 - 8 * lvl;
  for (int t0 = 0; t0 < e.m; t0 += NT) {
    const int t = t0 + threadIdx.x;
    uint32_t bin = kNoBin;
    unsigned long long w = 0ull;
    if (t < e.m) {
      const float l = sl[e.at(t)];
      const uint32_t u = sortable(l);
      if (l >= tau && (lvl == 0 || (u >> (shift + 8)) == prefix)) {
        bin = (u >> shift) & 0xFFu;
        w = __float2ull_rn(expf(l - mx) * kMassScale);
      }
    }
    if (__ballot_sync(kFull, bin != kNoBin) == 0) continue;
    const unsigned peers = __match_any_sync(kFull, bin);
    const unsigned lo = __reduce_add_sync(peers, (unsigned)(w & 0xFFFFFull));
    const unsigned hi = __reduce_add_sync(peers, (unsigned)(w >> 20));
    if (bin != kNoBin && lane == __ffs(peers) - 1)
      atomicAdd(&h[bin], ((unsigned long long)hi << 20) + lo);
  }
}

// The cluster's histogram of one level, bin t summed over the C blocks:
// the 4 groups of 256 threads each read every 4th rank (all their remote
// reads in flight at once), then 256 threads add the groups' partial sums.
// Integers: the order fixes nothing but the reads.
template <typename U>
__device__ __forceinline__ void merge_level(cg::cluster_group& cl, U* mine,
                                            U* all, Shared& sm, int C) {
  constexpr int G = NT / 256;
  const int bin = threadIdx.x & 255, grp = threadIdx.x >> 8;
  U v[kMaxCluster / G];
#pragma unroll
  for (int k = 0; k < kMaxCluster / G; ++k) {
    const int r = grp + k * G;
    v[k] = r < C ? cl.map_shared_rank(mine, r)[bin] : U(0);
  }
  U s = 0;
#pragma unroll
  for (int k = 0; k < kMaxCluster / G; ++k) s += v[k];
  U* part = reinterpret_cast<U*>(&sm.part[0][0]);
  part[grp * 256 + bin] = s;
  __syncthreads();
  if (threadIdx.x < 256) {
    U t = 0;
#pragma unroll
    for (int q = 0; q < G; ++q) t += part[q * 256 + bin];
    all[bin] = t;
  }
}

// Warp 0 of rank 0, lane r reading rank r's results (one remote read a
// lane: a block serves its remote reads one at a time): the cluster's
// (value, index) argmax, ties to the lower index, and its kept mass.
__device__ __forceinline__ void merge_results(cg::cluster_group& cl,
                                              Shared& sm, int C, float& v,
                                              int& i,
                                              unsigned long long& z) {
  const int lane = threadIdx.x & 31;
  const Shared* o = cl.map_shared_rank(&sm, lane < C ? lane : 0);
  v = lane < C ? o->bval : -INFINITY;
  i = lane < C ? o->bidx : INT_MAX;
  z = lane < C ? o->bsum : 0ull;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    argmax_pair(v, i, ov, oi);
    z += __shfl_xor_sync(kFull, z, off);
  }
}

__device__ __forceinline__ unsigned long long block_sum_u64(
    unsigned long long x, unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : 0ull;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Warp 0: the bin of the krem-th largest element, the highest bin whose
// count at or above it reaches krem. Lane l scans bins 8l .. 8l + 7.
__device__ __forceinline__ void pick_count(Shared& sm) {
  const int lane = threadIdx.x & 31;
  unsigned c[8], tot = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) tot += c[k] = sm.cnt_all[8 * lane + k];
  unsigned suf = tot;  // count in this lane's bins and every lane above
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_down_sync(kFull, suf, off);
    if (lane + off < 32) suf += t;
  }
  const int rem = sm.krem;
  unsigned s = suf - tot;
  int pick = -1;
  unsigned pick_above = 0;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const unsigned above = s;
    s += c[k];
    if (pick < 0 && (int)s >= rem) {
      pick = 8 * lane + k;
      pick_above = above;
    }
  }
  const int best = __reduce_max_sync(kFull, pick);
  __syncwarp();
  if (best < 0) {  // unreachable for 0 < top_k < V
    if (lane == 0) {
      sm.krem = rem - (int)suf;
      sm.kprefix <<= 8;
    }
  } else if (pick == best) {
    sm.krem = rem - (int)pick_above;
    sm.kprefix = (sm.kprefix << 8) | (uint32_t)best;
    sm.kcnt = (int)c[best & 7];
  }
}

// Warp 0: the top-p bin, the lowest non-empty bin whose mass strictly above
// it (within the prefix, plus the mass above the prefix) is below the
// target; level 0 also sets the target, top_p times the total kept mass.
__device__ __forceinline__ void pick_mass(Shared& sm, int lvl, float top_p) {
  const int lane = threadIdx.x & 31;
  unsigned long long m[8], tot = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) tot += m[k] = sm.mass_all[8 * lane + k];
  unsigned long long suf = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long t = __shfl_down_sync(kFull, suf, off);
    if (lane + off < 32) suf += t;
  }
  const double target = lvl == 0
      ? (double)top_p * (double)__shfl_sync(kFull, suf, 0) : sm.ptarget;
  const unsigned long long am = sm.pabove;
  unsigned long long s = suf - tot, pick_above = 0;
  unsigned pick = 256;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    if ((double)(am + s) < target && m[k] > 0) {
      pick = 8 * lane + k;
      pick_above = s;
    }
    s += m[k];
  }
  const unsigned best = __reduce_min_sync(kFull, pick);
  __syncwarp();
  if (lvl == 0 && lane == 0) sm.ptarget = target;
  if (best == 256) {  // unreachable for top_p > 0
    if (lane == 0) sm.pprefix <<= 8;
  } else if (pick == best) {
    sm.pabove = am + pick_above;
    sm.pprefix = (sm.pprefix << 8) | best;
  }
}

// Warp 0: the thresholds from the at most kGather candidates of the row
// that the blocks gathered (every element at or above the top-k bin), read
// through distributed shared memory and sorted (bitonic, two a lane): tau
// is the top_k-th largest; with top-p, the smallest value among those at or
// above it whose strictly-higher 2^-40 mass is below top_p times their
// total, as the radix levels find it. Writes sm.tau.
__device__ __forceinline__ void gather_select(cg::cluster_group& cl,
                                              Shared& sm, int C, int top_k,
                                              float top_p, float mx) {
  const int lane = threadIdx.x & 31;
  const int cnt = lane < C ? cl.map_shared_rank(&sm, lane)->gn : 0;
  int off = cnt;  // inclusive scan of the blocks' counts, in rank order
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, off, d);
    if (lane >= d) off += t;
  }
  off -= cnt;
  int owner[2] = {-1, -1}, at[2] = {0, 0};  // each slot's rank and index
  for (int r = 0; r < C; ++r) {
    const int o = __shfl_sync(kFull, off, r), c = __shfl_sync(kFull, cnt, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = 2 * lane + h;
      if (slot >= o && slot < o + c) {
        owner[h] = r;
        at[h] = slot - o;
      }
    }
  }
  uint32_t key[2];  // sortable keys; 0 sorts below every value
#pragma unroll
  for (int h = 0; h < 2; ++h)  // both remote reads in flight at once
    key[h] = owner[h] < 0
        ? 0u : sortable(cl.map_shared_rank(&sm, owner[h])->gv[at[h]]);
  for (int k = 2; k <= 2 * 32; k <<= 1) {  // descending bitonic sort
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {
        const bool desc = ((2 * lane) & k) == 0;
        if (desc ? key[0] < key[1] : key[0] > key[1]) {
          const uint32_t t = key[0];
          key[0] = key[1];
          key[1] = t;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * lane + h;
          const uint32_t other = __shfl_xor_sync(kFull, key[h], j >> 1);
          const bool low = (i & j) == 0, desc = (i & k) == 0;
          key[h] = low == desc ? max(key[h], other) : min(key[h], other);
        }
      }
    }
  }
  // position 2 lane + h holds the (2 lane + h)-th largest
  const int kth = top_k - 1;
  const uint32_t kkey = __shfl_sync(kFull, key[kth & 1], kth >> 1);
  uint32_t tkey = kkey;
  if (top_p < 1.0f) {
    unsigned long long w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = key[h] >= kkey
          ? __float2ull_rn(expf(unsortable(key[h]) - mx) * kMassScale) : 0ull;
    unsigned long long inc = w[0] + w[1];  // inclusive scan over positions
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += t;
    }
    const unsigned long long ex0 = inc - w[0] - w[1], ex1 = ex0 + w[0];
    const double target =
        (double)top_p * (double)__shfl_sync(kFull, inc, 31);
    const uint32_t prev = __shfl_up_sync(kFull, key[1], 1);
    // a value qualifies at the first position of its run of ties, where
    // the mass before it is the mass strictly above it
    const bool q0 = key[0] >= kkey && (lane == 0 || key[0] != prev) &&
                    (double)ex0 < target;
    const bool q1 = key[1] >= kkey && key[1] != key[0] &&
                    (double)ex1 < target;
    const int best = __reduce_max_sync(kFull, q1 ? 2 * lane + 1
                                                 : q0 ? 2 * lane : -1);
    tkey = __shfl_sync(kFull, key[best & 1], best >> 1);
  }
  if (lane == 0) sm.tau = unsortable(tkey);
}

__global__ void __launch_bounds__(NT, 1)
sample_kernel(const uint32_t* __restrict__ keys,
              const float* __restrict__ logits, int32_t* __restrict__ tok_out,
              float* __restrict__ logp_out, int V, int S, float temperature,
              int top_k, float top_p, int greedy) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = rank * S;
  const int n = max(0, min(S, V - start));  // this block's slice
  const float* xr = logits + (size_t)row * V;
  extern __shared__ float sl[];  // the slice, tempered
  __shared__ Shared sm;

  if (greedy) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < n; j += NT) argmax_pair(bv, bi, xr[start + j], start + j);
    block_argmax(bv, bi, sm.redf, sm.redi);
    if (tid == 0) {
      sm.bval = bv;
      sm.bidx = bi;
      sm.bsum = 0ull;
    }
    cl.sync();
    if (rank == 0 && tid < 32) {
      float v;
      int i;
      unsigned long long z;
      merge_results(cl, sm, C, v, i, z);
      if (tid == 0) {
        tok_out[row] = i;
        logp_out[row] = 0.f;
      }
    }
    cl.sync();  // no block leaves while rank 0 reads its shared memory
    return;
  }

  const bool by_k = top_k > 0 && top_k < V;
  for (int e = tid; e < kCopies * 256; e += NT) (&sm.cnt0[0][0])[e] = 0u;
  for (int e = tid; e < 2 * 256; e += NT) {
    (&sm.cnt[0][0])[e] = 0u;
    (&sm.mass[0][0])[e] = 0ull;
  }
  if (tid == 0) {
    sm.kprefix = sm.pprefix = 0u;
    sm.krem = top_k;
    sm.pabove = 0ull;
  }
  __syncthreads();

  // the slice: one read from device memory, one division; with top-k, the
  // level-0 counts in the same pass (warp w adds to copy w % kCopies)
  float lmax = -INFINITY;
  unsigned* h0 = sm.cnt0[warp % kCopies];
  for (int j0 = 0; j0 < n; j0 += NT * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * NT + tid;
      v[u] = j < n ? __ldcs(xr + start + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * NT + tid;
      uint32_t bin = kNoBin;
      if (j < n) {
        const float l = __fdiv_rn(v[u], temperature);
        sl[j] = l;
        lmax = fmaxf(lmax, l);
        bin = sortable(l) >> 24;
      }
      if (by_k) warp_count(h0, bin);
    }
  }
  lmax = block_max(lmax, sm.redf);
  if (tid == 0) sm.bmax = lmax;
  if (by_k && tid < 256) {
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) c += sm.cnt0[k][tid];
    sm.cnt[0][tid] = c;
  }
  cl.sync();  // every block's slice, level-0 counts and max are ready
  if (tid < 32) {  // the row max: lane r reads rank r's
    float m = lane < C ? cl.map_shared_rank(&sm, lane)->bmax : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (tid == 0) sm.mx = m;
  }
  __syncthreads();
  const float mx = sm.mx;

  float tau = -INFINITY;  // kept set: l >= tau
  const Elems slice{nullptr, n};
  Elems kept = slice;     // a superset of the kept set

  // exact k-th largest value: a 4 x 8-bit radix select on counts. A block
  // zeroes the other buffer after the level's cluster.sync(): every block
  // has then read the previous level's histograms. Level 0's counts come
  // from the load; after it, list A holds every element at or above level
  // 0's bin (the later levels, top-p and the draw read only it), and the
  // pass that lists them counts level 1.
  bool gathered = false;
  if (by_k) {
    for (int lvl = 0; lvl < 4; ++lvl) {
      const int b = lvl & 1;
      if (lvl > 1) hist_counts(sl, kept, lvl, sm.kprefix, sm.cnt[b]);
      if (lvl > 0) cl.sync();
      merge_level(cl, sm.cnt[b], sm.cnt_all, sm, C);
      if (lvl > 0)
        for (int i = tid; i < 256; i += NT) sm.cnt[b ^ 1][i] = 0u;
      __syncthreads();
      if (tid < 32) pick_count(sm);
      __syncthreads();
      if (lvl == 0) kept = list_top(sl, n, sm.kprefix, sm.cnt[1], sm);
      // after level 1, at most kGather elements of the row at or above the
      // chosen bin: gather them and finish top-k and top-p in one warp (not
      // for the bin of +0, where -0 is kept by value but sorts below it)
      if (lvl == 1 && top_k - sm.krem + sm.kcnt <= kGather &&
          sm.kprefix != 0x8000u) {
        const uint32_t top = sm.kprefix;
        if (tid == 0) sm.gn = 0;
        __syncthreads();
        for (int t = tid; t < kept.m; t += NT) {
          const float l = sl[kept.at(t)];
          if ((sortable(l) >> 16) >= top) sm.gv[atomicAdd(&sm.gn, 1)] = l;
        }
        cl.sync();
        if (tid < 32) gather_select(cl, sm, C, top_k, top_p, mx);
        __syncthreads();
        gathered = true;
        break;
      }
    }
    tau = gathered ? sm.tau : unsortable(sm.kprefix);
  }

  // top-p threshold: a radix descent on fixed-point softmax mass over the
  // top-k survivors, the smallest value v with mass(l > v) < p * Z. After
  // level 0, list B holds the survivors at or above level 0's bin.
  if (top_p < 1.0f && !gathered) {
    Elems e = kept;
    for (int lvl = 0; lvl < 4; ++lvl) {
      const int b = lvl & 1;
      hist_mass(sl, e, lvl, sm.pprefix, tau, mx, sm.mass[b]);
      cl.sync();
      merge_level(cl, sm.mass[b], sm.mass_all, sm, C);
      for (int i = tid; i < 256; i += NT) sm.mass[b ^ 1][i] = 0ull;
      __syncthreads();
      if (tid < 32) pick_mass(sm, lvl, top_p);
      __syncthreads();
      if (lvl == 0) {
        const uint32_t top = sm.pprefix;
        e = list_elems(sl, n, kept, [top, tau](float l) {
          return l >= tau && (sortable(l) >> 24) >= top; }, sm, 1);
        if (e.list) kept = e;
      }
    }
    tau = fmaxf(tau, unsortable(sm.pprefix));
  }

  // Gumbel-max draw over the kept elements + their mass exp(l - mx) in 2^-40
  // units: integers, so neither the order of the list nor of the blocks
  // moves the sum
  const uint32_t k0 = keys[2 * row], k1 = keys[2 * row + 1];
  float bv = -INFINITY;
  int bi = INT_MAX;
  unsigned long long sum = 0ull;
#pragma unroll 2
  for (int t = tid; t < kept.m; t += NT) {
    const int j = kept.at(t);
    const float l = sl[j];
    if (l >= tau) {
      argmax_pair(bv, bi, l + gumbel(k0, k1, start + j), start + j);
      sum += __float2ull_rn(expf(l - mx) * kMassScale);
    }
  }
  block_argmax(bv, bi, sm.redf, sm.redi);
  sum = block_sum_u64(sum, sm.redu);
  if (tid == 0) {
    sm.bval = bv;
    sm.bidx = bi;
    sm.bsum = sum;
  }
  cl.sync();
  if (rank == 0 && tid < 32) {
    float v;
    int i;
    unsigned long long z;
    merge_results(cl, sm, C, v, i, z);
    if (tid == 0) {
      tok_out[row] = i;
      logp_out[row] = (__fdiv_rn(xr[i], temperature) - mx) -
                      (float)log((double)z / (double)kMassScale);
    }
  }
  cl.sync();  // no block leaves while rank 0 reads its shared memory
}

// The device's opt-in shared memory per block, less the kernel's static
// shared memory: the most a slice may take. Also lifts the kernel's limits
// to it and allows the non-portable cluster size of 16 (once per process).
int slice_bytes_limit(int* out) {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sample_kernel);
    const int lim = optin - (int)fa.sharedSizeBytes;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sample_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sample_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit = lim;
  }
  *out = limit;
  return 0;
}

// The launch configuration of R rows of V logits, C blocks per row.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Config(int R, int V, int C, bool greedy, cudaStream_t s) : cfg{} {
    const int S = (V + C - 1) / C;
    cfg.gridDim = dim3(R * C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = greedy ? 0 : (size_t)S * sizeof(float);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

int max_clusters(int V, int C, int* out) {
  int limit = 0;
  const int err = slice_bytes_limit(&limit);
  if (err != 0) return err;
  const Config c(1, V, C, false, nullptr);
  if (c.cfg.dynamicSmemBytes > (size_t)limit) {
    *out = 0;
    return 0;
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, sample_kernel, &c.cfg));
}

int launch(const void* keys, const void* logits, void* tok, void* logp, int R,
           int V, float temperature, int top_k, float top_p, int greedy,
           int C, cudaStream_t s) {
  int limit = 0;
  const int err = slice_bytes_limit(&limit);
  if (err != 0) return err;
  const Config c(R, V, C, greedy, s);
  if (c.cfg.dynamicSmemBytes > (size_t)limit)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernelEx(
      &c.cfg, sample_kernel, static_cast<const uint32_t*>(keys),
      static_cast<const float*>(logits), static_cast<int32_t*>(tok),
      static_cast<float*>(logp), V, (V + C - 1) / C, temperature, top_k,
      top_p, greedy));
}

}  // namespace

// K draws per thread, summed: the SASS of K = 2 less that of K = 1 is the
// instructions of one draw as the kernel's loop runs it (the key schedule
// and the addressing cancel). Launched only by tests and chip_smoke.py.
template <int K>
__global__ void gumbel_draw_probe(uint32_t k0, uint32_t k1, float* out,
                                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += gumbel(k0, k1, K * i + k);
  out[i] = s;
}

// cluster: blocks per row, 1..16 (above 8 the non-portable size).
extern "C" int fused_sample_rows(const void* keys, const void* logits,
                                 void* tok, void* logp, int R, int V,
                                 float temperature, int top_k, float top_p,
                                 int greedy, int cluster, void* stream) {
  if (R <= 0) return 0;
  if (cluster < 1 || cluster > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch(keys, logits, tok, logp, R, V, temperature, top_k,
                         top_p, greedy, cluster,
                         static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The largest slice (f32 elements per block) the kernel can keep in shared
// memory, in *out; returns a CUDA error code.
extern "C" int fused_sample_max_slice(int* out) {
  int limit = 0;
  const int err = slice_bytes_limit(&limit);
  *out = limit / (int)sizeof(float);
  return err;
}

// How many clusters of `cluster` blocks, each keeping a slice of V /
// cluster logits, the device runs at once, in *out (0 if the slice does
// not fit); returns a CUDA error code.
extern "C" int fused_sample_max_clusters(int V, int cluster, int* out) {
  return max_clusters(V, cluster, out);
}

// One Gumbel draw (K = 1) or the sum of two (K = 2) per output: out[i] =
// sum_k gumbel(key, K i + k), i < n.
extern "C" int fused_sample_draw_probe(unsigned k0, unsigned k1, void* out,
                                       int n, int K, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 255) / 256;
  if (K == 1)
    gumbel_draw_probe<1><<<blocks, 256, 0, s>>>(k0, k1, static_cast<float*>(out), n);
  else if (K == 2)
    gumbel_draw_probe<2><<<blocks, 256, 0, s>>>(k0, k1, static_cast<float*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
