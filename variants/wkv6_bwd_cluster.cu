// WKV6's backward with a head's columns split over a thread-block cluster:
// a design that lost to the kernel in src/repro_torch/csrc/wkv6.cu on the
// H100 (PERF.md), kept so that chip_variants.py can time it again. It is
// not a source of its own: chip_variants.py appends it to a copy of
// csrc/wkv6.cu whose entry `wkv6_bwd` it renames, so the helpers there
// (load_t, load_f, row_scatter, col_scatter, the forward that
// stores the boundary states every kBwdChunk steps) serve both, and this
// file's `wkv6_bwd` takes the same arguments.
//
// S and G = dL/dS evolve element by element with row scalars (r, k, w) and
// column scalars (v, dy), so C blocks of a cluster each own hd / C columns
// of a head and do exactly the single block's arithmetic on them. dv (a
// column sum) stays in its block; Q_t and P_t need whole rows, which every
// block stages. The row sums (dr, dk, dw) are the only sums across blocks:
// each lane pushes its partial into the shared memory of the block that
// owns the row (distributed shared memory), and after one cluster barrier
// an interval each block sums its 1 / C of the rows in rank order, rank 0's
// partials carrying the u terms. chip_variants.py substitutes the cluster
// size (cluster_of) and the blocks an SM (kClusterMinBlocks).
#include <cooperative_groups.h>

namespace {

namespace coop = cooperative_groups;

constexpr int kClusterMinBlocks = 2;  // blocks an SM
// blocks a head's cluster at head size HD
template <int HD>
constexpr int cluster_of() { return HD / 16; }

// a head's columns over C blocks: BC = hd / C columns a block, 4 a lane,
// so CG = BC / 4 lanes span a row slice of the block and a lane owns
// RT = CG / 2 rows (what row_scatter takes); a warp holds 32 / CG slices,
// the head's rows follow over hd / 16 warps
template <int HD, int C>
struct ClusterTile {
  static constexpr int BC = HD / C;     // columns of a block
  static constexpr int CG = BC / 4;     // lanes across one row slice
  static constexpr int RT = CG / 2;     // rows a lane
  static constexpr int RGW = 32 / CG;   // row slices a warp holds
  static constexpr int NW = HD / (RT * RGW);
  static constexpr int THREADS = 32 * NW;
};

template <typename T, int HD, int C, int KH, int KB>
struct ClusterSmem {
  using L = ClusterTile<HD, C>;
  float4 hist[KH][L::RT][L::THREADS];  // S_{t-1}, each lane its own
  alignas(16) T raw[2][5][KB][HD];     // r, k, v, w, dy as loaded, 2 buffers
  float rows[2][KB][3][C][HD / C];     // dr, dk, dw partials of the rows
                                       // this block sums, from each rank
  float part[KB][L::NW][L::BC];        // the warps' dv sums
  float q[KB];                         // Q_t
  float u[HD];
  float4 bnd[KB > KH ? L::RT : 1][L::THREADS];  // the interval's boundary
};

template <typename T, int HD, int C, int KH, int KB>
__global__ void __launch_bounds__(ClusterTile<HD, C>::THREADS,
                                  kClusterMinBlocks)
wkv6_bwd_cluster_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ state0,
                        const T* __restrict__ dy,
                        const float* __restrict__ dstate, T* __restrict__ dr,
                        T* __restrict__ dk, T* __restrict__ dv,
                        T* __restrict__ dw, float* __restrict__ pu,
                        float* __restrict__ ds0,
                        const float* __restrict__ ckpt, int len, int H,
                        int vec) {
  using L = ClusterTile<HD, C>;
  using Sm = ClusterSmem<T, HD, C, KH, KB>;
  constexpr int K = KB;
  constexpr int RT = L::RT, CG = L::CG, NT = L::THREADS, NW = L::NW;
  constexpr int BC = L::BC;
  constexpr int E = 16 / sizeof(T), PR = HD / E;   // 16-byte pieces a row
  constexpr int EP = HD / (32 / K);                // Q, P: elements a lane
  constexpr int EV = EP < 4 ? EP : 4;              // ... a load
  constexpr int RS = HD / C;                       // rows a block sums
  static_assert(CG == 2 * RT && RT >= 1 && 32 % K == 0 && EP >= 1,
                "2 RT lanes a row slice; K divides a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);
  coop::cluster_group cluster = coop::this_cluster();

  const int rank = blockIdx.x % C, h = blockIdx.x / C, b = blockIdx.y;
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32;
  const int cg = lane % CG, mi = cg >> 1;   // mi: the row of the row sums
  const int i0 = RT * (wi * L::RGW + lane / CG);   // first row owned
  const int jc = rank * BC + 4 * cg;               // first column owned
  const size_t tstride = (size_t)H * HD;
  const size_t base = (size_t)b * len * tstride + (size_t)h * HD;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;  // this head's state
  const int nchk = (len + K - 1) / K;

  float S[RT][4], G[RT][4];
#pragma unroll
  for (int m = 0; m < RT; ++m) {
    if (dstate != nullptr) {
      load_f<4>(dstate + sbase + (i0 + m) * HD + jc, G[m]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) G[m][n] = 0.f;
    }
  }
  for (int i = tid; i < HD; i += NT) sm.u[i] = u[(size_t)h * HD + i];
  const float ui = u[(size_t)h * HD + i0 + mi];

  // job j: interval nchk - 1 - j; its inputs go to raw[j & 1]
  auto stage = [&](int j) {
    const int t0 = (nchk - 1 - j) * K, nt = min(K, len - t0);
    for (int i = tid; i < 5 * K * PR; i += NT) {
      const int a = i / (K * PR), s = i / PR % K, pc = i % PR;
      if (s >= nt) continue;
      const T* g = (a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w : dy) +
                   base + (size_t)(t0 + s) * tstride + pc * E;
      T* d = &sm.raw[j & 1][a][s][pc * E];
      if (vec) {
        cp_async16(smem_addr(d), g, true);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = g[e];
      }
    }
  };
  // interval c's dr, dk, dw of the rows this block owns, each the sum of
  // the ranks' partials (buffer rb) in rank order
  auto merge = [&](int c, int rb) {
    const int t0 = c * K, nt = min(K, len - t0);
    for (int i = tid; i < nt * 3 * RS; i += NT) {
      const int s = i / (3 * RS), a = i / RS % 3, rl = i % RS;
      float acc = sm.rows[rb][s][a][0][rl];
#pragma unroll
      for (int q = 1; q < C; ++q) acc += sm.rows[rb][s][a][q][rl];
      T* out = a == 0 ? dr : a == 1 ? dk : dw;
      out[base + (size_t)(t0 + s) * tstride + rank * RS + rl] =
          repro::from_f<T>(acc);
    }
  };
  // where this lane's row sums go: the owner block's slot for this rank
  // (remote stores do not wait)
  float* own_rows = cluster.map_shared_rank(
      &sm.rows[0][0][0][rank][(i0 + mi) % RS], (i0 + mi) / RS);
  auto load_bound = [&](int c, float (&dst)[RT][4]) {
#pragma unroll
    for (int m = 0; m < RT; ++m)
      load_f<4>(c == 0 ? state0 + sbase + (i0 + m) * HD + jc
                       : ckpt + ((((size_t)b * H + h) * (nchk - 1) + (c - 1))
                                 * HD + i0 + m) * HD + jc,
                dst[m]);
  };

  // one cluster barrier a job: after it job j's inputs have landed, job
  // j + 1's load and the previous interval's row sums are merged
  float du = 0.f;                           // row mi's du partial (rank 0)
  float Sb[RT][4];
  load_bound(nchk - 1, Sb);
  stage(0);
  cp_async_commit();
  for (int j = 0; j < nchk; ++j) {
    const int c = nchk - 1 - j, buf = j & 1;
    const int t0 = c * K, nt = min(K, len - t0);
    cp_async_wait<0>();
    cluster.sync();
    if (j > 0) merge(c + 1, (j - 1) & 1);
    if (j + 1 < nchk) stage(j + 1);
    cp_async_commit();
    float qv = 0.f, pv = 0.f;
    {
      const int s = lane % K, e0 = lane / K * EP;
      if (s < nt) {
#pragma unroll
        for (int e = 0; e < EP; e += EV) {
          float rr[EV], kk[EV], vv[EV], dd[EV];
          load_t<EV>(&sm.raw[buf][0][s][e0 + e], rr);
          load_t<EV>(&sm.raw[buf][1][s][e0 + e], kk);
          load_t<EV>(&sm.raw[buf][2][s][e0 + e], vv);
          load_t<EV>(&sm.raw[buf][4][s][e0 + e], dd);
#pragma unroll
          for (int x = 0; x < EV; ++x) {
            qv = fmaf(rr[x] * kk[x], sm.u[e0 + e + x], qv);
            pv = fmaf(vv[x], dd[x], pv);
          }
        }
      }
#pragma unroll
      for (int off = K; off < 32; off <<= 1) {
        qv += __shfl_xor_sync(0xffffffffu, qv, off);
        pv += __shfl_xor_sync(0xffffffffu, pv, off);
      }
      if (wi == 0 && lane < K) sm.q[lane] = qv;
    }
    const int rb = j & 1;
#pragma unroll
    for (int m = 0; m < RT; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) S[m][n] = Sb[m][n];
    }
    if constexpr (KB > KH) {
      if (nt > KH) {
#pragma unroll
        for (int m = 0; m < RT; ++m)
          sm.bnd[m][tid] = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
      }
    }
    if (c > 0) load_bound(c - 1, Sb);
    auto advance = [&](int t) {           // S over step t of the interval
      float kk[RT], ww[RT], vv[4];
      load_t<RT>(&sm.raw[buf][1][t][i0], kk);
      load_t<RT>(&sm.raw[buf][3][t][i0], ww);
      load_t<4>(&sm.raw[buf][2][t][jc], vv);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          S[m][n] = fmaf(ww[m], S[m][n], kk[m] * vv[n]);
      }
    };
    const int last = (nt - 1) / KH;
    for (int q = last; q >= 0; --q) {
      const int s0 = q * KH, ns = min(KH, nt - s0);
      if constexpr (KB > KH) {
        if (q != last) {
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float4 b4 = sm.bnd[m][tid];
            S[m][0] = b4.x; S[m][1] = b4.y; S[m][2] = b4.z; S[m][3] = b4.w;
          }
        }
      }
      for (int t = 0; t < s0; ++t) advance(t);
#pragma unroll
      for (int s = 0; s < KH; ++s) {
        if (s >= ns) break;
#pragma unroll
        for (int m = 0; m < RT; ++m)
          sm.hist[s][m][tid] = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
        advance(s0 + s);
      }
#pragma unroll
      for (int s = KH - 1; s >= 0; --s) {
        if (s >= ns) continue;                    // uniform over the block
        const int t = s0 + s;                     // the step in the interval
        float rr[RT], kk[RT], ww[RT], vv[4], dyv[4];
        load_t<RT>(&sm.raw[buf][0][t][i0], rr);
        load_t<RT>(&sm.raw[buf][1][t][i0], kk);
        load_t<RT>(&sm.raw[buf][3][t][i0], ww);
        load_t<4>(&sm.raw[buf][2][t][jc], vv);
        load_t<4>(&sm.raw[buf][4][t][jc], dyv);
        const float P = __shfl_sync(0xffffffffu, pv, t);
        float acc[3][RT], cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const float4 p4 = sm.hist[s][m][tid];
          const float sp[4] = {p4.x, p4.y, p4.z, p4.w};
          float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            a_r = fmaf(sp[n], dyv[n], a_r);
            a_k = fmaf(G[m][n], vv[n], a_k);
            a_w = fmaf(G[m][n], sp[n], a_w);
            cs[n] = fmaf(G[m][n], kk[m], cs[n]);
            G[m][n] = fmaf(ww[m], G[m][n], rr[m] * dyv[n]);
          }
          acc[0][m] = a_r;
          acc[1][m] = a_k;
          acc[2][m] = a_w;
        }
        // row mi's partial sums; rank 0 adds the u terms; the lane pair
        // splits the stores
        float sums[3];
        row_scatter<RT>(acc, cg, sums);
        const float rm = repro::to_f(sm.raw[buf][0][t][i0 + mi]);
        const float km = repro::to_f(sm.raw[buf][1][t][i0 + mi]);
        if (rank == 0) {
          sums[0] = fmaf(ui * km, P, sums[0]);
          sums[1] = fmaf(ui * rm, P, sums[1]);
          du = fmaf(rm * km, P, du);
        }
        float* row = own_rows + (rb * KB + t) * 3 * HD;   // [rb][t][a]
        if (cg & 1) {
          row[2 * HD] = sums[2];
        } else {
          row[0] = sums[0];
          row[HD] = sums[1];
        }
        col_scatter<CG>(cs, lane, &sm.part[t][wi][0]);
      }
    }
    __syncthreads();
    // dv of the interval: the warps' sums in warp order, + Q_t dy_t
    for (int i = tid; i < nt * BC; i += NT) {
      const int s = i / BC, jj = rank * BC + i % BC;
      float acc = sm.part[s][0][i % BC];
#pragma unroll
      for (int x = 1; x < NW; ++x) acc += sm.part[s][x][i % BC];
      acc = fmaf(sm.q[s], repro::to_f(sm.raw[buf][4][s][jj]), acc);
      dv[base + (size_t)(t0 + s) * tstride + jj] = repro::from_f<T>(acc);
    }
  }
  // the first interval's row sums (after the barrier nothing is written to
  // another block's shared memory)
  cluster.sync();
  merge(0, (nchk - 1) & 1);
#pragma unroll
  for (int m = 0; m < RT; ++m)
    *reinterpret_cast<float4*>(ds0 + sbase + (i0 + m) * HD + jc) =
        make_float4(G[m][0], G[m][1], G[m][2], G[m][3]);
  if (rank == 0 && (cg & 1) == 0)
    pu[((size_t)b * H + h) * HD + i0 + mi] = du;
}

// the launch at head size HD: a cluster of C blocks a (head, row)
template <typename T, int HD>
struct ClusterLaunch {
  static constexpr int C = cluster_of<HD>();
  static constexpr int kSmem =
      sizeof(ClusterSmem<T, HD, C, kBwdHist, kBwdChunk>);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int B, int H, cudaStream_t s) : cfg{} {
    cfg.gridDim = dim3(H * C, B);
    cfg.blockDim = dim3(ClusterTile<HD, C>::THREADS);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  static auto kernel() {
    return wkv6_bwd_cluster_kernel<T, HD, C, kBwdHist, kBwdChunk>;
  }
  static cudaError_t prepare() {
    return cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
};

template <typename T, int HD>
int launch_cluster(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* state0,
                   const void* dy, const void* dstate, void* dr, void* dk,
                   void* dv, void* dw, void* pu, void* ds0, const void* ckpt,
                   int B, int len, int H, cudaStream_t s) {
  using Ln = ClusterLaunch<T, HD>;
  cudaError_t e = Ln::prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(dy);
  const Ln ln(B, H, s);
  e = cudaLaunchKernelEx(
      &ln.cfg, Ln::kernel(), static_cast<const T*>(r),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state0), static_cast<const T*>(dy),
      static_cast<const float*>(dstate), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw),
      static_cast<float*>(pu), static_cast<float*>(ds0),
      static_cast<const float*>(ckpt), len, H,
      static_cast<int>(any % 16 == 0));
  return static_cast<int>(e);
}

template <typename T, int HD>
int cluster_info(int* out) {
  using Ln = ClusterLaunch<T, HD>;
  out[0] = Ln::kSmem;
  out[1] = Ln::C;
  cudaError_t e = Ln::prepare();
  const Ln ln(1, 1, nullptr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&out[2], Ln::kernel(), &ln.cfg);
  return static_cast<int>(e);
}

template <typename T>
int dispatch_cluster(int hd, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* state0,
                     const void* dy, const void* dstate, void* dr, void* dk,
                     void* dv, void* dw, void* pu, void* ds0,
                     const void* ckpt, int B, int len, int H,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch_cluster<T, 16>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    case 32: return launch_cluster<T, 32>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    case 64: return launch_cluster<T, 64>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// csrc/wkv6.cu's `wkv6_bwd`, arguments and all, through the cluster kernel
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* state0,
                        const void* dy, const void* dstate, void* dr,
                        void* dk, void* dv, void* dw, void* pu, void* ds0,
                        const void* ckpt, int B, int len, int H, int hd,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len < 1 || (ckpt == nullptr && len > kBwdChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kBFloat16)
    err = dispatch_cluster<__nv_bfloat16>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  else if (dtype == repro::kFloat32)
    err = dispatch_cluster<float>(hd, r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, pu, ds0, ckpt, B, len, H, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The cluster launch at head size hd and dtype: out[0] its dynamic shared
// memory, out[1] the blocks of its cluster, out[2] the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int wkv6_bwd_info(int hd, int dtype, int* out) {
  const bool bf16 = dtype == repro::kBFloat16;
  switch (hd) {
    case 16: return bf16 ? cluster_info<__nv_bfloat16, 16>(out) : cluster_info<float, 16>(out);
    case 32: return bf16 ? cluster_info<__nv_bfloat16, 32>(out) : cluster_info<float, 32>(out);
    case 64: return bf16 ? cluster_info<__nv_bfloat16, 64>(out) : cluster_info<float, 64>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
