// The LSTM training scans that run as 2-CTA thread-block clusters
// (bilstm2_resid.cu, and the reverse dh/dc scan below, shared by the fused
// bidirectional backward bilstm2_bwd.cu and the stacked-direction backward
// lstm_bwd.cu): each cluster is a (direction, row tile), its two CTAs split
// the hidden units in halves, and each CTA keeps its slice of W_hh in shared
// memory for the whole scan. The cluster barrier, distributed shared-memory
// stores, the one-time bulk load of the resident weight slice, the cluster
// launch and the backward scan kernel.

#pragma once

#include <type_traits>

#include "scan_common.cuh"

namespace cluster_scan {

using namespace scan_common;

constexpr unsigned kBulkChunk = 16384;  // bytes per bulk copy of the weight slice

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both CTAs arrives; shared-memory writes before it (local
// and remote) are visible to every thread after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of `p`'s counterpart in CTA `rank`
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// two consecutive floats (8-byte aligned): load, store, store into a cluster
// peer's shared memory, and copy global -> shared with cp.async (zero-filled
// when !ok)
__device__ __forceinline__ void ld2(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void st2(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st2_cluster(unsigned addr, const float (&v)[2]) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v[0]), "f"(v[1])
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* smem, const float* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 8 : 0));
}

// The H-wide streams of the training scans in the stream type S: fp32, or
// bf16 (two consecutive values, 4-byte aligned). A bf16 store rounds to
// nearest even; a load is exact.
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

template <typename S>
constexpr bool kLowPrecision = !std::is_same<S, float>::value;

// Thread 0 starts the bulk copy of `bytes` (a multiple of 16) from src into
// dst, counted on `bar`. The barrier is initialised here: a CTA-wide barrier
// must separate this call from any mbar_wait(bar, 0).
__device__ __forceinline__ void load_resident(float* dst, const float* src, unsigned bytes,
                                              uint64_t* bar) {
  if (threadIdx.x != 0) return;
  mbar_init(bar, 1);
  mbar_init_fence();
  mbar_arrive_expect_tx(bar, bytes);
  for (unsigned off = 0; off < bytes; off += kBulkChunk)
    bulk_g2s(dst + off / 4, src + off / 4, min(kBulkChunk, bytes - off), bar);
}

inline cudaLaunchConfig_t cluster_config(int tiles, int dirs, int threads, size_t smem,
                                         cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, tiles, dirs);  // (CTA of the cluster, row tile, direction)
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` as 2-CTA clusters over (tiles, dirs directions); returns a
// cudaError_t code.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int tiles, int dirs, int threads, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(tiles, dirs, threads, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many such clusters the card runs at once.
template <typename Kernel>
int max_clusters(Kernel kernel, int threads, size_t smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, 1, threads, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// ---- the reverse dh/dc scan of an LSTM backward ------------------------------
//
// Given a direction's saved gate pre-activations pre (the forward's
// x_t @ W_ih + h_prev @ W_hh + b, not recomputed), its c_prev and tanh(c)
// streams and the output cotangent g, per row-step in reverse scan order:
//   i, f, o = sigmoid, gg = tanh of pre
//   dh = g_t + dh_carry;  dc = dc_carry + dh * o * (1 - tc^2)
//   dpre = [dc*gg*i(1-i), dc*c_prev*f(1-f), dc*i(1-gg^2), dh*tc*o(1-o)]
//   dh_carry = dpre @ W_hh^T;  dc_carry = dc * f
// into a separate buffer dpre (pre stays as saved, so a second backward gives
// the same result). Masked (lens): steps with t >= len[row] give no dpre and
// pass the carries through.
//
// bf16 streams (S = __nv_bfloat16; c_prev, tanh(c) and g are read in bf16),
// as the TPU kernels' bf16 mode computes: dpre is rounded to bf16 before
// dpre @ W_hh^T and before it is stored (the dx and dW products read the
// rounded values), while db sums the unrounded dpre: each thread adds its
// rows' unrounded dpre over every step into registers and writes them once,
// as row rg of its tile, into dbpart [tiles * 8][dirs][4H] (the column-sum
// kernel of csrc/products.cu sums its rows). The dc carry stays unrounded.
//
// What bounds it: the fp32 FMAs of dpre @ W_hh^T, 2 * 4H * H FLOP per
// row-step and direction, and the step-to-step dependency.
//
// Design: one 2-CTA cluster per (direction, tile of 8 NR rows). CTA c owns
// hidden units [c H/2, (c + 1) H/2): it forms dpre for its units' four gates
// (2H columns) and keeps the matching 2H rows of W_hh^T ([2H][H], 128 KB at
// H = 128) in shared memory for the whole scan, loaded once by bulk copies on
// an mbarrier. Its product gives a partial dh over all H units; it keeps the
// half it owns in registers and sends the partner the other half through
// distributed shared memory into exchange buffer (s + 1) % 2, then one
// cluster barrier ends the step. Each unit's dh is its two partials summed
// once, in a fixed order (fp32 addition of two terms is commutative), so a
// run repeats itself bit for bit; no float atomics. The next step's inputs
// are loaded into registers while the product runs. 2 hidden units per
// thread: 2H threads.

constexpr int kBwdUnits = 2;  // hidden units per thread (ld2, st2)

// Where the scan finds a direction's row-steps: gate column j of direction d
// at row-step (gr, t) is pre[d * pre_dir + (gr * Tn + t) * pre_step + j] (and
// so in dpre); unit u of its H-wide streams is cp[d][(gr * Tn + t) * H + u]
// (tc, g likewise). Direction 0 runs t = T-1..0; direction 1 the same when
// `down1`, else t = 0..T-1 (the fused pair's reversed direction).
struct BwdScanArgs {
  const float* pre;
  float* dpre;
  const void* cp[2];    // H-wide streams in the stream type
  const void* tc[2];
  const void* g[2];
  const float* wsplit;  // [dirs, 2 c, 4, H / 2, H]: CTA (d, c)'s rows of W_hh[d]^T
  const int* lens;      // [R] or null
  float* dbpart;        // [tiles * 8][dirs][4H] (bf16 streams only)
  long long pre_dir;
  int pre_step;
  int down1;
  int R, Tn, H;
};

__host__ __device__ constexpr int bwd_dps_pitch(int H) { return 2 * H + 4; }
__host__ __device__ constexpr int bwd_xb_pitch(int H) { return H / 2 + 4; }

// shared memory of one CTA: W^T slice, the dpre tile, two exchange buffers
// and the mbarrier
constexpr size_t bwd_smem_bytes(int nr, int H) {
  return (static_cast<size_t>(2 * H) * H + 8 * nr * bwd_dps_pitch(H) +
          2 * 8 * nr * bwd_xb_pitch(H)) * sizeof(float) + sizeof(uint64_t);
}

// Grid (2, tiles, dirs) in clusters of (2, 1, 1); 2H threads, each owning NR
// rows x 2 units (x 4 gates for dpre, of both halves for the product).
template <int NR, typename S>
__global__ void __launch_bounds__(256, 1) bwd_scan_kernel(const BwdScanArgs a) {
  constexpr int UW = kBwdUnits;
  constexpr int RT = 8 * NR;
  constexpr bool kLow = kLowPrecision<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, Tn = a.Tn, H = a.H;
  const float* __restrict__ pre = a.pre;
  float* __restrict__ dpre = a.dpre;
  const int* __restrict__ lens = a.lens;
  const long long pre_dir = a.pre_dir;
  const int pre_step = a.pre_step;
  const int Hh = H / 2;
  const int dpitch = bwd_dps_pitch(H), xpitch = bwd_xb_pitch(H);
  float* ws = reinterpret_cast<float*>(smem);  // [2H][H]: own gate column, then unit
  float* dps = ws + 2 * H * H;                 // [RT][dpitch]
  float* xb = dps + RT * dpitch;               // [2][RT][xpitch]
  uint64_t* bar = reinterpret_cast<uint64_t*>(xb + 2 * RT * xpitch);

  const unsigned c = cluster_rank();
  const int d = blockIdx.z;
  const int row0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int rg = tid & 7;          // rows rg + 8 r
  const int u0 = (tid >> 3) * UW;  // units u0..u0+UW-1 of either half
  const int gu = c * Hh + u0;      // this thread's own units of all H
  const bool down = d == 0 || a.down1;

  load_resident(ws, a.wsplit + (d * 2 + c) * static_cast<long long>(2 * H) * H,
                static_cast<unsigned>(2 * H * H * sizeof(float)), bar);

  int rlen[NR];
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int gr = row0 + rg + 8 * r;
    rlen[r] = gr < R ? (lens != nullptr ? min(max(lens[gr], 0), Tn) : Tn) : 0;
  }
  for (int i = 0; i < RT && row0 + i < R; ++i)
    t_end = max(t_end, lens != nullptr ? min(max(lens[row0 + i], 0), Tn) : Tn);

  // selects, not a runtime index into the parameter arrays (which would
  // copy them to local memory)
  const S* cpd = static_cast<const S*>(d == 0 ? a.cp[0] : a.cp[1]);
  const S* tcd = static_cast<const S*>(d == 0 ? a.tc[0] : a.tc[1]);
  const S* gd = static_cast<const S*>(d == 0 ? a.g[0] : a.g[1]);
  auto at = [&](const S* p, int gr, int t) {
    return p + static_cast<long long>(gr) * (Tn * H) + t * H + gu;
  };
  auto gate_off = [&](int gr, int t) {
    return d * pre_dir + (static_cast<long long>(gr) * Tn + t) * pre_step + gu;
  };

  float zeros[UW];
#pragma unroll
  for (int j = 0; j < UW; ++j) zeros[j] = 0.f;
  for (int t = t_end; t < Tn; ++t) {  // steps past every row's length give no dpre
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int gr = row0 + rg + 8 * r;
      if (gr < R) {
#pragma unroll
        for (int g = 0; g < 4; ++g) st2(dpre + gate_off(gr, t) + g * H, zeros);
      }
    }
  }

  // this step's inputs, loaded a step ahead: the four gates, c_prev, tanh(c)
  // and the cotangent
  float in[NR][7][UW];
  auto fetch = [&](int t) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int gr = row0 + rg + 8 * r;
      if (gr < R) {
#pragma unroll
        for (int g = 0; g < 4; ++g) ld2(pre + gate_off(gr, t) + g * H, in[r][g]);
        ld2(at(cpd, gr, t), in[r][4]);
        ld2(at(tcd, gr, t), in[r][5]);
        ld2(at(gd, gr, t), in[r][6]);
      } else {
#pragma unroll
        for (int q = 0; q < 7; ++q)
#pragma unroll
          for (int j = 0; j < UW; ++j) in[r][q][j] = 0.f;
      }
    }
  };
  if (t_end > 0) fetch(down ? t_end - 1 : 0);

  float dh[NR][UW], dc[NR][UW];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int j = 0; j < UW; ++j) dh[r][j] = dc[r][j] = 0.f;
  float dbacc[4][UW];  // bf16 streams: this thread's rows' unrounded dpre, summed
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UW; ++j) dbacc[g][j] = 0.f;

  cluster_sync();     // both CTAs run; the mbarrier is initialised
  mbar_wait(bar, 0);  // the W^T slice landed

  for (int s = 0; s < t_end; ++s) {
    const int t = down ? t_end - 1 - s : s;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = rg + 8 * r;
      const int gr = row0 + row;
      const bool live = t < rlen[r];
      float v[4][UW];
#pragma unroll
      for (int j = 0; j < UW; ++j) {
        const float ig = sigmoid_f(in[r][0][j]);
        const float fg = sigmoid_f(in[r][1][j]);
        const float ggv = tanhf(in[r][2][j]);
        const float og = sigmoid_f(in[r][3][j]);
        const float tc = in[r][5][j];
        const float dhv = in[r][6][j] + dh[r][j];
        const float dcv = dc[r][j] + dhv * (og * (1.0f - tc * tc));
        v[0][j] = live ? dcv * (ggv * ig * (1.0f - ig)) : 0.f;
        v[1][j] = live ? dcv * (in[r][4][j] * fg * (1.0f - fg)) : 0.f;
        v[2][j] = live ? dcv * (ig * (1.0f - ggv * ggv)) : 0.f;
        v[3][j] = live ? dhv * (tc * og * (1.0f - og)) : 0.f;
        if (live) dc[r][j] = dcv * fg;
        if constexpr (kLow) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            dbacc[g][j] += v[g][j];
            v[g][j] = round_to<S>(v[g][j]);
          }
        }
      }
      float* dp = dps + row * dpitch + u0;
#pragma unroll
      for (int g = 0; g < 4; ++g) st2(dp + g * Hh, v[g]);
      if (gr < R) {
        float* gp = dpre + gate_off(gr, t);
#pragma unroll
        for (int g = 0; g < 4; ++g) st2(gp + g * H, v[g]);
      }
    }
    if (s + 1 < t_end) fetch(down ? t - 1 : t + 1);
    __syncthreads();  // the dpre tile is complete

    // partial dh over all H units from this CTA's 2H gate columns: units
    // u0.. of half 0 (acc[.][0][.]) and of half 1 (acc[.][1][.])
    float acc[NR][2][UW];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < UW; ++j) acc[r][0][j] = acc[r][1][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < 2 * H; k += 4) {
      float4 av4[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) av4[r] = ld4(dps + (rg + 8 * r) * dpitch + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w0[UW], w1[UW];
        ld2(ws + (k + kk) * H + u0, w0);
        ld2(ws + (k + kk) * H + Hh + u0, w1);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float av = comp(av4[r], kk);
#pragma unroll
          for (int j = 0; j < UW; ++j) {
            acc[r][0][j] = fmaf(av, w0[j], acc[r][0][j]);
            acc[r][1][j] = fmaf(av, w1[j], acc[r][1][j]);
          }
        }
      }
    }
    // the partner's half goes to its exchange buffer (s + 1) % 2 (selects
    // with constant indices: a runtime index would put acc in local memory)
    float* xn = xb + ((s + 1) & 1) * RT * xpitch;
    const unsigned remote = map_rank(xn, c ^ 1u);
    const bool first = c == 0;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float send[UW];
#pragma unroll
      for (int j = 0; j < UW; ++j) send[j] = first ? acc[r][1][j] : acc[r][0][j];
      st2_cluster(remote + 4 * ((rg + 8 * r) * xpitch + u0), send);
    }
    cluster_sync();  // the partials arrived; this step's reads of the dpre tile are done
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float recv[UW];
      ld2(xn + (rg + 8 * r) * xpitch + u0, recv);
      if (t < rlen[r]) {
#pragma unroll
        for (int j = 0; j < UW; ++j) dh[r][j] = (first ? acc[r][0][j] : acc[r][1][j]) + recv[j];
      }
    }
  }
  if constexpr (kLow) {  // row rg of this tile, direction d, this thread's 4 gates x 2 units
    const int dirs = gridDim.z;
    float* part = a.dbpart + (static_cast<long long>(blockIdx.y * 8 + rg) * dirs + d) * 4 * H + gu;
#pragma unroll
    for (int g = 0; g < 4; ++g) st2(part + g * H, dbacc[g]);
  }
}

// The scan at a tile height of 16, 24, 32, 40 or 48 rows over `dirs`
// directions; H a multiple of 16, at most 128. Returns a cudaError_t code.
template <int NR, typename S>
int launch_bwd_scan(const BwdScanArgs& a, int dirs, cudaStream_t s) {
  const int tiles = (a.R + 8 * NR - 1) / (8 * NR);
  return launch_cluster(bwd_scan_kernel<NR, S>, tiles, dirs, 2 * a.H, bwd_smem_bytes(NR, a.H), s,
                        a);
}

template <typename S>
int bwd_scan_typed(int height, const BwdScanArgs& a, int dirs, cudaStream_t s) {
  switch (height) {
    case 16: return launch_bwd_scan<2, S>(a, dirs, s);
    case 24: return launch_bwd_scan<3, S>(a, dirs, s);
    case 32: return launch_bwd_scan<4, S>(a, dirs, s);
    case 40: return launch_bwd_scan<5, S>(a, dirs, s);
    case 48: return launch_bwd_scan<6, S>(a, dirs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 = fp32 streams, 1 = bf16 streams (then dbpart is written).
inline int bwd_scan(int height, int dtype, const BwdScanArgs& a, int dirs, cudaStream_t s) {
  if (a.H % 16 || a.H > 128 || a.H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return bwd_scan_typed<float>(height, a, dirs, s);
  if (dtype == 1 && a.dbpart != nullptr) return bwd_scan_typed<__nv_bfloat16>(height, a, dirs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of the scan at this tile height the card runs at once
// (either stream type: both take the same shared memory and threads).
inline int bwd_scan_max_clusters(int height, int H, int* clusters) {
  const int threads = 2 * H;
  switch (height) {
    case 16: return max_clusters(bwd_scan_kernel<2, float>, threads, bwd_smem_bytes(2, H), clusters);
    case 24: return max_clusters(bwd_scan_kernel<3, float>, threads, bwd_smem_bytes(3, H), clusters);
    case 32: return max_clusters(bwd_scan_kernel<4, float>, threads, bwd_smem_bytes(4, H), clusters);
    case 40: return max_clusters(bwd_scan_kernel<5, float>, threads, bwd_smem_bytes(5, H), clusters);
    case 48: return max_clusters(bwd_scan_kernel<6, float>, threads, bwd_smem_bytes(6, H), clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cluster_scan
