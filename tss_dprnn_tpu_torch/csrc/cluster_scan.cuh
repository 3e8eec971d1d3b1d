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
#include "tf32_mma.cuh"

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
// the same result). Masked (lens): steps with t >= len[row] give no dpre (it
// is written 0) and pass the carries through.
//
// fp32 streams: dpre @ W_hh^T in fp32 FMAs, dpre stored fp32.
//
// bf16 streams (S = __nv_bfloat16; c_prev, tanh(c) and g are read in bf16),
// as the TPU kernels' bf16 mode computes (pallas_lstm.py:1287-1310): dpre is
// formed in fp32 and rounded to bf16 (dpre_s = dpre.astype(bf16)); dh_carry =
// dpre_s @ W_hh^T runs on the tensor cores, mma.sync m16n8k16 bf16 with fp32
// accumulation (a product of two bf16 values is exact in fp32, so only the
// order of the sums differs from the TPU kernel's jnp.dot with
// preferred_element_type=f32); dpre_s is stored in a bf16 buffer (the dx and
// dW products of csrc/products.cu read it as it is), while db sums the
// unrounded dpre: each thread adds its rows' unrounded dpre over every step
// into registers and writes them once, as row rg of its tile, into dbpart
// [tiles * 8][dirs][4H] (the column-sum kernel of csrc/products.cu sums its
// rows). The dc carry stays unrounded.
//
// What bounds it: dpre @ W_hh^T, 2 * 4H * H FLOP per row-step and direction
// (fp32 on the FMA pipe, bf16 on the tensor cores), and the step-to-step
// dependency.
//
// Design: one 2-CTA cluster per (direction, tile of 8 NR rows). CTA c owns
// hidden units [c H/2, (c + 1) H/2): it forms dpre for its units' four gates
// (2H columns, 2 units x NR rows x 4 gates a thread) and keeps the matching
// 2H rows of W_hh^T in shared memory for the whole scan, loaded once by bulk
// copies on an mbarrier. Its product gives a partial dh over all H units;
// the two partials of each unit meet in the owner CTA's shared memory through
// distributed shared memory, in exchange buffer (s + 1) % 2, and one cluster
// barrier ends the step. Each unit's dh is its two partials summed once, in a
// fixed order (fp32 addition of two terms is commutative), so a run repeats
// itself bit for bit; no float atomics. The next step's inputs are loaded
// into registers while the product runs. 2 hidden units per thread: 2H
// threads.
// fp32: W_hh^T's slice [2H][H] fp32 (128 KB at H = 128); each thread sums
// its rows' partial dh over both halves' units u0, u0 + 1 in FMAs, keeps its
// own half's in registers and sends the partner the other half.
// bf16: the slice in bf16 in the order of the mma's B fragments (64 KB at H =
// 128, laid out by the host, ops/bilstm2.bwd_weight_layout_bf16), the dpre
// tile [8 NR][2H] in bf16; warp w computes units 16 w .. 16 w + 15 of the
// partial dh (two n-tiles) for every 16-row m-tile of the tile (NR even: tiles
// of 16, 32 or 48 rows), its A fragments by ldmatrix, and stores each n-tile
// into the exchange buffer of the CTA that owns its units, slot c (the
// sender): the owner sums slot 0 + slot 1. Two CTAs of 16 rows fit an SM in
// shared memory (89 KB each at H = 128); the occupancy query says whether
// their registers do.

constexpr int kBwdUnits = 2;  // hidden units per thread (ld2, st2)

// Where the scan finds a direction's row-steps: gate column j of direction d
// at row-step (gr, t) is pre[d * pre_dir + (gr * Tn + t) * pre_step + j] (and
// so in dpre); unit u of its H-wide streams is cp[d][(gr * Tn + t) * H + u]
// (tc, g likewise); in the time-major layout (kTM below: the fused pair's
// `bilstm2_backward_tm`, pallas_lstm.py:1366) (t * R + gr) in place of (gr *
// Tn + t). Direction 0 runs t = T-1..0; direction 1 the same when `down1`,
// else t = 0..T-1 (the fused pair's reversed direction).
struct BwdScanArgs {
  const float* pre;
  void* dpre;           // in the stream type
  const void* cp[2];    // H-wide streams in the stream type
  const void* tc[2];
  const void* g[2];
  // fp32: [dirs, 2 c, 4, H / 2, H], CTA (d, c)'s rows of W_hh[d]^T;
  // bf16: [dirs, 2 c, H / 8 ks, H / 16 w, 8 lg, 4 lt, 2 nt, 2 j, 2 e]
  const void* wsplit;
  const int* lens;      // [R] or null
  float* dbpart;        // [tiles * 8][dirs][4H] (bf16 streams only)
  long long pre_dir;
  int pre_step;
  int down1;
  int R, Tn, H;
};

// pitches of the dpre tile (in its element type) and of the exchange buffers
template <typename S>
__host__ __device__ constexpr int bwd_dps_pitch(int H) {
  return kLowPrecision<S> ? 2 * H + 8 : 2 * H + 4;
}
__host__ __device__ constexpr int bwd_xb_pitch(int H) { return H / 2 + 4; }

// shared memory of one CTA: W^T slice, the dpre tile, two exchange buffers
// (bf16: of two slots each) and the mbarrier
template <typename S>
constexpr size_t bwd_smem_bytes(int nr, int H) {
  constexpr int kSlots = kLowPrecision<S> ? 2 : 1;
  return (static_cast<size_t>(2 * H) * H + 8 * nr * bwd_dps_pitch<S>(H)) * sizeof(S) +
         static_cast<size_t>(2 * kSlots * 8 * nr * bwd_xb_pitch(H)) * sizeof(float) +
         sizeof(uint64_t);
}

// Grid (2, tiles, dirs) in clusters of (2, 1, 1); 2H threads, each owning NR
// rows x 2 units (x 4 gates for dpre; fp32: of both halves for the product).
// bf16 16-row tiles may run two CTAs on an SM (128 registers). kTM: the
// time-major layout, a template parameter so that the batch-major
// instantiations compile as before.
template <int NR, typename S, bool kTM>
__global__ void __launch_bounds__(256, kLowPrecision<S> && NR == 2 ? 2 : 1)
    bwd_scan_kernel(const BwdScanArgs a) {
  constexpr int UW = kBwdUnits;
  constexpr int RT = 8 * NR;
  constexpr bool kLow = kLowPrecision<S>;
  static_assert(!kLow || NR % 2 == 0, "bf16: whole 16-row m-tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, Tn = a.Tn, H = a.H;
  const float* __restrict__ pre = a.pre;
  S* __restrict__ dpre = static_cast<S*>(a.dpre);
  const int* __restrict__ lens = a.lens;
  const long long pre_dir = a.pre_dir;
  const int pre_step = a.pre_step;
  const int Hh = H / 2;
  const int dpitch = bwd_dps_pitch<S>(H), xpitch = bwd_xb_pitch(H);
  S* ws = reinterpret_cast<S*>(smem);  // fp32 [2H][H]: own gate column, then unit; bf16 fragments
  S* dps = ws + 2 * H * H;             // [RT][dpitch]
  float* xb = reinterpret_cast<float*>(dps + RT * dpitch);  // [2][kLow ? 2 : 1][RT][xpitch]
  constexpr int kSlots = kLow ? 2 : 1;
  uint64_t* bar = reinterpret_cast<uint64_t*>(xb + 2 * kSlots * RT * xpitch);

  const unsigned c = cluster_rank();
  const int d = blockIdx.z;
  const int row0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int rg = tid & 7;          // rows rg + 8 r
  const int u0 = (tid >> 3) * UW;  // units u0..u0+UW-1 of either half
  const int gu = c * Hh + u0;      // this thread's own units of all H
  const bool down = d == 0 || a.down1;

  load_resident(reinterpret_cast<float*>(ws),
                static_cast<const float*>(a.wsplit) +
                    (d * 2 + c) * static_cast<long long>(2 * H) * H * sizeof(S) / 4,
                static_cast<unsigned>(2 * H * H * sizeof(S)), bar);

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
    if constexpr (kTM) return p + (static_cast<long long>(t) * R + gr) * H + gu;
    else return p + static_cast<long long>(gr) * (Tn * H) + t * H + gu;
  };
  auto gate_off = [&](int gr, int t) {
    if constexpr (kTM) return d * pre_dir + (static_cast<long long>(t) * R + gr) * pre_step + gu;
    else return d * pre_dir + (static_cast<long long>(gr) * Tn + t) * pre_step + gu;
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
          for (int g = 0; g < 4; ++g) dbacc[g][j] += v[g][j];
        }
      }
      // stored in the stream type: bf16 rounds dpre here, once
      S* dp = dps + row * dpitch + u0;
#pragma unroll
      for (int g = 0; g < 4; ++g) st2(dp + g * Hh, v[g]);
      if (gr < R) {
        S* gp = dpre + gate_off(gr, t);
#pragma unroll
        for (int g = 0; g < 4; ++g) st2(gp + g * H, v[g]);
      }
    }
    if (s + 1 < t_end) fetch(down ? t - 1 : t + 1);
    __syncthreads();  // the dpre tile is complete

    float* xn = xb + ((s + 1) & 1) * kSlots * RT * xpitch;
    if constexpr (kLow) {
      // partial dh = dpre_s @ W^T slice for units 16 w .. 16 w + 15 of all H
      // (n-tiles 2 w and 2 w + 1) and every m-tile: A rows 16 mt + (lane &
      // 15), k 16 ks + 8 (lane >> 4) by ldmatrix; B from the fragment-ordered
      // slice, a lane's two n-tiles' registers one 16-byte load
      constexpr int MT = NR / 2;
      const int lane = tid & 31, w = tid >> 5;
      const int lg = lane >> 2, lt = lane & 3;
      const int ngroups = H / 16;
      float acc[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      const S* ap = dps + (lane & 15) * dpitch + 8 * (lane >> 4);
      const S* wl = ws + (w * 32 + lane) * 8;
#pragma unroll 2
      for (int ks = 0; ks < H / 8; ++ks) {
        const uint4 b = *reinterpret_cast<const uint4*>(wl + ks * ngroups * 256);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t af[4];
          tf32_mma::ldmatrix_x4_b16(af, ap + 16 * mt * dpitch + 16 * ks);
          tf32_mma::mma_bf16(acc[mt][0], af, b.x, b.y);
          tf32_mma::mma_bf16(acc[mt][1], af, b.z, b.w);
        }
      }
      // fragment (mt, nt) holds rows 16 mt + lg (q = 0, 1) and + 8 (q = 2,
      // 3), units 16 w + 8 nt + 2 lt + (q & 1): into slot c of the exchange
      // buffer of the CTA that owns them (H / 2 is a multiple of 8, so an
      // n-tile's units lie in one half)
      const unsigned to0 = map_rank(xn + c * RT * xpitch, 0u);
      const unsigned to1 = map_rank(xn + c * RT * xpitch, 1u);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int u = 16 * w + 8 * nt + 2 * lt;
        const bool second = u >= Hh;
        const unsigned base = (second ? to1 : to0) + 4 * (second ? u - Hh : u);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float send[UW] = {acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]};
            st2_cluster(base + 4 * (16 * mt + lg + 8 * hh) * xpitch, send);
          }
      }
      cluster_sync();  // the partials arrived; this step's reads of the dpre tile are done
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float p0[UW], p1[UW];
        ld2(xn + (rg + 8 * r) * xpitch + u0, p0);
        ld2(xn + (RT + rg + 8 * r) * xpitch + u0, p1);
        if (t < rlen[r]) {
#pragma unroll
          for (int j = 0; j < UW; ++j) dh[r][j] = p0[j] + p1[j];
        }
      }
    } else {
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
  }
  if constexpr (kLow) {  // row rg of this tile, direction d, this thread's 4 gates x 2 units
    const int dirs = gridDim.z;
    float* part = a.dbpart + (static_cast<long long>(blockIdx.y * 8 + rg) * dirs + d) * 4 * H + gu;
#pragma unroll
    for (int g = 0; g < 4; ++g) st2(part + g * H, dbacc[g]);
  }
}

// The scan at a tile height of 16, 24, 32, 40 or 48 rows (bf16: 16, 32 or 48)
// over `dirs` directions; H a multiple of 16, at most 128. Returns a
// cudaError_t code.
template <int NR, typename S, bool kTM>
int launch_bwd_scan(const BwdScanArgs& a, int dirs, cudaStream_t s) {
  const int tiles = (a.R + 8 * NR - 1) / (8 * NR);
  return launch_cluster(bwd_scan_kernel<NR, S, kTM>, tiles, dirs, 2 * a.H, bwd_smem_bytes<S>(NR, a.H),
                        s, a);
}

// dtype: 0 = fp32 streams, 1 = bf16 streams (then dbpart is written). kTM:
// the time-major layout (only the fused pair's backward instantiates it).
template <bool kTM = false>
int bwd_scan(int height, int dtype, const BwdScanArgs& a, int dirs, cudaStream_t s) {
  if (a.H % 16 || a.H > 128 || a.H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (height) {
      case 16: return launch_bwd_scan<2, float, kTM>(a, dirs, s);
      case 24: return launch_bwd_scan<3, float, kTM>(a, dirs, s);
      case 32: return launch_bwd_scan<4, float, kTM>(a, dirs, s);
      case 40: return launch_bwd_scan<5, float, kTM>(a, dirs, s);
      case 48: return launch_bwd_scan<6, float, kTM>(a, dirs, s);
    }
  } else if (dtype == 1 && a.dbpart != nullptr) {
    switch (height) {
      case 16: return launch_bwd_scan<2, __nv_bfloat16, kTM>(a, dirs, s);
      case 32: return launch_bwd_scan<4, __nv_bfloat16, kTM>(a, dirs, s);
      case 48: return launch_bwd_scan<6, __nv_bfloat16, kTM>(a, dirs, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of the scan at this tile height and dtype the card runs
// at once.
template <int NR, typename S>
int bwd_clusters(int H, int* clusters) {
  return max_clusters(bwd_scan_kernel<NR, S, false>, 2 * H, bwd_smem_bytes<S>(NR, H), clusters);
}

inline int bwd_scan_max_clusters(int height, int dtype, int H, int* clusters) {
  if (dtype == 0) {
    switch (height) {
      case 16: return bwd_clusters<2, float>(H, clusters);
      case 24: return bwd_clusters<3, float>(H, clusters);
      case 32: return bwd_clusters<4, float>(H, clusters);
      case 40: return bwd_clusters<5, float>(H, clusters);
      case 48: return bwd_clusters<6, float>(H, clusters);
    }
  } else if (dtype == 1) {
    switch (height) {
      case 16: return bwd_clusters<2, __nv_bfloat16>(H, clusters);
      case 32: return bwd_clusters<4, __nv_bfloat16>(H, clusters);
      case 48: return bwd_clusters<6, __nv_bfloat16>(H, clusters);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cluster_scan
