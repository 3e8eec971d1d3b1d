// Backward of the fused bidirectional LSTM scan for Hopper (sm_90a), fp32: the
// reverse dh/dc scan, with W_hh^T resident in the shared memory of a 2-CTA
// cluster.
//
// Replaces the TPU kernel `_bilstm2_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:1224, launched by bilstm2_backward_tm :1429),
// unmasked and masked. Given the forward's gate pre-activations pre
// [R, T, 2, 4H] (saved by csrc/bilstm2_resid.cu, not recomputed), its c_prev
// and tanh(c) streams and the output cotangents g_d [R, T, H], per direction d:
//   i, f, o = sigmoid, g = tanh of pre[:, t, d]
//   dh = g_t + dh_carry;  dc = dc_carry + dh * o * (1 - tc^2)
//   dpre = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tc*o(1-o)]
//   dh_carry = dpre @ W_hh[d]^T;  dc_carry = dc * f
// into a separate buffer dpre [R, T, 2, 4H] (pre stays as saved, so a second
// backward gives the same result). dx = sum_d dpre_d @ W_ih[d]^T, dW_ih, dW_hh
// and db are products over all row-steps at once and run in csrc/products.cu.
// Direction 0 runs t = T-1..0, direction 1 t = 0..T-1 (each the reverse of its
// scan). Masked: steps with t >= len[row] give no dpre and pass the carries
// through, in both directions (direction 1 held its zero state there; out0 past
// the length is unspecified, so its cotangent there is discarded).
//
// What bounds it: the fp32 FMAs of dpre @ W_hh^T, 2 * 4H * H FLOP per
// row-step and direction, and the step-to-step dependency.
//
// Design: one 2-CTA cluster per (direction, tile of 8 NR rows), as the
// forward. CTA c owns hidden units [c H/2, (c + 1) H/2): it forms dpre for
// its units' four gates (2H columns) and keeps the matching 2H rows of
// W_hh[d]^T ([2H][H], 128 KB at H = 128) in shared memory for the whole
// scan, loaded once by bulk copies on an mbarrier. Its product gives a
// partial dh over all H units; it keeps the half it owns in registers and
// sends the partner the other half through distributed shared memory into
// exchange buffer (t + 1) % 2, then one cluster barrier ends the step. Each
// unit's dh is its two partials summed once, in a fixed order (fp32 addition
// of two terms is commutative), so a run repeats itself bit for bit; no float
// atomics. The next step's inputs are loaded into registers while the product
// runs.

#include "cluster_scan.cuh"

namespace {

using namespace scan_common;
using namespace cluster_scan;

constexpr int UW = 2;  // hidden units per thread (ld2, st2): 2H threads

__host__ __device__ constexpr int dps_pitch(int H) { return 2 * H + 4; }
__host__ __device__ constexpr int xb_pitch(int H) { return H / 2 + 4; }

// shared memory of one CTA: W^T slice, the dpre tile, two exchange buffers
// and the mbarrier
constexpr size_t smem_bytes(int nr, int H) {
  return (static_cast<size_t>(2 * H) * H + 8 * nr * dps_pitch(H) + 2 * 8 * nr * xb_pitch(H)) *
             sizeof(float) + sizeof(uint64_t);
}

// Grid (2, tiles, 2) in clusters of (2, 1, 1); 2H threads, each owning NR
// rows x UW = 2 units (x 4 gates for dpre, of both halves for the product).
// pre, dpre: [R, T, 2, 4H]. cp_d, tc_d, g_d: [R, T, H]. wsplit: [2 d, 2 c, 4,
// H / 2, H], CTA (d, c)'s rows of W_hh[d]^T contiguous. lens: [R] or null.
template <int NR>
__global__ void __launch_bounds__(256, 1)
bwd_scan_kernel(const float* __restrict__ pre, float* __restrict__ dpre,
                const float* __restrict__ cp0, const float* __restrict__ tc0,
                const float* __restrict__ g0, const float* __restrict__ cp1,
                const float* __restrict__ tc1, const float* __restrict__ g1,
                const float* __restrict__ wsplit, const int* __restrict__ lens, int R, int Tn,
                int H) {
  constexpr int RT = 8 * NR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H, Hh = H / 2;
  const int dpitch = dps_pitch(H), xpitch = xb_pitch(H);
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

  load_resident(ws, wsplit + (d * 2 + c) * static_cast<long long>(2 * H) * H,
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

  const float* cpd = d == 0 ? cp0 : cp1;
  const float* tcd = d == 0 ? tc0 : tc1;
  const float* gd = d == 0 ? g0 : g1;
  auto at = [&](const float* p, int gr, int t) {
    return p + static_cast<long long>(gr) * (Tn * H) + t * H + gu;
  };
  auto gate_off = [&](int gr, int t) {
    return (static_cast<long long>(gr) * Tn + t) * (2 * G) + d * G + gu;
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
  if (t_end > 0) fetch(d == 0 ? t_end - 1 : 0);

  float dh[NR][UW], dc[NR][UW];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int j = 0; j < UW; ++j) dh[r][j] = dc[r][j] = 0.f;

  cluster_sync();     // both CTAs run; the mbarrier is initialised
  mbar_wait(bar, 0);  // the W^T slice landed

  for (int s = 0; s < t_end; ++s) {
    const int t = d == 0 ? t_end - 1 - s : s;
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
    if (s + 1 < t_end) fetch(d == 0 ? t - 1 : t + 1);
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
      float4 a[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) a[r] = ld4(dps + (rg + 8 * r) * dpitch + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w0[UW], w1[UW];
        ld2(ws + (k + kk) * H + u0, w0);
        ld2(ws + (k + kk) * H + Hh + u0, w1);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float av = comp(a[r], kk);
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
}

template <int NR>
int launch(const void* pre, void* dpre, const void* cp0, const void* tc0, const void* g0,
           const void* cp1, const void* tc1, const void* g1, const void* wsplit, const void* lens,
           int R, int Tn, int H, cudaStream_t s) {
  const int tiles = (R + 8 * NR - 1) / (8 * NR);
  return launch_cluster(bwd_scan_kernel<NR>, tiles, 4 * H / UW, smem_bytes(NR, H), s,
                        static_cast<const float*>(pre), static_cast<float*>(dpre),
                        static_cast<const float*>(cp0), static_cast<const float*>(tc0),
                        static_cast<const float*>(g0), static_cast<const float*>(cp1),
                        static_cast<const float*>(tc1), static_cast<const float*>(g1),
                        static_cast<const float*>(wsplit), static_cast<const int*>(lens), R, Tn,
                        H);
}

int dispatch(int height, const void* pre, void* dpre, const void* cp0, const void* tc0,
             const void* g0, const void* cp1, const void* tc1, const void* g1, const void* wsplit,
             const void* lens, int R, int Tn, int H, cudaStream_t s) {
  switch (height) {
    case 16: return launch<2>(pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H, s);
    case 24: return launch<3>(pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H, s);
    case 32: return launch<4>(pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H, s);
    case 40: return launch<5>(pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H, s);
    case 48: return launch<6>(pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int occupancy(int height, int H, int* clusters) {
  const int threads = 4 * H / UW;
  switch (height) {
    case 16: return max_clusters(bwd_scan_kernel<2>, threads, smem_bytes(2, H), clusters);
    case 24: return max_clusters(bwd_scan_kernel<3>, threads, smem_bytes(3, H), clusters);
    case 32: return max_clusters(bwd_scan_kernel<4>, threads, smem_bytes(4, H), clusters);
    case 40: return max_clusters(bwd_scan_kernel<5>, threads, smem_bytes(5, H), clusters);
    case 48: return max_clusters(bwd_scan_kernel<6>, threads, smem_bytes(6, H), clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The reverse scan. height: rows per tile, one of 16, 24, 32, 40, 48. pre:
// [R, T, 2, 4H], the forward's gate pre-activations; dpre: [R, T, 2, 4H] out.
// cp_d, tc_d, g_d: [R, T, H]; wsplit: W_hh^T laid out [2, 2, 4, H / 2, H]
// (direction, half, gate, unit, k); lens: [R] int32 or null. All fp32,
// contiguous, 16-byte aligned; H a multiple of 16, at most 128. Returns a
// cudaError_t code (0 = launched).
int bilstm2_bwd_scan(int height, const void* pre, void* dpre, const void* cp0, const void* tc0,
                     const void* g0, const void* cp1, const void* tc1, const void* g1,
                     const void* wsplit, const void* lens, int R, int Tn, int H, void* stream) {
  if (H % 16 || H > 128 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(height, pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, R, Tn, H,
                  static_cast<cudaStream_t>(stream));
}

// How many clusters of the scan at this tile height the card runs at once.
int bilstm2_bwd_max_clusters(int height, int H, int* clusters) {
  return occupancy(height, H, clusters);
}

const char* bilstm2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
