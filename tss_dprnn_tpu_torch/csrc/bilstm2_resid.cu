// The LSTM training forward for Hopper (sm_90a), fp32 streams: the recurrent
// scan, with W_hh resident in the shared memory of a 2-CTA cluster. (bf16
// streams train on the serving scan's mode 3, csrc/bilstm2_serve.cu: h @ W_hh
// as bf16 mma.sync on a bf16 W slice.)
//
// Replaces two TPU kernels in their residual (training) modes:
// - `_bilstm2_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:698, `want_resid`
//   :982), unmasked and masked: the fused bidirectional pair;
// - `_lstm_kernel` (:57, launched by _pallas_core :231, `want_resid`;
//   `lstm_forward_resid`): D stacked directions, each on its own input in
//   forward time.
// The work is split by what is sequential: the input product P of every
// row-step runs first, in csrc/products.cu, into the gate buffer pre (the
// pair's x @ [W_ih[0] | W_ih[1]] + b into [R, T, 2, 4H] in one launch, the
// stack's x[d] @ W_ih[d] + b[d] into [D, R, T, 4H], one launch a direction;
// ScanArgs says where a direction's gates lie); this kernel then runs, per
// direction d,
//   gates = P[d][:, t] + h @ W_hh[d]            (torch gate order i, f, g, o)
//   c = f * c + i * g;  h = o * tanh(c)
// step by step, writes the gate pre-activations back into pre in place (the
// backward reads them and recomputes nothing), the outputs and the residual
// streams: h and c before each step and tanh(c) after it, each [R, T, H] at
// forward time t. Direction 0 scans t = 0..T-1; direction 1 the same, or
// t = T-1..0 for the pair (`reverse1`). Masked (the pair only): the reversed
// direction holds its zero state while t >= len[row], so its output there is
// 0; the other's and every stream past a row's length is unspecified
// (finite), and steps past the tile's longest row write zeros.
//
// What bounds it: the fp32 FMAs of h @ W_hh, 2 H 4H FLOP per row-step and
// direction, and the step-to-step dependency: all parallelism comes from rows
// and directions.
//
// Design: one 2-CTA cluster per (direction, tile of 8 NR rows); the wrapper
// picks NR so that the grid fits the card in one wave where it can. CTA c
// owns hidden units [c H/2, (c + 1) H/2) and keeps, for their four gates, the
// slice W_hh[d][:, gate * H + unit] ([H][2H], 128 KB at H = 128) in shared
// memory for the whole scan, loaded once by bulk copies on an mbarrier;
// nothing of W streams per step. Each of the 2H threads owns NR rows x 2
// units x 4 gates, so the cell update needs no exchange inside the CTA; c
// lives in registers. Two units per thread give two warps per SM
// sub-partition: the faster of the two layouts measured (PERF.md). h ([8 NR][H], both halves) lives in shared memory, double
// buffered: at step t a CTA writes its half of the new h into buffer
// (t + 1) % 2 of both CTAs (the partner's through distributed shared memory),
// then one cluster barrier ends the step; every read of that buffer happened
// before the barrier that ended step t - 1. The step's P slice comes into a
// per-thread staging area by cp.async a step ahead.

#include "cluster_scan.cuh"

namespace {

using namespace scan_common;
using namespace cluster_scan;

constexpr int UW = 2;  // hidden units per thread (ld2, st2): 2H threads

__host__ __device__ constexpr int hs_pitch(int H) { return H + 4; }

// shared memory of one CTA: W slice, two h buffers, the P staging (4 NR x UW
// floats per thread) and the mbarrier
constexpr size_t smem_bytes(int nr, int H) {
  return (static_cast<size_t>(H) * 2 * H + 2 * 8 * nr * hs_pitch(H) + 16 * nr * H) * sizeof(float) +
         sizeof(uint64_t);
}

// Where the scan finds a direction's row-steps: gate column j of direction d
// at row-step (gr, t) is pre[d * pre_dir + (gr * Tn + t) * pre_step + j] (P
// in, the gate pre-activations out), unit u of its output and streams
// out[d][(gr * Tn + t) * H + u] (hp, cp, tc likewise). Direction 1 runs
// t = T-1..0 when `reverse1`, else t = 0..T-1 as direction 0 does.
struct ScanArgs {
  float* pre;
  const float* wsplit;  // [dirs d, 2 c, H, 4, H / 2], CTA (d, c)'s W slice contiguous
  const int* lens;      // [R] or null
  float* out[2];        // the H-wide outputs and streams
  float* hp[2];
  float* cp[2];
  float* tc[2];
  long long pre_dir;
  int pre_step;
  int reverse1;
  int R, Tn, H;
};

// Grid (2, tiles, dirs) in clusters of (2, 1, 1); 2H threads, each owning NR
// rows x UW = 2 units x 4 gates.
template <int NR>
__global__ void __launch_bounds__(256, 1) resid_scan_kernel(const ScanArgs a) {
  constexpr int RT = 8 * NR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, Tn = a.Tn, H = a.H;
  const int* __restrict__ lens = a.lens;
  const int Hh = H / 2, G2 = 2 * H;
  const int hpitch = hs_pitch(H);
  float* ws = reinterpret_cast<float*>(smem);  // [H][2H]: k, then gate-major own units
  float* hs = ws + H * G2;                     // [2][RT][hpitch]
  float* stg = hs + 2 * RT * hpitch;           // [4 NR][nthreads][UW]
  uint64_t* bar = reinterpret_cast<uint64_t*>(stg + 16 * NR * H);

  const unsigned c = cluster_rank();
  const int d = blockIdx.z;
  const bool rev = d == 1 && a.reverse1;  // this direction scans t = T-1..0
  const int row0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rg = tid & 7;          // rows rg + 8 r
  const int u0 = (tid >> 3) * UW;  // units u0..u0+UW-1 of this CTA's half
  const int gu = c * Hh + u0;      // ... of all H

  load_resident(ws, a.wsplit + (d * 2 + c) * static_cast<long long>(H) * G2,
                static_cast<unsigned>(H * G2 * sizeof(float)), bar);

  // per-row lengths and the tile's longest row (every thread reads them all)
  int rlen[NR];
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int gr = row0 + rg + 8 * r;
    rlen[r] = gr < R ? (lens != nullptr ? min(max(lens[gr], 0), Tn) : Tn) : 0;
  }
  for (int i = 0; i < RT && row0 + i < R; ++i)
    t_end = max(t_end, lens != nullptr ? min(max(lens[row0 + i], 0), Tn) : Tn);

  // selects, not a runtime index into the parameter arrays (which would copy
  // them to local memory)
  float* __restrict__ out = d == 0 ? a.out[0] : a.out[1];
  float* __restrict__ hpd = d == 0 ? a.hp[0] : a.hp[1];
  float* __restrict__ cpd = d == 0 ? a.cp[0] : a.cp[1];
  float* __restrict__ tcd = d == 0 ? a.tc[0] : a.tc[1];
  float* __restrict__ pre = a.pre + d * a.pre_dir + gu;
  auto at = [&](float* p, int gr, int t) {
    return p + static_cast<long long>(gr) * (Tn * H) + t * H + gu;
  };
  auto pre_at = [&](int gr, int t) {
    return pre + (static_cast<long long>(gr) * Tn + t) * a.pre_step;
  };

  float zeros[UW];
#pragma unroll
  for (int j = 0; j < UW; ++j) zeros[j] = 0.f;
  for (int t = t_end; t < Tn; ++t) {  // past every row's length
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int gr = row0 + rg + 8 * r;
      if (gr < R) {
        st2(at(out, gr, t), zeros);
        st2(at(hpd, gr, t), zeros);
        st2(at(cpd, gr, t), zeros);
        st2(at(tcd, gr, t), zeros);
#pragma unroll
        for (int g = 0; g < 4; ++g) st2(pre_at(gr, t) + g * H, zeros);
      }
    }
  }

  // the step's P slice into this thread's own staging slots (no barrier
  // needed: a thread reads only what it copied)
  auto stage = [&](int t) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int gr = row0 + rg + 8 * r;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        cp_async8(stg + ((r * 4 + g) * nthreads + tid) * UW,
                       gr < R ? pre_at(gr, t) + g * H : pre, gr < R);
    }
    cp_async_commit();
  };
  if (t_end > 0) stage(rev ? t_end - 1 : 0);
  for (int i = tid; i < RT * hpitch; i += nthreads) hs[i] = 0.f;  // h = 0 in buffer 0
  float cst[NR][UW];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int j = 0; j < UW; ++j) cst[r][j] = 0.f;

  cluster_sync();  // both CTAs run, the mbarrier is initialised, h = 0 is in place
  mbar_wait(bar, 0);  // the W slice landed

  for (int s = 0; s < t_end; ++s) {
    const int t = rev ? t_end - 1 - s : s;
    cp_async_wait_all();
    float acc[4][NR][UW];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) ld2(stg + ((r * 4 + g) * nthreads + tid) * UW, acc[g][r]);
    if (s + 1 < t_end) stage(rev ? t - 1 : t + 1);

    // gates += h @ W_hh[d] for this thread's rows, units and gates
    const float* hb = hs + (s & 1) * RT * hpitch;
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      float4 hv[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) hv[r] = ld4(hb + (rg + 8 * r) * hpitch + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float w[UW];
          ld2(ws + (k + kk) * G2 + g * Hh + u0, w);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float a = comp(hv[r], kk);
#pragma unroll
            for (int j = 0; j < UW; ++j) acc[g][r][j] = fmaf(a, w[j], acc[g][r][j]);
          }
        }
      }
    }

    // the cell update; the new h half goes to both CTAs' next buffer
    float* nb = hs + ((s + 1) & 1) * RT * hpitch;
    const unsigned remote = map_rank(nb, c ^ 1u);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = rg + 8 * r;
      const int gr = row0 + row;
      // the reversed direction holds its zero state until t drops below the
      // row's length
      const bool update = !rev || t < rlen[r];
      float hold[UW], hv[UW], tcv[UW], cb[UW];
      ld2(hb + row * hpitch + gu, hold);
#pragma unroll
      for (int j = 0; j < UW; ++j) {
        const float ig = sigmoid_f(acc[0][r][j]);
        const float fg = sigmoid_f(acc[1][r][j]);
        const float gg = tanhf(acc[2][r][j]);
        const float og = sigmoid_f(acc[3][r][j]);
        const float cn = fg * cst[r][j] + ig * gg;
        tcv[j] = tanhf(cn);
        cb[j] = cst[r][j];
        if (update) cst[r][j] = cn;
        hv[j] = update ? og * tcv[j] : hold[j];
      }
      st2(nb + row * hpitch + gu, hv);
      st2_cluster(remote + 4 * (row * hpitch + gu), hv);
      if (gr < R) {
        float* pp = pre_at(gr, t);
#pragma unroll
        for (int g = 0; g < 4; ++g) st2(pp + g * H, acc[g][r]);
        st2(at(out, gr, t), hv);
        st2(at(hpd, gr, t), hold);
        st2(at(cpd, gr, t), cb);
        st2(at(tcd, gr, t), tcv);
      }
    }
    cluster_sync();  // the next h is complete in both CTAs; this step's reads are done
  }
  cp_async_wait_all();
}

template <int NR>
int launch(const ScanArgs& a, int dirs, cudaStream_t s) {
  const int tiles = (a.R + 8 * NR - 1) / (8 * NR);
  return launch_cluster(resid_scan_kernel<NR>, tiles, dirs, 4 * a.H / UW, smem_bytes(NR, a.H), s,
                        a);
}

int dispatch(int height, const ScanArgs& a, int dirs, cudaStream_t s) {
  switch (height) {
    case 16: return launch<2>(a, dirs, s);
    case 24: return launch<3>(a, dirs, s);
    case 32: return launch<4>(a, dirs, s);
    case 40: return launch<5>(a, dirs, s);
    case 48: return launch<6>(a, dirs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int occupancy(int height, int H, int* clusters) {
  const int threads = 4 * H / UW;
  switch (height) {
    case 16: return max_clusters(resid_scan_kernel<2>, threads, smem_bytes(2, H), clusters);
    case 24: return max_clusters(resid_scan_kernel<3>, threads, smem_bytes(3, H), clusters);
    case 32: return max_clusters(resid_scan_kernel<4>, threads, smem_bytes(4, H), clusters);
    case 40: return max_clusters(resid_scan_kernel<5>, threads, smem_bytes(5, H), clusters);
    case 48: return max_clusters(resid_scan_kernel<6>, threads, smem_bytes(6, H), clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The recurrent scan of the training forward over `dirs` (1 or 2)
// directions, fp32 streams. height: rows per tile, one of 16, 24, 32, 40,
// 48. pre: P (the input product with the bias), overwritten with the gate
// pre-activations;
// direction d's gate column j at row-step (r, t) is pre[d * pre_dir + (r * T +
// t) * pre_step + j]: (4H, 8H) for the pair's [R, T, 2, 4H], (R T 4H, 4H) for
// the stack's [D, R, T, 4H]. wsplit: W_hh laid out [dirs, 2, H, 4, H / 2]
// (direction, half, k, gate, unit). out_d, hp_d, cp_d, tc_d: direction d's
// [R, T, H] (direction 1's unused with one direction). reverse1: direction 1
// scans t = T-1..0. lens: [R] int32 or null (only with reverse1). All fp32,
// contiguous, 16-byte aligned; H a multiple of 16, at most 128. Returns a
// cudaError_t code (0 = launched).
int bilstm2_resid_scan(int height, void* pre, const void* wsplit, const void* lens,
                       void* out0, void* out1, void* hp0, void* cp0, void* tc0, void* hp1,
                       void* cp1, void* tc1, long long pre_dir, int pre_step, int reverse1,
                       int dirs, int R, int Tn, int H, void* stream) {
  if (H % 16 || H > 128 || H <= 0 || dirs < 1 || dirs > 2 || (lens != nullptr && !reverse1))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a = {};
  a.pre = static_cast<float*>(pre);
  a.wsplit = static_cast<const float*>(wsplit);
  a.lens = static_cast<const int*>(lens);
  void* streams[4][2] = {{out0, out1}, {hp0, hp1}, {cp0, cp1}, {tc0, tc1}};
  float** fields[4] = {a.out, a.hp, a.cp, a.tc};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 2; ++d) fields[i][d] = static_cast<float*>(streams[i][d]);
  a.pre_dir = pre_dir;
  a.pre_step = pre_step;
  a.reverse1 = reverse1;
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return dispatch(height, a, dirs, static_cast<cudaStream_t>(stream));
}

// How many clusters of the scan at this tile height the card runs at once.
int bilstm2_resid_max_clusters(int height, int H, int* clusters) {
  return occupancy(height, H, clusters);
}

const char* bilstm2_resid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
