// Backward of the fused bidirectional LSTM scan for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_bilstm2_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:1224, launched by bilstm2_backward_tm :1429),
// unmasked and masked. Given x [R, T, F], the residual streams of the forward
// (per direction d: h_prev, c_prev, tanh(c), each [R, T, H]) and the output
// cotangents g_d [R, T, H], it computes dx, dW_ih[d], dW_hh[d] and db[d]:
//   gates = x_t @ W_ih[d] + h_prev @ W_hh[d] + b[d]; i, f, o = sigmoid, g = tanh
//   dh = g_t + dh_carry;  dc = dc_carry + dh * o * (1 - tc^2)
//   dpre = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tc*o(1-o)]
//   dh_carry = dpre @ W_hh[d]^T;  dc_carry = dc * f
//   dx = sum_d dpre_d @ W_ih[d]^T; dW_ih[d] = sum x^T dpre_d;
//   dW_hh[d] = sum h_prev^T dpre_d; db[d] = sum dpre_d
// Direction 0 runs t = T-1..0, direction 1 t = 0..T-1 (each the reverse of its
// scan). Masked: steps with t >= len[row] give no dpre and pass the carries
// through, in both directions (direction 1 held its zero state there; out0 past
// the length is unspecified, so its cotangent there is discarded).
//
// What bounds it: the arithmetic, 3 * 2 (F + H) 4H FLOP per row-step and
// direction against 5 H-wide reads and one F-wide write. Only the dh/dc
// recurrence is sequential; everything else is a product over all R * T
// row-steps at once. So the work is split in three kernels:
//   1. gemm_kernel recomputes the gate pre-activations of every row-step
//      ([x | h_prev] @ [W_ih; W_hh] + b) into a [R, T, 2, 4H] buffer;
//   2. scan_kernel, one block per (direction, tile of 32 rows) looping over T
//      with dh and dc in registers, turns them into dpre in place; its only
//      product, dpre @ W_hh^T, streams W_hh^T (256 KB at H = 128, over a
//      block's shared memory) from L2 in double-buffered chunks, as the
//      forward streams W;
//   3. gemm_kernel again for dx (K = 8H over both directions at once) and for
//      dW (split over the row-steps into fixed partials), and colsum_kernel
//      for db. The wrapper sums the partials with torch.sum.
// No float atomics: every sum runs in a fixed order, so a run repeats itself
// bit for bit on one card. The TPU kernel's time and row padding is not
// carried over.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

// ---- tiled fp32 product: C = A1 @ B1 + A2 @ B2 (+ bias) -------------------
constexpr int kBM = 128;  // block tile rows
constexpr int kBN = 128;  // block tile columns
constexpr int kBK = 8;    // k-depth of a shared-memory tile
constexpr int kPad = 4;   // keeps the transposed A stores free of bank conflicts

struct GemmArgs {
  // A part p is [M, K_p]: element (m, k) at a[m * lda + k] (row layout) or
  // a[k * lda + m] (column layout). B part p is [K_p, N] row-major.
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* bias;  // [N] or null
  float* c;           // [splits][M][ldc]
  long long lda1, ldb1, lda2, ldb2, ldc, split_stride;
  int k1, k2, M, N, kps;  // kps: k-range of one split, a multiple of kBK
};

// Grid (ceil(N / 128), ceil(M / 128), splits), 256 threads, each owning 8 x 8
// outputs (rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j).
// The next k-tile is read into registers while the current one is multiplied
// out of shared memory (two buffers, one barrier per tile).
template <bool kACol>
__global__ void __launch_bounds__(256) gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * p.kps;
  const int ke = min(p.k1 + p.k2, kb + p.kps);

  float4 ra, rb;
  // k-tile k0 lies wholly in one part (k1 is a multiple of kBK)
  auto load = [&](int k0) {
    const bool first = k0 < p.k1;
    const float* a = first ? p.a1 : p.a2;
    const float* b = first ? p.b1 : p.b2;
    const long long lda = first ? p.lda1 : p.lda2;
    const long long ldb = first ? p.ldb1 : p.ldb2;
    const int kl = first ? k0 : k0 - p.k1;  // k0 within its part
    const int kend = (first ? min(ke, p.k1) : ke - p.k1) - kl;
    if (kACol) {
      const int k = tid >> 5, m = m0 + (tid & 31) * 4;
      ra = (k < kend && m < p.M) ? ld4(a + (kl + k) * lda + m) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const int m = m0 + (tid >> 1), k = (tid & 1) * 4;
      ra = (k < kend && m < p.M) ? ld4(a + m * lda + kl + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int k = tid >> 5, n = n0 + (tid & 31) * 4;
    rb = (k < kend && n < p.N) ? ld4(b + (kl + k) * ldb + n) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf) {
    if (kACol) {
      st4(&As[buf][tid >> 5][(tid & 31) * 4], ra);
    } else {
      const int m = tid >> 1, k = (tid & 1) * 4;
      As[buf][k + 0][m] = ra.x;
      As[buf][k + 1][m] = ra.y;
      As[buf][k + 2][m] = ra.z;
      As[buf][k + 3][m] = ra.w;
    }
    st4(&Bs[buf][tid >> 5][(tid & 31) * 4], rb);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int buf = 0;
  if (kb < ke) {
    load(kb);
    stash(0);
  }
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const bool more = k0 + kBK < ke;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(&As[buf][kk][ty * 4]), a1 = ld4(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = ld4(&Bs[buf][kk][tx * 4]), b1 = ld4(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* c = p.c + blockIdx.z * p.split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= p.N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (p.bias != nullptr) {
        const float4 bb = ld4(p.bias + n);
        v.x += bb.x;
        v.y += bb.y;
        v.z += bb.z;
        v.w += bb.w;
      }
      st4(c + m * p.ldc + n, v);
    }
  }
}

// ---- column sums: partial[s][n] = sum over rows of split s of a[k][n] -------
__global__ void colsum_kernel(const float* __restrict__ a, long long lda, int K, int N,
                              float* __restrict__ partial, int kps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int kb = blockIdx.y * kps, ke = min(K, kb + kps);
  float sum = 0.f;
  for (int k = kb; k < ke; ++k) sum += a[k * lda + n];
  partial[static_cast<long long>(blockIdx.y) * N + n] = sum;
}

// ---- the sequential reverse scan ------------------------------------------
constexpr int kRows = 32;    // rows per block
constexpr int kWChunk = 32;  // k-rows of W_hh^T per shared-memory chunk

// Grid (ceil(R / 32), 2): blockIdx.y is the direction. Threads: 2H (8 row
// groups x H/4 unit groups); each thread owns rows rg + 8r (r < 4) and hidden
// units u4..u4+3 with all four gates of each, as in the forward kernel.
// gd: [R, T, 2, 4H], gate pre-activations in, dpre out. cp_d, tc_d, g_d:
// [R, T, H]. wt: [2, 4H, H] = W_hh[d]^T. lens: [R] or null.
__global__ void __launch_bounds__(256, 2)
scan_kernel(float* __restrict__ gd, const float* __restrict__ cp0, const float* __restrict__ tc0,
            const float* __restrict__ g0, const float* __restrict__ cp1,
            const float* __restrict__ tc1, const float* __restrict__ g1,
            const float* __restrict__ wt, const int* __restrict__ lens, int R, int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int dpp = G + 4;  // padded row pitch of the dpre tile
  float* dps = reinterpret_cast<float*>(smem);  // [kRows][dpp]
  float* ws = dps + kRows * dpp;                // two chunks of [kWChunk][H]

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int rg = lane & 7;
  const int u4 = ((tid >> 5) * 4 + (lane >> 3)) * 4;
  const float* wtd = wt + static_cast<long long>(d) * G * H;

  // steps t < rlen[r] are live (rows past R have none); the tile's longest row
  int rlen[4];
  int tile_len = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + rg + 8 * r;
    rlen[r] = gr < R ? Tn : 0;
    if (lens != nullptr && gr < R) rlen[r] = min(max(lens[gr], 0), Tn);
    tile_len = max(tile_len, rlen[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tile_len = max(tile_len, __shfl_xor_sync(0xffffffffu, tile_len, off));
  const int t_end = lens != nullptr ? tile_len : Tn;

  // the gate pre-activations of (row, t) for this direction
  auto g_at = [&](int gr, int t) {
    return gd + (static_cast<long long>(gr) * Tn + t) * (2 * G) + d * G;
  };
  auto h_at = [&](const float* p0, const float* p1, int gr, int t) {
    return (d == 0 ? p0 : p1) + (static_cast<long long>(gr) * Tn + t) * H + u4;
  };

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // steps past every row's length give no dpre
  for (int t = t_end; t < Tn; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + rg + 8 * r;
      if (gr < R) {
        float* gp = g_at(gr, t) + u4;
#pragma unroll
        for (int q = 0; q < 4; ++q) st4(gp + q * H, zero4);
      }
    }
  }
  if (t_end == 0) return;

  const int chunk_vecs = kWChunk * H / 4;
  auto load_w = [&](int chunk, int buf) {
    const float* src = wtd + static_cast<long long>(chunk) * kWChunk * H;
    float* dst = ws + buf * kWChunk * H;
    for (int v = tid; v < chunk_vecs; v += nthreads) cp_async16(dst + 4 * v, src + 4 * v);
  };
  const int n_chunks = G / kWChunk;
  int q = 0;  // chunks issued so far; chunk q % n_chunks sits in buffer q % 2
  load_w(0, 0);
  cp_async_commit();

  float dh[4][4], dc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dh[r][j] = dc[r][j] = 0.f;

  for (int s = 0; s < t_end; ++s) {
    const int t = d == 0 ? t_end - 1 - s : s;
    __syncthreads();  // every thread is done with the last step's dpre tile
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rg + 8 * r;
      const int gr = row0 + row;
      const bool live = t < rlen[r];
      float4 gi = zero4, gf = zero4, gg = zero4, go = zero4, cpv = zero4, tcv = zero4, gv = zero4;
      float* gp = nullptr;
      if (gr < R) {
        gp = g_at(gr, t) + u4;
        gi = ld4(gp);
        gf = ld4(gp + H);
        gg = ld4(gp + 2 * H);
        go = ld4(gp + 3 * H);
        cpv = ld4(h_at(cp0, cp1, gr, t));
        tcv = ld4(h_at(tc0, tc1, gr, t));
        gv = ld4(h_at(g0, g1, gr, t));
      }
      float pi[4], pf[4], pg[4], po[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ig = sigmoid_f(comp(gi, j));
        const float fg = sigmoid_f(comp(gf, j));
        const float ggv = tanhf(comp(gg, j));
        const float og = sigmoid_f(comp(go, j));
        const float tc = comp(tcv, j);
        const float dhv = comp(gv, j) + dh[r][j];
        const float dcv = dc[r][j] + dhv * (og * (1.0f - tc * tc));
        pi[j] = live ? dcv * (ggv * ig * (1.0f - ig)) : 0.f;
        pf[j] = live ? dcv * (comp(cpv, j) * fg * (1.0f - fg)) : 0.f;
        pg[j] = live ? dcv * (ig * (1.0f - ggv * ggv)) : 0.f;
        po[j] = live ? dhv * (tc * og * (1.0f - og)) : 0.f;
        if (live) dc[r][j] = dcv * fg;
      }
      float* dp = dps + row * dpp + u4;
      st4(dp, make_float4(pi[0], pi[1], pi[2], pi[3]));
      st4(dp + H, make_float4(pf[0], pf[1], pf[2], pf[3]));
      st4(dp + 2 * H, make_float4(pg[0], pg[1], pg[2], pg[3]));
      st4(dp + 3 * H, make_float4(po[0], po[1], po[2], po[3]));
      if (gp != nullptr) {
        st4(gp, make_float4(pi[0], pi[1], pi[2], pi[3]));
        st4(gp + H, make_float4(pf[0], pf[1], pf[2], pf[3]));
        st4(gp + 2 * H, make_float4(pg[0], pg[1], pg[2], pg[3]));
        st4(gp + 3 * H, make_float4(po[0], po[1], po[2], po[3]));
      }
    }

    // dh_carry = dpre @ W_hh^T over the tile, W_hh^T streamed in chunks
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++q) {
      cp_async_wait_all();
      __syncthreads();  // chunk q and the dpre tile landed; buffer (q + 1) % 2 is free
      load_w((chunk + 1) % n_chunks, (q + 1) & 1);
      cp_async_commit();
      const float* wc = ws + (q & 1) * kWChunk * H;
      const int k0 = chunk * kWChunk;
#pragma unroll
      for (int kk = 0; kk < kWChunk; kk += 4) {
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = ld4(dps + (rg + 8 * r) * dpp + k0 + kk);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float4 w = ld4(wc + (kk + qq) * H + u4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float av = comp(a[r], qq);
            acc[r][0] = fmaf(av, w.x, acc[r][0]);
            acc[r][1] = fmaf(av, w.y, acc[r][1]);
            acc[r][2] = fmaf(av, w.z, acc[r][2]);
            acc[r][3] = fmaf(av, w.w, acc[r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (t < rlen[r]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[r][j] = acc[r][j];
      }
    }
  }
  cp_async_wait_all();  // the last step prefetched a chunk nobody reads
}

}  // namespace

extern "C" {

// C = A1 @ B1 + A2 @ B2 (+ bias), fp32. a_col: 0 = A row layout, 1 = column
// layout (see GemmArgs). With splits > 1 the k-range is cut into splits of
// kps (a multiple of 8) and split s writes its partial to c + s * split_stride.
// With a second part (k2 > 0) k1 must be a multiple of 8; in row layout k1, k2
// and lda multiples of 4, in column layout M and lda; N, ldb and ldc multiples
// of 4; every pointer 16-byte aligned. Returns a cudaError_t code (0 =
// launched).
int bilstm2_bwd_gemm(int a_col, const void* a1, long long lda1, const void* b1, long long ldb1,
                     int k1, const void* a2, long long lda2, const void* b2, long long ldb2,
                     int k2, const void* bias, void* c, long long ldc, int M, int N, int splits,
                     int kps, long long split_stride, void* stream) {
  GemmArgs p;
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.bias = static_cast<const float*>(bias);
  p.c = static_cast<float*>(c);
  p.lda1 = lda1;
  p.ldb1 = ldb1;
  p.lda2 = lda2;
  p.ldb2 = ldb2;
  p.ldc = ldc;
  p.split_stride = split_stride;
  p.k1 = k1;
  p.k2 = k2;
  p.M = M;
  p.N = N;
  p.kps = kps;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_col)
    gemm_kernel<true><<<grid, 256, 0, s>>>(p);
  else
    gemm_kernel<false><<<grid, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// partial[s][n] = sum of a[k][n] over k in [s * kps, (s + 1) * kps), k < K.
int bilstm2_bwd_colsum(const void* a, long long lda, int K, int N, void* partial, int splits,
                       int kps, void* stream) {
  dim3 grid((N + 255) / 256, splits);
  colsum_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), lda, K, N, static_cast<float*>(partial), kps);
  return static_cast<int>(cudaGetLastError());
}

// The reverse scan: gd [R, T, 2, 4H] holds the gate pre-activations and gets
// dpre in place. cp_d, tc_d, g_d: [R, T, H]; wt: [2, 4H, H]; lens: [R] int32
// or null. All fp32, contiguous, 16-byte aligned; H a multiple of 16, <= 128.
int bilstm2_bwd_scan(void* gd, const void* cp0, const void* tc0, const void* g0, const void* cp1,
                     const void* tc1, const void* g1, const void* wt, const void* lens, int R,
                     int Tn, int H, void* stream) {
  const size_t smem = (kRows * (4 * H + 4) + 2 * kWChunk * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kRows - 1) / kRows, 2);
  scan_kernel<<<grid, 2 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(gd), static_cast<const float*>(cp0), static_cast<const float*>(tc0),
      static_cast<const float*>(g0), static_cast<const float*>(cp1),
      static_cast<const float*>(tc1), static_cast<const float*>(g1),
      static_cast<const float*>(wt), static_cast<const int*>(lens), R, Tn, H);
  return static_cast<int>(cudaGetLastError());
}

const char* bilstm2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
