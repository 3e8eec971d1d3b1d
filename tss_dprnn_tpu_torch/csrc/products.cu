// The fp32 product and column-sum kernels of the LSTM training kernels, for
// Hopper (sm_90a).
//
// Every product of the training pair outside its sequential scans runs here:
// the fused bidirectional forward's input product P = x @ [W_ih[0] | W_ih[1]]
// + b (ops/bilstm2.py), its backward's dx, dW_ih and dW_hh, and the
// stacked-direction backward's gates, dx, dW_ih and dW_hh (ops/lstm.py). The
// TPU kernels compute these products inside their own bodies
// (`_bilstm2_kernel`, `_bilstm2_bwd_kernel`, `_lstm_bwd_kernel` in
// tss_dprnn_tpu/ops/pallas_lstm.py); on the card they are products over all
// row-steps at once.
//
// What bounds it: the fp32 FMA pipe (no tensor cores: the lane is fp32). At
// the training shapes every product is far above the card's bandwidth line
// (K >= 128 on both sides of every tile).
//
// Design: C = A1 @ B1 + A2 @ B2 (+ bias) with 128 x 128 block tiles and
// 16-deep k-tiles, 256 threads of 8 x 8 outputs each (warp tile 64 x 32). A
// ring of kStages k-tiles in shared memory is filled by cp.async a few tiles
// ahead, one barrier per k-tile. A in row layout (k contiguous) is kept as
// it arrives, [m][k]: each thread owns rows lm + 8 i and reads four k at a
// time with one 16-byte load per row, so nothing is transposed through
// registers. A in column layout (m contiguous) is kept [k][m] and each
// thread owns two groups of four contiguous rows. B is [k][n] either way.
// A split over k writes fixed partials that the wrapper sums in a fixed
// order: no float atomics, so a run repeats itself bit for bit.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kBM = 128;    // block tile rows
constexpr int kBN = 128;    // block tile columns
constexpr int kBK = 16;     // k-depth of a shared-memory tile
constexpr int kStages = 4;  // k-tiles in flight
constexpr int kPitchCol = kBM + 4;  // [k][m] and [k][n] tiles
constexpr int kPitchRow = kBK + 4;  // [m][k] tile: 8 rows 8 apart hit 8 bank quads
static_assert(kBM == kBN && kBK % 16 == 0, "the copy loop assumes square tiles, kBK % 16 == 0");
constexpr int kATile = kBM * kPitchRow > kBK * kPitchCol ? kBM * kPitchRow : kBK * kPitchCol;
constexpr int kBTile = kBK * kPitchCol;
constexpr int kSmemBytes = kStages * (kATile + kBTile) * sizeof(float);

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

template <bool kACol>
__global__ void __launch_bounds__(256, 2) gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                     // kStages x kATile
  float* Bs = smem + kStages * kATile;  // kStages x kBTile
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile 64 x 32
  const int lm = lane >> 2, ln = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * p.kps;
  const int ke = min(p.k1 + p.k2, kb + p.kps);
  const int ntiles = (ke - kb + kBK - 1) / kBK;

  // copy k-tile `it` of this split into ring slot `slot`; a k-tile lies
  // wholly in one part (k1 is a multiple of kBK); out-of-range elements are
  // zero-filled
  auto load = [&](int it, int slot) {
    const int k0 = kb + it * kBK;
    const bool first = k0 < p.k1;
    const float* a = first ? p.a1 : p.a2;
    const float* b = first ? p.b1 : p.b2;
    const long long lda = first ? p.lda1 : p.lda2;
    const long long ldb = first ? p.ldb1 : p.ldb2;
    const int kl = first ? k0 : k0 - p.k1;                       // k0 within its part
    const int kend = (first ? min(ke, p.k1) : ke - p.k1) - kl;   // valid k of this tile
    float* as = As + slot * kATile;
    float* bs = Bs + slot * kBTile;
#pragma unroll
    for (int v = tid; v < kBM * kBK / 4; v += 256) {
      if (kACol) {  // kBK k x 32 float4 of m
        const int k = v / (kBM / 4), m = v % (kBM / 4) * 4;
        const bool ok = k < kend && m0 + m < p.M;
        cp_async16(as + k * kPitchCol + m, ok ? a + (kl + k) * lda + m0 + m : a, ok ? 16 : 0);
      } else {      // 128 m x kBK / 4 float4 of k
        const int m = v / (kBK / 4), k = v % (kBK / 4) * 4;
        const bool ok = k < kend && m0 + m < p.M;
        cp_async16(as + m * kPitchRow + k, ok ? a + (m0 + m) * lda + kl + k : a, ok ? 16 : 0);
      }
      const int k = v / (kBN / 4), n = v % (kBN / 4) * 4;
      const bool ok = k < kend && n0 + n < p.N;
      cp_async16(bs + k * kPitchCol + n, ok ? b + (kl + k) * ldb + n0 + n : b, ok ? 16 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  const int nb = wn * 32 + ln * 4;  // columns nb..nb+3 and nb+16..nb+19
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; every thread is done with tile it - 1's slot
    if (it + kStages - 1 < ntiles) load(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = As + (it % kStages) * kATile;
    const float* bs = Bs + (it % kStages) * kBTile;
    if (kACol) {
      const int mb = wm * 64 + lm * 4;  // rows mb..mb+3 and mb+32..mb+35
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = ld4(as + kk * kPitchCol + mb), a1 = ld4(as + kk * kPitchCol + mb + 32);
        const float4 b0 = ld4(bs + kk * kPitchCol + nb), b1 = ld4(bs + kk * kPitchCol + nb + 16);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else {
      const float* arow = as + (wm * 64 + lm) * kPitchRow;  // rows wm*64 + lm + 8i
#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a4[i] = ld4(arow + 8 * i * kPitchRow + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 = ld4(bs + (kq + kk) * kPitchCol + nb);
          const float4 b1 = ld4(bs + (kq + kk) * kPitchCol + nb + 16);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = comp(a4[i], kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the last commits were empty

  float* c = p.c + blockIdx.z * p.split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (kACol ? wm * 64 + (i < 4 ? lm * 4 + i : 32 + lm * 4 + i - 4)
                              : wm * 64 + lm + 8 * i);
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + nb + 16 * h;
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

template <bool kACol>
int launch_gemm(const GemmArgs& p, dim3 grid, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kACol>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<kACol><<<grid, 256, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// C = A1 @ B1 + A2 @ B2 (+ bias), fp32. a_col: 0 = A row layout, 1 = column
// layout (see GemmArgs). With splits > 1 the k-range is cut into splits of
// kps (a multiple of 16) and split s writes its partial to c + s * split_stride.
// With a second part (k2 > 0) k1 must be a multiple of 16; in row layout k1,
// k2 and lda multiples of 4, in column layout M and lda; N, ldb and ldc
// multiples of 4; every pointer 16-byte aligned. Returns a cudaError_t code
// (0 = launched).
int products_gemm(int a_col, const void* a1, long long lda1, const void* b1, long long ldb1, int k1,
                  const void* a2, long long lda2, const void* b2, long long ldb2, int k2,
                  const void* bias, void* c, long long ldc, int M, int N, int splits, int kps,
                  long long split_stride, void* stream) {
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
  if ((k2 > 0 && k1 % kBK) || kps % kBK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_col ? launch_gemm<true>(p, grid, s) : launch_gemm<false>(p, grid, s);
}

// partial[s][n] = sum of a[k][n] over k in [s * kps, (s + 1) * kps), k < K.
int products_colsum(const void* a, long long lda, int K, int N, void* partial, int splits, int kps,
                    void* stream) {
  dim3 grid((N + 255) / 256, splits);
  colsum_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), lda, K, N, static_cast<float*>(partial), kps);
  return static_cast<int>(cudaGetLastError());
}

const char* products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
