// The fp32-accurate product kernel (3xTF32 on the tensor cores) and the
// column-sum kernel of the LSTM training kernels, for Hopper (sm_90a).
//
// Every product of the training pair outside its sequential scans runs here:
// the fused bidirectional forward's input product P = x @ [W_ih[0] | W_ih[1]]
// + b (ops/bilstm2.py), its backward's dx, dW_ih and dW_hh, and the
// stacked-direction backward's dx, dW_ih and dW_hh (ops/lstm.py). The
// TPU kernels compute these products inside their own bodies
// (`_bilstm2_kernel`, `_bilstm2_bwd_kernel`, `_lstm_bwd_kernel` in
// tss_dprnn_tpu/ops/pallas_lstm.py); on the card they are products over all
// row-steps at once.
//
// What bounds it: the arithmetic. At the training shapes every product is far
// above the card's bandwidth line (K >= 128 on both sides of every tile): the
// input product (M = 242,500, N = 1,024, K = 128) is 6.36e10 FLOP against
// 1.12 GB, 0.33 ms of bytes at 3.35 TB/s but 0.95 ms of FMAs at the fp32
// pipe's 67 TFLOP/s. Only the tensor cores close that gap, and the lane is
// fp32, so the products run as 3xTF32: each fp32 operand is split in
// registers into big = rna_tf32(x) and small = rna_tf32(x - big), and the
// tensor cores accumulate small*big + big*small + big*big in fp32. That
// keeps about 22 mantissa bits (the dropped small*small and the roundings of
// small are below 2^-21 of |a||b|), against fp32's 24, at 3 TF32 products
// per fp32 one: 495 / 3 = 165 TFLOP/s of fp32-equivalent work at most.
//
// The tensor cores' fp32 accumulation truncates: a long chain of mma into one
// accumulator drifts with the chain's length, past cuBLAS fp32 SGEMM's error
// at the training shapes' k-ranges. So each 8-deep k-step's three products
// go into a fresh partial, added to the running sum with an ordinary fp32
// add (round to nearest), and the kernel's error stays below SGEMM's.
//
// Design: C = A1 @ B1 + A2 @ B2 (+ bias) with 128 x 128 block tiles and
// 32-deep k-tiles, 256 threads in 8 warps of 32 x 64 outputs each. A ring of
// kStages k-tiles in shared memory is filled by cp.async a few tiles ahead,
// one barrier per k-tile. A in row layout (k contiguous) is kept as it
// arrives, [m][k]; A in column layout (m contiguous) is kept [k][m], so the
// column-layout products (dW = x^T dpre, reduced over all row-steps) need no
// transpose. B is [k][n] either way. Each warp reads its mma.sync m16n8k8
// fragments from shared memory with scalar loads (the pitches put the 32
// lanes of a fragment load on 32 banks; a row-layout A fragment is one
// ldmatrix), splits them in registers and issues 3 x 16 mma per 8-deep
// k-step: the split A fragments of its two m-tiles stay in registers while
// it walks its eight n-tiles, one split B fragment and one 4-register
// partial at a time, so the fold fits beside the 64 accumulators at 2 blocks
// per SM (128 registers, no spill). A split over k writes fixed partials
// that the wrapper sums in a fixed order: no float atomics, so a run repeats
// itself bit for bit.

#include "tf32_mma.cuh"

namespace {

using namespace scan_common;
using namespace tf32_mma;

constexpr int kBM = 128;    // block tile rows
constexpr int kBN = 128;    // block tile columns
constexpr int kBK = 32;     // k-depth of a shared-memory tile
constexpr int kStages = 3;  // k-tiles in flight
// [k][m] and [k][n] tiles: a fragment load reads 4 k-rows (lane & 3) x 8
// columns (lane >> 2); a pitch of 8 mod 32 puts them on 32 banks
constexpr int kPitchCol = kBM + 8;
// [m][k] tile: 8 rows x 4 k per fragment or ldmatrix phase; a pitch of 4
// mod 32 puts them on 32 banks
constexpr int kPitchRow = kBK + 4;
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
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;  // the warp's 32 x 64 outputs
  const int lg = lane >> 2, lt = lane & 3;  // the fragments' group and thread-in-group
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * p.kps;
  const int ke = min(p.k1 + p.k2, kb + p.kps);
  const int ntiles = (ke - kb + kBK - 1) / kBK;

  // copy k-tile `it` of this split into ring slot `slot`; each k takes its
  // part (k1 is a multiple of 4, so a 16-byte vector of k lies in one part);
  // out-of-range elements are zero-filled
  auto load = [&](int it, int slot) {
    const int k0 = kb + it * kBK;
    float* as = As + slot * kATile;
    float* bs = Bs + slot * kBTile;
#pragma unroll
    for (int v = tid; v < kBM * kBK / 4; v += 256) {
      if (kACol) {  // kBK k x 32 float4 of m
        const int k = v / (kBM / 4), m = v % (kBM / 4) * 4;
        const int kg = k0 + k;
        const bool ok = kg < ke && m0 + m < p.M;
        const float* src = !ok ? p.a1
                           : kg < p.k1 ? p.a1 + kg * p.lda1 + m0 + m
                                       : p.a2 + (kg - p.k1) * p.lda2 + m0 + m;
        cp_async16(as + k * kPitchCol + m, src, ok ? 16 : 0);
      } else {      // 128 m x kBK / 4 float4 of k
        const int m = v / (kBK / 4), k = v % (kBK / 4) * 4;
        const int kg = k0 + k;
        const bool ok = kg < ke && m0 + m < p.M;
        const float* src = !ok ? p.a1
                           : kg < p.k1 ? p.a1 + (m0 + m) * p.lda1 + kg
                                       : p.a2 + (m0 + m) * p.lda2 + (kg - p.k1);
        cp_async16(as + m * kPitchRow + k, src, ok ? 16 : 0);
      }
      const int k = v / (kBN / 4), n = v % (kBN / 4) * 4;
      const int kg = k0 + k;
      const bool ok = kg < ke && n0 + n < p.N;
      const float* src = !ok ? p.b1
                         : kg < p.k1 ? p.b1 + kg * p.ldb1 + n0 + n
                                     : p.b2 + (kg - p.k1) * p.ldb2 + n0 + n;
      cp_async16(bs + k * kPitchCol + n, src, ok ? 16 : 0);
    }
  };

  float acc[2][8][4];  // [16-row m-tile][8-column n-tile][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; every thread is done with tile it - 1's slot
    if (it + kStages - 1 < ntiles) load(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = As + (it % kStages) * kATile;
    const float* bs = Bs + (it % kStages) * kBTile;
    // the column layout's k-steps unrolled in full, the row layout's two at
    // a time: either way the kernel fits 128 registers with no spill
#pragma unroll(kACol ? kBK / 8 : 2)
    for (int ks = 0; ks < kBK; ks += 8) {
      // A fragments of the warp's two m-tiles: (m = lg, lg + 8; k = lt, lt + 4)
      uint32_t abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float a[4];
        if (kACol) {
          const float* ap = as + (ks + lt) * kPitchCol + wm + mt * 16 + lg;
          a[0] = ap[0];
          a[1] = ap[8];
          a[2] = ap[4 * kPitchCol];
          a[3] = ap[4 * kPitchCol + 8];
        } else {  // one ldmatrix: rows wm + mt * 16 + (lane & 15), k ks + 4 (lane >> 4)
          ldmatrix_x4(a, as + (wm + mt * 16 + (lane & 15)) * kPitchRow + ks + 4 * (lane >> 4));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], abig[mt][q], asmall[mt][q]);
      }
      // B fragment of n-tile nt: (k = lt, lt + 4; n = lg)
      const float* bp = bs + (ks + lt) * kPitchCol + wn + lg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bbig[2], bsmall[2];
        split_tf32(bp[nt * 8], bbig[0], bsmall[0]);
        split_tf32(bp[nt * 8 + 4 * kPitchCol], bbig[1], bsmall[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // the small terms first, then big * big, into a fresh partial
          // added to the sum in round-to-nearest (see the header)
          float part[4];
          mma_tf32_first(part, asmall[mt], bbig);
          mma_tf32(part, abig[mt], bsmall);
          mma_tf32(part, abig[mt], bbig);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[q];
        }
      }
    }
  }
  cp_async_wait<0>();  // the last commits were empty

  // fragment (mt, nt) holds rows lg and lg + 8, columns 2 lt and 2 lt + 1
  float* c = p.c + blockIdx.z * p.split_stride;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * lt;
    if (n >= p.N) continue;  // N is a multiple of 4: n + 1 < N too
    float2 bb = make_float2(0.f, 0.f);
    if (p.bias != nullptr) bb = *reinterpret_cast<const float2*>(p.bias + n);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + lg + 8 * h;
        if (m < p.M)
          *reinterpret_cast<float2*>(c + m * p.ldc + n) =
              make_float2(acc[mt][nt][2 * h] + bb.x, acc[mt][nt][2 * h + 1] + bb.y);
      }
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

// C = A1 @ B1 + A2 @ B2 (+ bias), fp32 in and out, 3xTF32 on the tensor
// cores. a_col: 0 = A row layout, 1 = column layout (see GemmArgs). With
// splits > 1 the k-range is cut into splits of kps (a multiple of 32) and
// split s writes its partial to c + s * split_stride (a bias is added to
// every partial: pass it with one split only).
// With a second part (k2 > 0) k1 must be a multiple of 4; in row layout k1,
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
  if ((k2 > 0 && k1 % 4) || kps % kBK) return static_cast<int>(cudaErrorInvalidValue);
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
