// The product kernels of the LSTM kernels, for Hopper (sm_90a): the
// fp32-accurate one (3xTF32 on the tensor cores), the bf16-operand one, and
// the column-sum kernel.
//
// Every product of the LSTM scans outside their sequential recurrences runs
// here: the input products P = x @ W_ih + b of the serving and training
// forwards (ops/bilstm2.py, ops/lstm.py), the fused backward's dx, dW_ih and
// dW_hh, and the stacked-direction backward's. The TPU kernels compute these
// products inside their own bodies (`_bilstm2_kernel`, `_bilstm2_bwd_kernel`,
// `_lstm_kernel`, `_lstm_bwd_kernel`, and the input half of the gates of
// `_lstm_manual_kernel` :275 and `_bilstm2_bm_kernel` :1088 in
// tss_dprnn_tpu/ops/pallas_lstm.py); on the card they are products over all
// row-steps at once, each followed by a scan of csrc/bilstm2_serve.cu,
// bilstm2_resid.cu, bilstm2_bwd.cu or lstm_bwd.cu.
//
// What bounds the 3xTF32 kernel: the arithmetic. At the training shapes every product is far
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
// Its design: C = A1 @ B1 + A2 @ B2 (+ bias) with 128 x 128 block tiles and
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
//
// The bf16-operand product (bf16_gemm_kernel, products_gemm_bf16) serves the
// bf16 streams of `_lstm_manual_kernel`'s, `_bilstm2_bm_kernel`'s and
// `_lstm_kernel`'s `reverse_dir1` counterparts (ops/lstm.lstm_scan_v2,
// bilstm_v2, bilstm_fused; ops/bilstm2.bilstm2_forward_bm) and of the dense
// mode (ops/bilstm2.bilstm2_dense_forward), which runs it twice more for the
// SplitDense products y_d = h_d @ wo[d] of `_bilstm2_kernel`'s epilogue
// (pallas_lstm.py:766-769, :813-816) with a bf16 C, rounded once from the
// fp32 sum as the TPU kernel's jnp.dot(h, wo, preferred_element_type=f32)
// .astype(bf16) rounds. x and W_ih hold bf16 values, so mma.sync m16n8k16 bf16
// forms the same exact products as an fp32 product of them, and the 3xTF32
// split would multiply zeros (a bf16 value is a TF32 value: its small part is
// 0). What bounds it is the store: P is fp32, 4H (8H for the pair) floats per
// row-step against F bf16 of x, 16 times x's bytes; at 8 x 10 s (1.284 M
// row-steps, F = H = 128) 5.26 GB of P is 1.57 ms at 3.35 TB/s, while its
// 336 GFLOP take about 0.5 ms at mma.sync rates. So the design is built
// around the store (C staged in shared memory, written in whole rows by
// 16-byte streaming stores) and not around wgmma, whose higher rate would
// shorten the smaller term. Its accumulation chains the K / 16 mma of a tile
// (8 at K = 128) into one fp32 accumulator, which truncates each add: at K =
// 128 that stays within a few fp32 ulps of the sum, far inside the bf16
// streams' needs (the gates are rounded to bf16, or h is, or C itself), and
// chip_smoke.py phase 10 reports its error against float64 beside
// torch.matmul's fp32 one (PERF.md). The output type is a template
// parameter: fp32 C for P, bf16 C for the dense mode's outputs (half the
// bytes of the store that bounds it).
//
// The bf16 training pair (ops/bilstm2.py, ops/lstm.py: `_bilstm2_kernel`'s
// and `_lstm_kernel`'s bf16 `want_resid`, `_bilstm2_bwd_kernel` and
// `_lstm_bwd_kernel` in bf16) takes the same kernel for its input product
// and, with a bf16 C, for the backward's dx_d = dpre_d @ W_ih[d]^T, rounded
// once from the fp32 sum as the TPU kernel's .astype(dx_ref.dtype)
// (pallas_lstm.py:1302-1303). Its dW_ih = x^T dpre and dW_hh = h_prev^T dpre
// are reductions over every row-step (K up to 1.3 M at 8 x 10 s) into a
// small C ([F, 8H], [H, 4H]): the column-layout instantiation
// (products_gemm_bf16_col) reads x, h_prev and the bf16 dpre in place, A
// held [k][m] in shared memory and its fragments loaded by
// ldmatrix.trans, and cuts the k-range into fixed splits on blockIdx.z, each
// writing an fp32 partial that the wrapper sums in a fixed order (no float
// atomics: the splits' count and order come from the shapes alone, so a run
// repeats itself bit for bit). A split's k-range is long (about 20,000
// row-steps), so the truncating accumulation of a chain of mma would drift
// as it does for the 3xTF32 kernel: each 32-deep k-tile's two mma go into a
// fresh partial that is added to the sum in round-to-nearest. What bounds it
// is reading dpre (2.6 GB at 8 x 10 s, 0.8 ms at 3.35 TB/s).

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

// ---- bf16 operands: C = A @ B + bias, fp32 accumulation ----------------------
//
// The bf16 streams' input product (see the header): A is x, bf16 [M, K] in
// row layout, B is W_ih, bf16 [K, N]; or the dense mode's output product, A
// a direction's h (row pitch 2H), B its wo. OutT is C's type, fp32 or bf16
// (rounded once from the fp32 sum plus the bias). Block tiles of 128 x 128
// outputs, 256 threads in 8 warps of 32 x 64;
// a ring of kHStages 32-deep k-tiles of A ([m][k]) and B ([k][n]) filled by
// cp.async a few tiles ahead; per 16-deep k-step a warp loads its two A
// fragments by ldmatrix and its B fragments, two n-tiles at a time, by
// ldmatrix.trans, and issues 16 mma.sync m16n8k16, each chained into its
// accumulator. Then the tile goes through shared memory (the ring's space,
// reused): each warp stores its fragments plus the bias there, and whole
// rows of C leave, a warp's 32 lanes on one row: 16-byte stores of four fp32,
// or 8-byte stores of four bf16.
constexpr int kHBM = 128, kHBN = 128, kHBK = 32, kHStages = 3;
// [m][k] A tile: 80-byte rows put the 8 rows x 16 bytes of an ldmatrix phase
// on 32 banks; [k][n] B tile (and the column layout's [k][m] A tile):
// 272-byte rows, the same for ldmatrix.trans
constexpr int kHPitchA = kHBK + 8;
constexpr int kHPitchB = kHBN + 8;
static_assert(kHBM * kHPitchA >= kHBK * kHPitchB, "a [k][m] A tile fits an A slot");
// [m][n] fp32 C tile: a pitch of 8 mod 32 words puts a half-warp's float2
// fragment stores (4 rows x 4 lanes) on 32 banks
constexpr int kHPitchC = kHBN + 8;
constexpr int kHATile = kHBM * kHPitchA;  // bf16 elements
constexpr int kHBTile = kHBK * kHPitchB;
constexpr int kHRingBytes = kHStages * (kHATile + kHBTile) * 2;
constexpr int kHCBytes = kHBM * kHPitchC * 4;
constexpr int kHSmemBytes = kHRingBytes > kHCBytes ? kHRingBytes : kHCBytes;

template <typename OutT>
struct GemmBf16Args {
  // [M, K]: element (m, k) at a[m * lda + k] (row layout) or a[k * lda + m]
  // (column layout)
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;  // [K, N]: element (k, n) at b[k * ldb + n]
  const float* bias;       // [N] or null
  OutT* c;                 // split s's element (m, n) at c[s * split_stride + m * ldc + n]
  long long lda, ldb, ldc, split_stride;
  int M, N, K, kps;        // kps: k-range of one split (blockIdx.z), a multiple of kHBK
};

// four fp32 values of C's row as one streaming store: 16 bytes fp32, 8 bf16
__device__ __forceinline__ void store_c4(float* p, const float4& v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store_c4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), packed);
}

template <typename OutT, bool kACol>
__global__ void __launch_bounds__(256, 2) bf16_gemm_kernel(const GemmBf16Args<OutT> p) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // kHStages x kHATile
  __nv_bfloat16* Bs = As + kHStages * kHATile;                  // kHStages x kHBTile
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;  // the warp's 32 x 64 outputs
  const int lg = lane >> 2, lt = lane & 3;  // the fragments' group and thread-in-group
  const int m0 = blockIdx.y * kHBM, n0 = blockIdx.x * kHBN;
  const int kb = blockIdx.z * p.kps;        // this split's k-range [kb, ke)
  const int ke = min(p.K, kb + p.kps);
  const int ntiles = (ke - kb + kHBK - 1) / kHBK;

  // copy k-tile `it` into ring slot `slot` in 16-byte pieces (8 bf16 of k for
  // a row-layout A, of m for a column-layout A, of n for B); out-of-range
  // pieces are zero-filled
  auto load = [&](int it, int slot) {
    const int k0 = kb + it * kHBK;
    __nv_bfloat16* as = As + slot * kHATile;
    __nv_bfloat16* bs = Bs + slot * kHBTile;
    if constexpr (kACol) {
#pragma unroll
      for (int v = tid; v < kHBK * kHBM / 8; v += 256) {  // 32 k x 16 pieces of m
        const int k = v / (kHBM / 8), m = v % (kHBM / 8) * 8;
        const bool ok = k0 + k < ke && m0 + m < p.M;
        cp_async16(as + k * kHPitchB + m, ok ? p.a + (k0 + k) * p.lda + m0 + m : p.a,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int v = tid; v < kHBM * kHBK / 8; v += 256) {  // 128 m x 4 pieces of k
        const int m = v / (kHBK / 8), k = v % (kHBK / 8) * 8;
        const bool ok = m0 + m < p.M && k0 + k < ke;
        cp_async16(as + m * kHPitchA + k, ok ? p.a + (m0 + m) * p.lda + k0 + k : p.a,
                   ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int v = tid; v < kHBK * kHBN / 8; v += 256) {  // 32 k x 16 pieces of n
      const int k = v / (kHBN / 8), n = v % (kHBN / 8) * 8;
      const bool ok = k0 + k < ke && n0 + n < p.N;
      cp_async16(bs + k * kHPitchB + n, ok ? p.b + (k0 + k) * p.ldb + n0 + n : p.b, ok ? 16 : 0);
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
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();  // tile `it` landed; every thread is done with tile it - 1's slot
    if (it + kHStages - 1 < ntiles) load(it + kHStages - 1, (it + kHStages - 1) % kHStages);
    cp_async_commit();
    const __nv_bfloat16* as = As + (it % kHStages) * kHATile;
    const __nv_bfloat16* bs = Bs + (it % kHStages) * kHBTile;
    if constexpr (kACol) {
      // A fragments of both 16-deep k-steps of the tile from the [k][m] tile,
      // transposed on the way: lane L addresses k-row ks + (L & 7) + 8 (L >>
      // 4) at m wm + 16 mt + 8 ((L >> 3) & 1)
      uint32_t af[2][2][4];  // [k-step][m-tile]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4_trans_b16(af[h][mt], as + (16 * h + (lane & 7) + 8 * (lane >> 4)) *
                                                    kHPitchB + wm + 16 * mt +
                                                    8 * ((lane >> 3) & 1));
      // the tile's two k-steps chained into a fresh partial, added to the sum
      // in fp32 round-to-nearest (a split's k-range is long: see the header)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldmatrix_x4_trans_b16(bf[h], bs + (16 * h + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                                kHPitchB + wn + 16 * np + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float part[4];
            mma_bf16_first(part, af[0][mt], bf[0][2 * e], bf[0][2 * e + 1]);
            mma_bf16(part, af[1][mt], bf[1][2 * e], bf[1][2 * e + 1]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][2 * np + e][q] += part[q];
          }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kHBK; ks += 16) {
        // A fragments of the warp's two m-tiles: rows wm + 16 mt + (lane & 15),
        // k ks + 8 (lane >> 4)
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4_b16(af[mt],
                          as + (wm + 16 * mt + (lane & 15)) * kHPitchA + ks + 8 * (lane >> 4));
        // B fragments of n-tiles 2 np and 2 np + 1: k-rows ks + (lane & 7) + 8
        // ((lane >> 3) & 1), columns wn + 16 np + 8 (lane >> 4)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans_b16(bf, bs + (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * kHPitchB +
                                        wn + 16 * np + 8 * (lane >> 4));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the last commits were empty
  __syncthreads();     // every warp is done with the ring: it becomes the C tile

  // fragment (mt, nt) holds rows lg and lg + 8, columns 2 lt and 2 lt + 1
  float* cs = smem;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = wn + nt * 8 + 2 * lt;
    float2 bb = make_float2(0.f, 0.f);
    if (p.bias != nullptr && n0 + n < p.N) bb = *reinterpret_cast<const float2*>(p.bias + n0 + n);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (wm + 16 * mt + lg + 8 * h) * kHPitchC + n) =
            make_float2(acc[mt][nt][2 * h] + bb.x, acc[mt][nt][2 * h + 1] + bb.y);
  }
  __syncthreads();
  OutT* c = p.c + blockIdx.z * p.split_stride;
  const int n = n0 + 4 * lane;  // a warp's 32 lanes write one row's 128 columns
  for (int r = warp; r < kHBM && m0 + r < p.M; r += 8)
    if (n < p.N)  // N is a multiple of 8: all four columns are in range
      store_c4(c + (m0 + r) * p.ldc + n,
               *reinterpret_cast<const float4*>(cs + r * kHPitchC + 4 * lane));
}

template <typename OutT, bool kACol>
int launch_gemm_bf16(const GemmBf16Args<OutT>& p, int splits, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(bf16_gemm_kernel<OutT, kACol>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kHSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.N + kHBN - 1) / kHBN, (p.M + kHBM - 1) / kHBM, splits);
  bf16_gemm_kernel<OutT, kACol><<<grid, 256, kHSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
GemmBf16Args<OutT> bf16_args(const void* a, long long lda, const void* b, long long ldb, int K,
                             const void* bias, void* c, long long ldc, int M, int N) {
  GemmBf16Args<OutT> p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.bias = static_cast<const float*>(bias);
  p.c = static_cast<OutT*>(c);
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.split_stride = 0;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kps = K;
  return p;
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

// C = A @ B + bias on bf16 operands with fp32 accumulation (see
// bf16_gemm_kernel): a [M, K] bf16 (row lda), b [K, N] bf16 (row ldb), bias
// [N] fp32 or null, c (row ldc) fp32, or with c_bf16 bf16 rounded once from
// the fp32 sum. K, N, lda and ldb multiples of 8, ldc of 4; every pointer
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
int products_gemm_bf16(const void* a, long long lda, const void* b, long long ldb, int K,
                       const void* bias, void* c, long long ldc, int M, int N, int c_bf16,
                       void* stream) {
  if (K % 8 || N % 8 || lda % 8 || ldb % 8 || ldc % 4 || M < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c_bf16 ? launch_gemm_bf16<__nv_bfloat16, false>(
                      bf16_args<__nv_bfloat16>(a, lda, b, ldb, K, bias, c, ldc, M, N), 1, s)
                : launch_gemm_bf16<float, false>(
                      bf16_args<float>(a, lda, b, ldb, K, bias, c, ldc, M, N), 1, s);
}

// C = A @ B on bf16 operands with A in column layout: a is [K, M] (row lda),
// so C[m][n] = sum over k of a[k][m] b[k][n], the reduction over all
// row-steps of the bf16 backward's dW_ih = x^T dpre and dW_hh = h_prev^T dpre;
// b [K, N] bf16 (row ldb). The k-range is cut into splits of kps (a multiple
// of 32) and split s writes its fp32 partial [M][N] to c + s * split_stride
// (row pitch N), which the caller sums in a fixed order: no atomics. M, N,
// lda and ldb multiples of 8; every pointer 16-byte aligned. Returns a
// cudaError_t code (0 = launched).
int products_gemm_bf16_col(const void* a, long long lda, const void* b, long long ldb, int K,
                           void* c, long long split_stride, int M, int N, int splits, int kps,
                           void* stream) {
  if (M % 8 || N % 8 || lda % 8 || ldb % 8 || kps % kHBK || kps <= 0 || splits < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmBf16Args<float> p = bf16_args<float>(a, lda, b, ldb, K, nullptr, c, N, M, N);
  p.split_stride = split_stride;
  p.kps = kps;
  return launch_gemm_bf16<float, true>(p, splits, static_cast<cudaStream_t>(stream));
}

const char* products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
