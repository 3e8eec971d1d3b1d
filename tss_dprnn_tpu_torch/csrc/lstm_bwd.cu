// Backward of the stacked-direction LSTM scan for Hopper (sm_90a), fp32: the
// sequential part.
//
// Replaces the TPU kernel `_lstm_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:498, launched by lstm_backward :632). Given,
// per direction d, x[d] [R, T, F], the residual streams of the forward
// (h_prev, c_prev, tanh(c), each [R, T, H]) and the output cotangent g[d]
// [R, T, H], the backward computes dx[d], dW_ih[d], dW_hh[d] and db[d]:
//   gates = x_t @ W_ih[d] + h_prev @ W_hh[d] + b[d]; i, f, o = sigmoid, g = tanh
//   dh = g_t + dh_carry;  dc = dc_carry + dh * o * (1 - tc^2)
//   dpre = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tc*o(1-o)]
//   dh_carry = dpre @ W_hh[d]^T;  dc_carry = dc * f
//   dx[d] = dpre @ W_ih[d]^T; dW_ih[d] = sum x^T dpre;
//   dW_hh[d] = sum h_prev^T dpre; db[d] = sum dpre
// Every direction runs t = T-1..0 (the forward never reverses), and dx stays
// per direction: each has its own input.
//
// What bounds it: the arithmetic, 3 * 2 (F + H) 4H FLOP per row-step and
// direction. Only the dh/dc recurrence is sequential, and one direction's dW
// (512 KB fp32) does not fit on chip, so the work is split in three: the
// tiled product kernel of csrc/products.cu recomputes the gates of every
// row-step into a [D, R, T, 4H] buffer, the scan kernel here turns them into
// dpre in place, and the product kernel again gives dx and the fixed partials
// of dW, its column-sum kernel those of db (tss_dprnn_tpu_torch/ops/lstm.py
// launches them in that order).
// No float atomics anywhere: a run repeats itself bit for bit on one card.
//
// The scan kernel: one block per (direction, tile of 16 rows) looping over T
// with dh and dc in registers; its only product, dpre @ W_hh^T, streams W_hh^T
// (256 KB at H = 128) from L2 in double-buffered chunks. The tile is 16 rows
// for the forward's reason (csrc/lstm.cu): with one direction and the
// inter-chunk shapes' rows, 32-row tiles leave most SMs without a block.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kNR = 2;          // rows per thread
constexpr int kRows = 8 * kNR;  // rows per block
constexpr int kWChunk = 32;     // k-rows of W_hh^T per shared-memory chunk

// Grid (ceil(R / 16), D): blockIdx.y is the direction. Threads: 2H (8 row
// groups x H/4 unit groups); each thread owns rows rg + 8r (r < kNR) and hidden
// units u4..u4+3 with all four gates of each, as in the forward kernel.
// gd: [D, R, T, 4H], gate pre-activations in, dpre out. cp, tc, g:
// [D, R, T, H]. wt: [D, 4H, H] = W_hh[d]^T.
__global__ void __launch_bounds__(256, 2)
scan_kernel(float* __restrict__ gd, const float* __restrict__ cp, const float* __restrict__ tc,
            const float* __restrict__ g, const float* __restrict__ wt, int R, int Tn, int H) {
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
  // row-step (gr, t) of direction d
  const long long drow0 = static_cast<long long>(d) * R;
  auto step_at = [&](int gr, int t) { return (drow0 + gr) * Tn + t; };

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

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float dh[kNR][4], dc[kNR][4];
#pragma unroll
  for (int r = 0; r < kNR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dh[r][j] = dc[r][j] = 0.f;

  for (int t = Tn - 1; t >= 0; --t) {
    __syncthreads();  // every thread is done with the last step's dpre tile
#pragma unroll
    for (int r = 0; r < kNR; ++r) {
      const int row = rg + 8 * r;
      const int gr = row0 + row;
      float4 gi = zero4, gf = zero4, gg = zero4, go = zero4, cpv = zero4, tcv = zero4, gv = zero4;
      float* gp = nullptr;
      if (gr < R) {  // rows past R carry zeros and store nothing
        const long long at = step_at(gr, t);
        gp = gd + at * G + u4;
        gi = ld4(gp);
        gf = ld4(gp + H);
        gg = ld4(gp + 2 * H);
        go = ld4(gp + 3 * H);
        cpv = ld4(cp + at * H + u4);
        tcv = ld4(tc + at * H + u4);
        gv = ld4(g + at * H + u4);
      }
      float pi[4], pf[4], pg[4], po[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ig = sigmoid_f(comp(gi, j));
        const float fg = sigmoid_f(comp(gf, j));
        const float ggv = tanhf(comp(gg, j));
        const float og = sigmoid_f(comp(go, j));
        const float tcj = comp(tcv, j);
        const float dhv = comp(gv, j) + dh[r][j];
        const float dcv = dc[r][j] + dhv * (og * (1.0f - tcj * tcj));
        pi[j] = dcv * (ggv * ig * (1.0f - ig));
        pf[j] = dcv * (comp(cpv, j) * fg * (1.0f - fg));
        pg[j] = dcv * (ig * (1.0f - ggv * ggv));
        po[j] = dhv * (tcj * og * (1.0f - og));
        dc[r][j] = dcv * fg;
      }
      float* dp = dps + row * dpp + u4;
      store4(dp, pi);
      store4(dp + H, pf);
      store4(dp + 2 * H, pg);
      store4(dp + 3 * H, po);
      if (gp != nullptr) {
        store4(gp, pi);
        store4(gp + H, pf);
        store4(gp + 2 * H, pg);
        store4(gp + 3 * H, po);
      }
    }

    // dh_carry = dpre @ W_hh^T over the tile, W_hh^T streamed in chunks
    float acc[kNR][4];
#pragma unroll
    for (int r = 0; r < kNR; ++r)
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
        float4 a[kNR];
#pragma unroll
        for (int r = 0; r < kNR; ++r) a[r] = ld4(dps + (rg + 8 * r) * dpp + k0 + kk);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float4 w = ld4(wc + (kk + qq) * H + u4);
#pragma unroll
          for (int r = 0; r < kNR; ++r) {
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
    for (int r = 0; r < kNR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[r][j] = acc[r][j];
  }
  cp_async_wait_all();  // the last step prefetched a chunk nobody reads
}

}  // namespace

extern "C" {

// The reverse scan: gd [D, R, T, 4H] holds the gate pre-activations and gets
// dpre in place. cp, tc, g: [D, R, T, H]; wt: [D, 4H, H]. All fp32,
// contiguous, 16-byte aligned; H a multiple of 16, <= 128. Returns a
// cudaError_t code (0 = launched).
int lstm_bwd_scan(void* gd, const void* cp, const void* tc, const void* g, const void* wt, int D,
                  int R, int Tn, int H, void* stream) {
  const size_t smem = (kRows * (4 * H + 4) + 2 * kWChunk * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kRows - 1) / kRows, D);
  scan_kernel<<<grid, 2 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(gd), static_cast<const float*>(cp), static_cast<const float*>(tc),
      static_cast<const float*>(g), static_cast<const float*>(wt), R, Tn, H);
  return static_cast<int>(cudaGetLastError());
}

const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
