// LSTM scan over D stacked directions, one input each, for Hopper (sm_90a):
// the cell-state training forward.
//
// Replaces the TPU kernel `_lstm_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:57,
// launched by _pallas_core :231) in its `want_cs` mode (fp32 and bf16
// streams). Its h-only and `want_resid` modes, which BSS serving and training
// run, and its `reverse_dir1` mode (`bilstm_pallas_fused` :171) are the input
// product of csrc/products.cu followed by the cluster scans of
// csrc/bilstm2_serve.cu and csrc/bilstm2_resid.cu. Per step and direction d,
// on that direction's own input x[d]:
//   g = x_t @ W_ih[d] + h @ W_hh[d] + b[d]      (fp32 accumulator)
//   i, f, o = sigmoid(g_i, g_f, g_o); gg = tanh(g_g)   (torch gate order i, f, g, o)
//   c = f * c + i * gg                          (fp32)
//   h = round_to_stream_type(o * tanh(c))       (fed back rounded)
// and writes h and the fp32 cell state after every step (pallas_lstm.py:114
// writes cs in fp32 whatever the stream type): the forward of
// `lstm_save_every`'s segment-checkpointed recurrence. Every direction scans
// t = 0..T-1: a caller that wants a reversed direction flips its input
// beforehand, as the TPU kernel's callers do. With D = 1 it is the
// unidirectional inter-chunk scan of a causal DPRNN. There is no masked mode:
// steps past a row's length compute on whatever the input holds there, and
// the consumer masks them.
//
// What bounds it: the arithmetic, 2 * (F + H) * 4H = 262,144 FLOP per row-step
// and direction at F = H = 128 against 2 * (F + H) bytes of fresh input and
// output and 4H bytes of c. The time loop is sequential, so all parallelism
// comes from rows and directions, and with D = 1 there are half as many
// blocks as a bidirectional scan has at the same rows.
//
// Design (the first, simple one; the serving and training scans were
// redesigned as cluster scans, this one was not): one block per (direction,
// tile of rows) looping over T, the tile's h in shared memory, its c in
// registers, x_t copied in with cp.async, and W = [W_ih; W_hh] (512 KB fp32 at
// F = H = 128, over a block's shared memory) streamed from L2 every step in
// double-buffered chunks of 16 k-rows. Each thread owns 2 rows x 4 hidden
// units with all four gates, so a tile is 16 rows: with one direction the
// rows are the only source of blocks, and at the inter-chunk shapes
// (1,250-2,000 rows) 32-row tiles leave most of the card's 132 SMs without a
// block. On an H100 the 16-row tile was 1.6x faster there and no slower at
// 10,000 rows (PERF.md). bf16 streams: x and h in bf16, the weights fp32
// holding bf16 values (the wrapper rounds them), so every product is exact.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kNR = 2;         // rows per thread
constexpr int kRows = 8 * kNR;  // rows per block
constexpr int kKChunk = 16;    // k-rows of W per shared-memory chunk
constexpr int kMaxThreads = 256;

constexpr int kModeCs = 1;  // the C interface's mode number (ops/lstm.py _MODE_CS)

// Grid (ceil(R / 16), D): blockIdx.y is the direction. Threads: 2H (8 row
// groups x H/4 unit groups). x [D, R, T, F] and out [D, R, T, H] are
// contiguous in the stream type; the cell state after every step goes to cs
// [D, R, T, H] (fp32).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
lstm_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
            const float* __restrict__ w_hh, const float* __restrict__ b, T* __restrict__ out,
            float* __restrict__ cs, int R, int Tn, int F, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * H;
  const int K = F + H;
  const int xp = F + 16 / static_cast<int>(sizeof(T));  // padded row pitch of x tile
  const int hp = H + 4;                                  // padded row pitch of h tile
  T* xs = reinterpret_cast<T*>(smem);
  float* hs = reinterpret_cast<float*>(smem + kRows * xp * sizeof(T));
  float* ws = hs + kRows * hp;  // two chunks of [kKChunk][G]

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int rg = lane & 7;                                  // rows rg + 8r
  const int u4 = ((tid >> 5) * 4 + (lane >> 3)) * 4;        // first hidden unit
  const float* bd = b + d * G;
  // row gr of direction d: a 64-bit row offset, a 32-bit offset within the row
  const long long drow0 = static_cast<long long>(d) * R;
  auto at = [&](auto* p, int gr, int t) { return p + (drow0 + gr) * (Tn * H) + t * H; };

  float c[kNR][4];
#pragma unroll
  for (int r = 0; r < kNR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[r][j] = 0.f;
  for (int i = tid; i < kRows * hp; i += nthreads) hs[i] = 0.f;

  const int vec_per_row = F * static_cast<int>(sizeof(T)) / 16;
  auto load_x = [&](int t) {
    for (int v = tid; v < kRows * vec_per_row; v += nthreads) {
      const int r = v / vec_per_row;
      const int e = (v - r * vec_per_row) * (16 / static_cast<int>(sizeof(T)));
      const int gr = row0 + r;
      const T* src = gr < R ? x + (drow0 + gr) * (Tn * F) + t * F + e : x;
      cp_async16(xs + r * xp + e, src, gr < R ? 16 : 0);
    }
  };
  const int chunk_vecs = kKChunk * G / 4;
  auto load_w = [&](int chunk, int buf) {
    const int k = chunk * kKChunk;
    const float* src = k < F ? w_ih + (d * F + k) * G : w_hh + (d * H + k - F) * G;
    float* dst = ws + buf * kKChunk * G;
    for (int v = tid; v < chunk_vecs; v += nthreads) cp_async16(dst + 4 * v, src + 4 * v);
  };

  const int n_chunks = K / kKChunk;
  int q = 0;  // chunks issued so far; chunk q % n_chunks sits in buffer q % 2
  load_w(0, 0);
  load_x(0);
  cp_async_commit();

  for (int t = 0; t < Tn; ++t) {
    float acc[4][kNR][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 bv = ld4(bd + g * H + u4);
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        acc[g][r][0] = bv.x;
        acc[g][r][1] = bv.y;
        acc[g][r][2] = bv.z;
        acc[g][r][3] = bv.w;
      }
    }
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++q) {
      cp_async_wait_all();
      __syncthreads();  // chunk q (and x_t) landed; buffer (q + 1) % 2 is free
      load_w((chunk + 1) % n_chunks, (q + 1) & 1);
      cp_async_commit();
      const float* wc = ws + (q & 1) * kKChunk * G;
      const int k0 = chunk * kKChunk;
      if (k0 < F)
        mac_chunk<kKChunk>(acc, xs + rg * xp + k0, xp, wc, G, H, u4);
      else
        mac_chunk<kKChunk>(acc, hs + rg * hp + (k0 - F), hp, wc, G, H, u4);
    }
    __syncthreads();  // every thread is done reading x_t and h
    if (t + 1 < Tn) {
      load_x(t + 1);
      cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < kNR; ++r) {
      const int row = rg + 8 * r;
      const int gr = row0 + row;
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ig = sigmoid_f(acc[0][r][j]);
        const float fg = sigmoid_f(acc[1][r][j]);
        const float gg = tanhf(acc[2][r][j]);
        const float og = sigmoid_f(acc[3][r][j]);
        c[r][j] = fg * c[r][j] + ig * gg;
        hv[j] = to_f(from_f<T>(og * tanhf(c[r][j])));
      }
      store4(hs + row * hp + u4, hv);
      if (gr < R) {
        store4(at(out, gr, t) + u4, hv);
        store4(at(cs, gr, t) + u4, c[r]);
      }
    }
  }
  cp_async_wait_all();  // the last step prefetched a chunk nobody reads
}

template <typename T>
int launch(const void* x, const void* w_ih, const void* w_hh, const void* b, void* out,
           float* cs, int D, int R, int Tn, int F, int H, cudaStream_t stream) {
  const size_t smem = kRows * (F + 16 / sizeof(T)) * sizeof(T) + kRows * (H + 4) * sizeof(float) +
                      2 * kKChunk * 4 * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kRows - 1) / kRows, D);
  lstm_kernel<T><<<grid, 2 * H, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
      static_cast<const float*>(b), static_cast<T*>(out), cs, R, Tn, F, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 1: h and the cell state after every step, cs [D, R, T, H] fp32;
// dtype 0 = float32 streams, 1 = bfloat16 streams (x and h). The other modes
// run the cluster scans (see the header) and are refused here. x: [D, R, T,
// F] and out: [D, R, T, H], contiguous in the stream type; w_ih: [D, F, 4H],
// w_hh: [D, H, 4H], b: [D, 4H], fp32 (holding stream-type values). Every
// pointer 16-byte aligned; F and H multiples of 16, H <= 128. Returns a
// cudaError_t code (0 = launched).
int lstm_forward(int dtype, int mode, const void* x, const void* w_ih, const void* w_hh,
                 const void* b, void* out, void* cs, int D, int R, int Tn, int F, int H,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kModeCs) return static_cast<int>(cudaErrorInvalidValue);
  float* c = static_cast<float*>(cs);
  if (dtype == 0) return launch<float>(x, w_ih, w_hh, b, out, c, D, R, Tn, F, H, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w_ih, w_hh, b, out, c, D, R, Tn, F, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
