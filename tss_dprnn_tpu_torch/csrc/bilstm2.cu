// Fused bidirectional LSTM scan for Hopper (sm_90a) with the SplitDense
// product fused in: the dense mode.
//
// Replaces the TPU kernel `_bilstm2_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:698)
// in its dense mode (`bilstm2_dense_forward` :969, fp32 and bf16 streams; the
// opt-in `TSS_FUSED_DENSE=1`). Its unmasked and masked serving modes are the
// input product of csrc/products.cu and the serving scan of
// csrc/bilstm2_serve.cu, its residual mode the training forward of
// csrc/bilstm2_resid.cu. Per step and direction d:
//   g = x_t @ W_ih[d] + h @ W_hh[d] + b[d]      (fp32 accumulator)
//   i, f, o = sigmoid(g_i, g_f, g_o); gg = tanh(g_g)   (torch gate order i, f, g, o)
//   c = f * c + i * gg                          (fp32)
//   h = round_to_stream_type(o * tanh(c))       (fed back rounded)
//   y_d = round_to_stream_type(h @ wo[d])       (fp32 accumulator)
// Direction 0 scans t = 0..T-1, direction 1 scans t = T-1..0; both write y_d
// [R, T, Fo] at forward time t, and h never reaches memory. wo [2, H, Fo] is
// fp32 holding stream-type values, Fo <= H; its k-rows stream through the
// same chunk buffers as W: H / 16 more chunks per step, 2 H Fo more FLOP per
// row-step and direction (12.5 % at F = H = Fo = 128).
//
// What bounds it: the arithmetic. At F = H = 128 a row-step costs
// 2 * (F + H) * 4H = 262,144 FLOP per direction against 2 * (F + H) bytes of
// fresh input and output, so the kernel sits far above the card's
// memory-bandwidth line; the time loop is sequential, so all parallelism comes
// from rows and directions.
//
// Design (the first, simple one; the serving and training scans were
// redesigned as cluster scans, this opt-in mode was not): one block per
// (direction, tile of 32 rows), looping over T. The tile's h lives in shared
// memory, its c in registers; x_t is copied into shared memory with cp.async.
// Each thread owns 4 rows x 4 hidden units and all four gates of each, so the
// cell update needs no exchange between threads. W = [W_ih; W_hh] (fp32,
// (F + H) x 4H, 512 KB at the flagship width) does not fit in a block's shared
// memory: it streams from L2 every step in chunks of 16 k-rows (the first F /
// 16 from W_ih, the rest from W_hh), double-buffered with cp.async so the next
// chunk's copy overlaps this chunk's FMAs. Every weight a block reads is
// reused across its 32 rows.
// Stream types: float and bf16 (x and outputs); the weights arrive as fp32
// holding values already rounded to the stream type, so products are exact and
// only the accumulation order differs from the TPU kernel.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kRows = 32;      // rows per block
constexpr int kKChunk = 16;    // k-rows of W per shared-memory chunk
constexpr int kMaxThreads = 256;

// Grid (ceil(R / 32), 2): blockIdx.y is the direction. Threads: 2H (8 row
// groups x H/4 unit groups). x [R, T, F] and the outputs y_d [R, T, Fo] are
// contiguous.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
bilstm2_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
               const float* __restrict__ w_hh, const float* __restrict__ b,
               T* __restrict__ out0, T* __restrict__ out1, const float* __restrict__ wo, int R,
               int Tn, int F, int H, int Fo) {
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
  T* out = d == 0 ? out0 : out1;

  float c[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[r][j] = 0.f;
  for (int i = tid; i < kRows * hp; i += nthreads) hs[i] = 0.f;
  if (Tn == 0) return;

  const int vec_per_row = F * static_cast<int>(sizeof(T)) / 16;
  auto load_x = [&](int t) {
    for (int v = tid; v < kRows * vec_per_row; v += nthreads) {
      const int r = v / vec_per_row;
      const int e = (v - r * vec_per_row) * (16 / static_cast<int>(sizeof(T)));
      const int gr = row0 + r;
      const T* src = gr < R ? x + static_cast<long long>(gr) * (Tn * F) + t * F + e : x;
      cp_async16(xs + r * xp + e, src, gr < R ? 16 : 0);
    }
  };
  const int chunk_vecs = kKChunk * G / 4;
  // the chunk's source is worked out from the kernel's parameters at each
  // copy: two hoisted direction pointers cost registers the loop needs
  auto load_w = [&](int chunk, int buf) {
    const int k = chunk * kKChunk;
    const float* src = k < F ? w_ih + (d * F + k) * G : w_hh + (d * H + k - F) * G;
    float* dst = ws + buf * kKChunk * G;
    for (int v = tid; v < chunk_vecs; v += nthreads) cp_async16(dst + 4 * v, src + 4 * v, 16);
  };
  // chunk j of wo[d], kKChunk k-rows of Fo, into the same buffers
  const int n_wo = H / kKChunk;
  auto load_wo = [&](int j, int buf) {
    const float* src = wo + (d * H + j * kKChunk) * Fo;
    float* dst = ws + buf * kKChunk * G;
    for (int v = tid; v < kKChunk * Fo / 4; v += nthreads) cp_async16(dst + 4 * v, src + 4 * v, 16);
  };

  const int n_chunks = K / kKChunk;
  int q = 0;  // chunks issued so far; chunk q % n_chunks sits in buffer q % 2
  load_w(0, 0);
  load_x(d == 0 ? 0 : Tn - 1);
  cp_async_commit();

  for (int s = 0; s < Tn; ++s) {
    const int t = d == 0 ? s : Tn - 1 - s;
    float acc[4][4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 bv = *reinterpret_cast<const float4*>(bd + g * H + u4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[g][r][0] = bv.x;
        acc[g][r][1] = bv.y;
        acc[g][r][2] = bv.z;
        acc[g][r][3] = bv.w;
      }
    }
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++q) {
      cp_async_wait_all();
      __syncthreads();  // chunk q (and x_t) landed; buffer (q + 1) % 2 is free
      if (chunk + 1 < n_chunks)  // after the last W chunk comes wo's first
        load_w(chunk + 1, (q + 1) & 1);
      else
        load_wo(0, (q + 1) & 1);
      cp_async_commit();
      const float* wc = ws + (q & 1) * kKChunk * G;
      const int k0 = chunk * kKChunk;
      if (k0 < F)
        mac_chunk<kKChunk>(acc, xs + rg * xp + k0, xp, wc, G, H, u4);
      else
        mac_chunk<kKChunk>(acc, hs + rg * hp + (k0 - F), hp, wc, G, H, u4);
    }
    __syncthreads();  // every thread is done reading x_t and h
    if (s + 1 < Tn) {
      load_x(d == 0 ? t + 1 : t - 1);
      cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rg + 8 * r;
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
    }
    // y_t = h_t @ wo[d]: this thread's 4 rows x output columns u4..u4+3
    float y[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[r][j] = 0.f;
    for (int jc = 0; jc < n_wo; ++jc, ++q) {
      cp_async_wait_all();
      __syncthreads();  // wo chunk q landed; every row's h_t is in hs
      if (jc + 1 < n_wo)
        load_wo(jc + 1, (q + 1) & 1);
      else
        load_w(0, (q + 1) & 1);  // the next step's first chunk
      cp_async_commit();
      const float* wc = ws + (q & 1) * kKChunk * G;
      if (u4 < Fo) {
#pragma unroll
        for (int kk = 0; kk < kKChunk; ++kk) {
          const float4 w = ld4(wc + kk * Fo + u4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = hs[(rg + 8 * r) * hp + jc * kKChunk + kk];
            y[r][0] = fmaf(a, w.x, y[r][0]);
            y[r][1] = fmaf(a, w.y, y[r][1]);
            y[r][2] = fmaf(a, w.z, y[r][2]);
            y[r][3] = fmaf(a, w.w, y[r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + rg + 8 * r;
      if (gr < R && u4 < Fo)
        store4(out + static_cast<long long>(gr) * (Tn * Fo) + t * Fo + u4, y[r]);
    }
  }
  cp_async_wait_all();  // the last step prefetched a chunk nobody reads
}

template <typename T>
int launch(const void* x, const void* w_ih, const void* w_hh, const void* b, const void* wo,
           void* y0, void* y1, int R, int Tn, int F, int H, int Fo, cudaStream_t stream) {
  const size_t smem = kRows * (F + 16 / sizeof(T)) * sizeof(T) + kRows * (H + 4) * sizeof(float) +
                      2 * kKChunk * 4 * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bilstm2_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kRows - 1) / kRows, 2);
  bilstm2_kernel<T><<<grid, 2 * H, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
      static_cast<const float*>(b), static_cast<T*>(y0), static_cast<T*>(y1),
      static_cast<const float*>(wo), R, Tn, F, H, Fo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 streams. x: [R, T, F] and y0, y1:
// [R, T, Fo], contiguous in the stream type, y_d = h_d @ wo[d]. w_ih:
// [2, F, 4H], w_hh: [2, H, 4H], b: [2, 4H], wo: [2, H, Fo], fp32 (holding
// stream-type values); Fo a multiple of 4 and at most H. Every pointer
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
int bilstm2_dense_forward(int dtype, const void* x, const void* w_ih, const void* w_hh,
                          const void* b, const void* wo, void* y0, void* y1, int R, int Tn,
                          int F, int H, int Fo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Fo % 4 || Fo > H || Fo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w_ih, w_hh, b, wo, y0, y1, R, Tn, F, H, Fo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_ih, w_hh, b, wo, y0, y1, R, Tn, F, H, Fo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* bilstm2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
