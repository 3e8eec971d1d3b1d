// Time-blocked LSTM scan for Hopper (sm_90a), the kernel of bilstm2_bm.cu and
// lstm_v2.cu (their headers say which TPU kernel each replaces and why its
// sizes are what they are).
//
// One block owns (direction, tile of 16 rows) and loops over all of T in
// slabs of kSlab = 4 consecutive steps. x is batch-major ([R, T, F] per
// direction), so a row's slab is one contiguous span of kSlab * F elements:
// thread 0 brings the next slab's rows into shared memory with bulk copies
// (the TMA engine, one copy per row, completion counted on an mbarrier)
// while the block computes the current slab from the other buffer. The W
// stream is the other kernels' (csrc/bilstm2.cu): W = [W_ih; W_hh] in fp32
// does not fit in shared memory beside the slabs, so it comes from L2 every
// step in double-buffered cp.async chunks of kKChunk k-rows, reused across the
// tile's rows. The tile's h lives in shared memory, its c in registers; each
// thread owns 2 rows x 4 hidden units with all four gates. A reversed
// direction walks the slabs backwards and the steps inside each slab in
// descending order; the last slab may be short (T need not be a multiple of
// kSlab), and its copies are just shorter. With kStageH the slab's h goes to
// a double-buffered shared slab and leaves by bulk copies (one per row, a
// contiguous kSlab * H span) while the next slab computes; otherwise every
// step stores its h directly. kRoundV2 rounds wherever the source of the
// TPU's manual-DMA kernel computes in a 16-bit stream type
// (pallas_lstm.py:334-340): the gates after the bias, each operation of the
// activations (the sigmoid's exp, 1 + and 1 /, and tanh), i * g, tanh(c) and
// h; otherwise only h is rounded, as in every other scan kernel of the port.
// fp32 streams round nowhere, so the two agree there.

#pragma once

#include "scan_common.cuh"

namespace slab_scan {

using namespace scan_common;

constexpr int kNR = 2;          // rows per thread
constexpr int kRows = 8 * kNR;  // rows per block
constexpr int kSlab = 4;        // steps per slab
constexpr int kMaxThreads = 256;

struct Args {
  const void* x;      // direction d, row r, step t at x + d * x_dir + (r * T + t) * F
  long long x_dir;    // elements between two directions' inputs; 0: one shared input
  const float* w_ih;  // [D, F, 4H], fp32 holding stream-type values
  const float* w_hh;  // [D, H, 4H]
  const float* b;     // [D, 4H]
  void* out;          // [D, R, T, H], stream type
  int reverse1;       // direction 1 scans t = T-1 .. 0
  int R, Tn, F, H;
};

// dynamic shared memory: two mbarriers, two x slabs, the h tile, two W chunks
// and, with kStageH, two h slabs; every part a multiple of 16 bytes
template <typename T, int kKChunk, bool kStageH>
inline size_t smem_bytes(int F, int H) {
  const size_t pad = 16 / sizeof(T);  // row pitch padding: rows land on distinct banks
  size_t n = 16;
  n += 2 * kRows * (kSlab * F + pad) * sizeof(T);
  n += kRows * (H + 4) * sizeof(float);
  n += 2 * kKChunk * 4 * H * sizeof(float);
  if (kStageH) n += 2 * kRows * (kSlab * H + pad) * sizeof(T);
  return n;
}

// Grid (ceil(R / 16), D): blockIdx.y is the direction. Threads: 2H (8 row
// groups x H/4 unit groups).
template <typename T, int kKChunk, bool kStageH, bool kRoundV2, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) slab_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, Tn = a.Tn, F = a.F, H = a.H;
  const int G = 4 * H;
  const int K = F + H;
  const int pad = 16 / static_cast<int>(sizeof(T));
  const int xpitch = kSlab * F + pad;  // x slab row pitch
  const int opitch = kSlab * H + pad;  // h slab row pitch
  const int hp = H + 4;                // h tile row pitch
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* xs = reinterpret_cast<T*>(smem + 16);
  float* hs = reinterpret_cast<float*>(xs + 2 * kRows * xpitch);
  float* ws = hs + kRows * hp;
  T* os = reinterpret_cast<T*>(ws + 2 * kKChunk * G);

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nvalid = min(kRows, R - row0);
  const bool rev = a.reverse1 && d == 1;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int rg = lane & 7;                            // rows rg + 8r
  const int u4 = ((tid >> 5) * 4 + (lane >> 3)) * 4;  // first hidden unit
  const float* bd = a.b + d * G;
  const T* xd = static_cast<const T*>(a.x) + d * a.x_dir;
  T* outd = static_cast<T*>(a.out) + static_cast<long long>(d) * R * Tn * H;
  const int n_slabs = (Tn + kSlab - 1) / kSlab;

  float c[kNR][4];
#pragma unroll
  for (int r = 0; r < kNR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[r][j] = 0.f;
  for (int i = tid; i < kRows * hp; i += nthreads) hs[i] = 0.f;
  if (nvalid < kRows) {  // rows past R: zeros in both x slabs, never copied over
    for (int i = tid; i < 2 * kRows * xpitch; i += nthreads)
      if ((i / xpitch) % kRows >= nvalid) xs[i] = from_f<T>(0.f);
  }
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto slab_t0 = [&](int n) { return (rev ? n_slabs - 1 - n : n) * kSlab; };
  // thread 0: slab n's rows into x buffer buf, counted on bar[buf]
  auto issue_x = [&](int n, int buf) {
    const int t0 = slab_t0(n);
    const unsigned bytes = min(kSlab, Tn - t0) * F * sizeof(T);
    mbar_arrive_expect_tx(&bar[buf], bytes * nvalid);
    for (int r = 0; r < nvalid; ++r)
      bulk_g2s(xs + (buf * kRows + r) * xpitch,
               xd + (static_cast<long long>(row0 + r) * Tn + t0) * F, bytes, &bar[buf]);
  };
  const int chunk_vecs = kKChunk * G / 4;
  auto load_w = [&](int chunk, int buf) {
    const int k = chunk * kKChunk;
    const float* src = k < F ? a.w_ih + (d * F + k) * G : a.w_hh + (d * H + k - F) * G;
    float* dst = ws + buf * kKChunk * G;
    for (int v = tid; v < chunk_vecs; v += nthreads) cp_async16(dst + 4 * v, src + 4 * v);
  };
  auto rnd = [](float v) { return to_f(from_f<T>(v)); };
  // 1 / (1 + exp(-v)) with every operation rounded to the stream type
  auto sigmoid_v2 = [&](float v) { return rnd(1.0f / rnd(1.0f + rnd(expf(-v)))); };

  const int n_chunks = K / kKChunk;
  int q = 0;  // W chunks issued so far; chunk q % n_chunks sits in buffer q % 2
  if (tid == 0) issue_x(0, 0);
  load_w(0, 0);
  cp_async_commit();

  for (int n = 0; n < n_slabs; ++n) {
    const int buf = n & 1;
    const int t0 = slab_t0(n);
    const int len = min(kSlab, Tn - t0);
    if (tid == 0) {
      // every thread finished reading buffer buf ^ 1 (slab n - 1) before the
      // last __syncthreads of that slab
      if (n + 1 < n_slabs) issue_x(n + 1, buf ^ 1);
      if constexpr (kStageH) bulk_wait_read<1>();  // slab n - 2's h has left os[buf]
    }
    mbar_wait(&bar[buf], (n >> 1) & 1);  // buffer buf's (n / 2)-th fill
    const T* xb = xs + buf * kRows * xpitch;
    T* ob = os + buf * kRows * opitch;

    for (int i = 0; i < len; ++i) {
      const int ui = rev ? len - 1 - i : i;
      const int t = t0 + ui;
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
        __syncthreads();  // chunk q landed; buffer (q + 1) % 2 is free
        load_w((chunk + 1) % n_chunks, (q + 1) & 1);
        cp_async_commit();
        const float* wc = ws + (q & 1) * kKChunk * G;
        const int k0 = chunk * kKChunk;
        if (k0 < F)
          mac_chunk<kKChunk>(acc, xb + rg * xpitch + ui * F + k0, xpitch, wc, G, H, u4);
        else
          mac_chunk<kKChunk>(acc, hs + rg * hp + (k0 - F), hp, wc, G, H, u4);
      }
      __syncthreads();  // every thread is done reading h
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        const int row = rg + 8 * r;
        float hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kRoundV2) {
            const float ig = sigmoid_v2(rnd(acc[0][r][j]));
            const float fg = sigmoid_v2(rnd(acc[1][r][j]));
            const float gg = rnd(tanhf(rnd(acc[2][r][j])));
            const float og = sigmoid_v2(rnd(acc[3][r][j]));
            c[r][j] = fg * c[r][j] + rnd(ig * gg);
            hv[j] = rnd(og * rnd(tanhf(c[r][j])));
          } else {
            const float ig = sigmoid_f(acc[0][r][j]);
            const float fg = sigmoid_f(acc[1][r][j]);
            const float gg = tanhf(acc[2][r][j]);
            const float og = sigmoid_f(acc[3][r][j]);
            c[r][j] = fg * c[r][j] + ig * gg;
            hv[j] = rnd(og * tanhf(c[r][j]));
          }
        }
        store4(hs + row * hp + u4, hv);
        if constexpr (kStageH) {
          store4(ob + row * opitch + ui * H + u4, hv);
        } else {
          const int gr = row0 + row;
          if (gr < R) store4(outd + static_cast<long long>(gr) * (Tn * H) + t * H + u4, hv);
        }
      }
    }
    if constexpr (kStageH) {
      fence_proxy_async();  // this thread's h stores, before the bulk copies read them
      __syncthreads();
      if (tid == 0) {
        const unsigned bytes = len * H * sizeof(T);
        for (int r = 0; r < nvalid; ++r)
          bulk_s2g(outd + (static_cast<long long>(row0 + r) * Tn + t0) * H, ob + r * opitch, bytes);
        bulk_commit();
      }
    }
  }
  cp_async_wait_all();  // the last step prefetched a chunk nobody reads
  if constexpr (kStageH) {
    if (tid == 0) bulk_wait_all();
  }
}

template <typename T, int kKChunk, bool kStageH, bool kRoundV2, int kMinBlocks>
int launch(const Args& a, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kKChunk, kStageH>(a.F, a.H);
  cudaError_t err = cudaFuncSetAttribute(slab_kernel<T, kKChunk, kStageH, kRoundV2, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.R + kRows - 1) / kRows, D);
  slab_kernel<T, kKChunk, kStageH, kRoundV2, kMinBlocks><<<grid, 2 * a.H, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slab_scan
