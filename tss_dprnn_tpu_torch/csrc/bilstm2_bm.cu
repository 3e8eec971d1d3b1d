// Fused bidirectional LSTM scan over time-blocked batch-major slabs, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bilstm2_bm_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:1088,
// launched by bilstm2_forward_bm :1193): the unmasked inference function of
// `_bilstm2_kernel` (csrc/bilstm2.cu), computed in the public batch-major
// layout. Per step and direction d:
//   g = x_t @ W_ih[d] + h @ W_hh[d] + b[d]      (fp32 accumulator)
//   i, f, o = sigmoid(g_i, g_f, g_o); gg = tanh(g_g)   (torch gate order i, f, g, o)
//   c = f * c + i * gg                          (fp32)
//   h = round_to_stream_type(o * tanh(c))       (fed back rounded)
// Direction 0 scans t = 0..T-1, direction 1 t = T-1..0, both on one x [R, T, F];
// out [2, R, T, H] holds both in forward time. The TPU entry pads T to its
// 8-step blocks and holds direction 1 on the pad steps; here the last slab is
// short instead, which is the same function.
//
// What bounds it: the arithmetic, 2 * (F + H) * 4H = 262,144 FLOP per row-step
// and direction at F = H = 128 against 2 * (F + H) bytes of fresh input and
// output (fp32), as for the fused kernel.
//
// Design: what the TPU kernel is for, time-blocked batch-major slabs, on
// Hopper: slab_scan.cuh's kernel, one block per (direction, 16-row tile)
// looping over T in slabs of 4 steps. A row's slab is one contiguous span of
// 4 F elements, so thread 0 brings the next slab in with one bulk copy per row
// (completion on an mbarrier) while the block computes the current one; each
// step stores its h directly. Sizes: a double-buffered fp32 slab of 16 rows x
// 4 steps x 128 is 64.5 KB; the TPU's 32 rows x 8 steps would be 256 KB, over
// the 227 KB a block may have. With W in chunks of 8 k-rows (2 x 16 KB) and
// the h tile (8.3 KB) a block takes 105 KB, so two blocks share an SM, as the
// fused kernel's do; 16 k-row chunks (137 KB) would leave one.

#include "slab_scan.cuh"

extern "C" {

// dtype: 0 = float32 streams, 1 = bfloat16 streams. x: [R, T, F] and out:
// [2, R, T, H] (direction 0, then direction 1), contiguous in the stream type;
// w_ih: [2, F, 4H], w_hh: [2, H, 4H], b: [2, 4H], fp32. Every pointer 16-byte
// aligned; F and H multiples of 16, H <= 128. Returns a cudaError_t code
// (0 = launched).
int bilstm2_bm_forward(int dtype, const void* x, const void* w_ih, const void* w_hh,
                       const void* b, void* out, int R, int Tn, int F, int H, void* stream) {
  using namespace slab_scan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {x, 0, static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
                  static_cast<const float*>(b), out, 1, R, Tn, F, H};
  if (dtype == 0) return launch<float, 8, false, false, 2>(a, 2, s);
  if (dtype == 1) return launch<__nv_bfloat16, 8, false, false, 2>(a, 2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* bilstm2_bm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
