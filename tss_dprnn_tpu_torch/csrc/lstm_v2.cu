// Persistent LSTM scan with chunked copies in and out, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_manual_kernel` (tss_dprnn_tpu/ops/pallas_lstm.py:275,
// launched by _pallas_core_v2 :373 for lstm_scan_pallas_v2 :418 and
// bilstm_pallas_v2 :402): `_lstm_kernel`'s function (csrc/lstm.cu) as one
// program per (direction, row tile) looping over all of T, x brought in a
// chunk of steps ahead and h written out a chunk at a time, both
// double-buffered. Per step and direction d:
//   g = x_t @ W_ih[d] + h @ W_hh[d] + b[d]      (fp32 accumulator)
//   i, f, o = sigmoid(g_i, g_f, g_o); gg = tanh(g_g)   (torch gate order i, f, g, o)
//   c = f * c + i * gg                          (fp32)
//   h = o * tanh(c)
// In a 16-bit stream type the TPU kernel's source rounds more often than
// `_lstm_kernel` (pallas_lstm.py:334-340), and so does this one: the gates
// after the bias, each operation of the activations (the sigmoid's exp, 1 +
// and 1 /, and tanh; each in fp32 from rounded operands), i * gg, tanh(c)
// and h. fp32 streams round nowhere. Two layouts: D stacked directions, each
// on its own input x [D, R, T, F] in forward time (lstm_scan_pallas_v2; the
// TPU entry pads T to a chunk multiple at the end, which changes no real
// step); or D = 2 on one shared x [R, T, F] with direction 1 walking the
// chunks and the steps inside them backwards (bilstm_pallas_v2). out is
// [D, R, T, H], every direction in forward time.
//
// What bounds it: the arithmetic, 2 * (F + H) * 4H = 262,144 FLOP per row-step
// and direction at F = H = 128 against 2 * (F + H) bytes of fresh input and
// output (fp32).
//
// Design: the TPU kernel's, on Hopper: slab_scan.cuh's kernel with the h
// slabs staged. One persistent block per (direction, 16-row tile) keeps h in
// shared memory and c in registers across all of T. x arrives in chunks of 4
// steps one chunk ahead: thread 0 issues one bulk copy per row into the idle
// buffer, completion on an mbarrier per buffer, in place of make_async_copy
// and its DMA semaphores. Each chunk's h is stored into a shared buffer and
// leaves by one bulk copy per row while the next chunk computes; before a
// buffer is reused, thread 0 waits for the copy of two chunks ago (the TPU
// kernel's out_dma(tc - 2).wait()). Sizes, fp32: two x chunks and two h
// chunks of 16 rows x 4 steps x 128 take 129 KB, W's chunks of 16 k-rows 64 KB
// and the h tile 8.3 KB, 201 KB in all: one block per SM. Chunks of 5 steps
// would not fit.

#include "slab_scan.cuh"

extern "C" {

// dtype: 0 = float32 streams, 1 = bfloat16 streams. shared = 0: x [D, R, T, F];
// shared = 1 (D must be 2): x [R, T, F], direction 1 reversed. out: [D, R, T, H].
// All contiguous in the stream type; w_ih: [D, F, 4H], w_hh: [D, H, 4H], b:
// [D, 4H], fp32 holding stream-type values. Every pointer 16-byte aligned; F
// and H multiples of 16, H <= 128. Returns a cudaError_t code (0 = launched).
int lstm_v2_forward(int dtype, int shared, const void* x, const void* w_ih, const void* w_hh,
                    const void* b, void* out, int D, int R, int Tn, int F, int H, void* stream) {
  using namespace slab_scan;
  if (shared && D != 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long x_dir = shared ? 0 : static_cast<long long>(R) * Tn * F;
  const Args a = {x, x_dir, static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
                  static_cast<const float*>(b), out, shared, R, Tn, F, H};
  if (dtype == 0) return launch<float, 16, true, true, 1>(a, D, s);
  if (dtype == 1) return launch<__nv_bfloat16, 16, true, true, 1>(a, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_v2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
