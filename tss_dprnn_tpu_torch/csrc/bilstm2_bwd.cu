// Backward of the fused bidirectional LSTM scan for Hopper (sm_90a), fp32: the
// reverse dh/dc scan, with W_hh^T resident in the shared memory of a 2-CTA
// cluster.
//
// Replaces the TPU kernel `_bilstm2_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:1224, launched by bilstm2_backward_tm :1429),
// unmasked and masked. Given the forward's gate pre-activations pre
// [R, T, 2, 4H] (saved by csrc/bilstm2_resid.cu, not recomputed), its c_prev
// and tanh(c) streams and the output cotangents g_d [R, T, H], the scan of
// csrc/cluster_scan.cuh (`bwd_scan_kernel`, whose header gives the arithmetic
// and the design) turns them into dpre [R, T, 2, 4H], a separate buffer.
// dx = sum_d dpre_d @ W_ih[d]^T, dW_ih, dW_hh and db are products over all
// row-steps at once and run in csrc/products.cu.
// Direction 0 runs t = T-1..0, direction 1 t = 0..T-1 (each the reverse of its
// scan). Masked: steps with t >= len[row] give no dpre and pass the carries
// through, in both directions (direction 1 held its zero state there; out0 past
// the length is unspecified, so its cotangent there is discarded).
//
// What bounds it: the fp32 FMAs of dpre @ W_hh^T, 2 * 4H * H FLOP per
// row-step and direction, and the step-to-step dependency.

#include "cluster_scan.cuh"

using namespace cluster_scan;

extern "C" {

// The reverse scan. height: rows per tile, one of 16, 24, 32, 40, 48. pre:
// [R, T, 2, 4H], the forward's gate pre-activations; dpre: [R, T, 2, 4H] out.
// cp_d, tc_d, g_d: [R, T, H]; wsplit: W_hh^T laid out [2, 2, 4, H / 2, H]
// (direction, half, gate, unit, k); lens: [R] int32 or null. All fp32,
// contiguous, 16-byte aligned; H a multiple of 16, at most 128. Returns a
// cudaError_t code (0 = launched).
int bilstm2_bwd_scan(int height, const void* pre, void* dpre, const void* cp0, const void* tc0,
                     const void* g0, const void* cp1, const void* tc1, const void* g1,
                     const void* wsplit, const void* lens, int R, int Tn, int H, void* stream) {
  BwdScanArgs a = {};
  a.pre = static_cast<const float*>(pre);
  a.dpre = static_cast<float*>(dpre);
  a.cp[0] = static_cast<const float*>(cp0);
  a.cp[1] = static_cast<const float*>(cp1);
  a.tc[0] = static_cast<const float*>(tc0);
  a.tc[1] = static_cast<const float*>(tc1);
  a.g[0] = static_cast<const float*>(g0);
  a.g[1] = static_cast<const float*>(g1);
  a.wsplit = static_cast<const float*>(wsplit);
  a.lens = static_cast<const int*>(lens);
  a.pre_dir = 4 * H;   // [R, T, 2, 4H]: the two directions side by side
  a.pre_step = 8 * H;
  a.down1 = 0;         // direction 1 scanned backwards: its backward runs forwards
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return bwd_scan(height, a, 2, static_cast<cudaStream_t>(stream));
}

// How many clusters of the scan at this tile height the card runs at once.
int bilstm2_bwd_max_clusters(int height, int H, int* clusters) {
  return bwd_scan_max_clusters(height, H, clusters);
}

const char* bilstm2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
