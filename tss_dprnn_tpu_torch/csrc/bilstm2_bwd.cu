// Backward of the fused bidirectional LSTM scan for Hopper (sm_90a), fp32 or
// bf16 streams: the reverse dh/dc scan, with W_hh^T resident in the shared
// memory of a 2-CTA cluster.
//
// Replaces the TPU kernel `_bilstm2_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:1224, launched by bilstm2_backward_tm :1429),
// unmasked and masked, batch-major and time-major (the scan's layout
// template parameter; dx, dW and db are products over all row-steps in
// either order). Given the forward's gate pre-activations pre
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
// bf16 streams (the TPU kernel's bf16 mode): c_prev, tanh(c) and the
// cotangents are bf16, dpre is rounded to bf16 where the TPU kernel rounds it,
// dpre @ W_hh^T runs as bf16 mma.sync, dpre is stored bf16 and db's unrounded
// partial sums go to dbpart (cluster_scan.cuh); the bf16-operand products of
// csrc/products.cu then read x, h_prev and dpre as they are.
//
// What bounds it: dpre @ W_hh^T, 2 * 4H * H FLOP per row-step and direction
// (fp32 FMAs, or bf16 tensor-core products), and the step-to-step dependency.

#include "cluster_scan.cuh"

using namespace cluster_scan;

extern "C" {

// The reverse scan. height: rows per tile, one of 16, 24, 32, 40, 48 (bf16:
// 16, 32, 48). dtype: 0 = fp32 streams, 1 = bf16. pre: [R, T, 2, 4H] fp32,
// the forward's gate pre-activations; dpre: [R, T, 2, 4H] out in the stream
// type. cp_d, tc_d, g_d: [R, T, H] in the stream type; wsplit: fp32 W_hh^T
// laid out [2, 2, 4, H / 2, H] (direction, half, gate, unit, k), bf16 in the
// fragment order of ops/bilstm2.bwd_weight_layout_bf16; lens: [R] int32 or
// null; dbpart: [tiles * 8, 2, 4H] fp32 out (bf16 only, else null).
// time_major: 1 for the time-major layout (pre and dpre [T, R, 2, 4H], the
// streams [T, R, H]), 0 for the batch-major one. All contiguous, 16-byte
// aligned; H a multiple of 16, at most 128. Returns a cudaError_t code (0 =
// launched).
int bilstm2_bwd_scan(int height, int dtype, const void* pre, void* dpre, const void* cp0,
                     const void* tc0, const void* g0, const void* cp1, const void* tc1,
                     const void* g1, const void* wsplit, const void* lens, void* dbpart, int R,
                     int Tn, int H, int time_major, void* stream) {
  BwdScanArgs a = {};
  a.pre = static_cast<const float*>(pre);
  a.dpre = dpre;
  a.cp[0] = cp0;
  a.cp[1] = cp1;
  a.tc[0] = tc0;
  a.tc[1] = tc1;
  a.g[0] = g0;
  a.g[1] = g1;
  a.wsplit = wsplit;
  a.lens = static_cast<const int*>(lens);
  a.dbpart = static_cast<float*>(dbpart);
  a.pre_dir = 4 * H;   // [R, T, 2, 4H] or [T, R, 2, 4H]: the two directions side by side
  a.pre_step = 8 * H;
  a.down1 = 0;         // direction 1 scanned backwards: its backward runs forwards
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return time_major ? bwd_scan<true>(height, dtype, a, 2, s)
                    : bwd_scan<false>(height, dtype, a, 2, s);
}

// How many clusters of the scan at this tile height and dtype (as above) the
// card runs at once.
int bilstm2_bwd_max_clusters(int height, int dtype, int H, int* clusters) {
  return bwd_scan_max_clusters(height, dtype, H, clusters);
}

const char* bilstm2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
