// Backward of the stacked-direction LSTM scan for Hopper (sm_90a), fp32 or
// bf16 streams: the reverse dh/dc scan, with W_hh^T resident in the shared
// memory of a 2-CTA cluster.
//
// Replaces the TPU kernel `_lstm_bwd_kernel`
// (tss_dprnn_tpu/ops/pallas_lstm.py:498, launched by lstm_backward :632). Given,
// per direction d, the gate pre-activations pre[d] [R, T, 4H] saved by the
// forward (ops/lstm.lstm_forward_resid; none is recomputed), its c_prev and
// tanh(c) streams and the output cotangent g[d] [R, T, H], the scan of
// csrc/cluster_scan.cuh (`bwd_scan_kernel`, whose header gives the arithmetic
// and the design) turns them into dpre[d] [R, T, 4H], a separate buffer, so a
// second backward on the same saved tensors gives the same result. Every
// direction runs t = T-1..0 (the forward never reverses). bf16 streams (the
// TPU kernel's bf16 mode): c_prev, tanh(c) and the cotangent are bf16, dpre
// is rounded to bf16 where the TPU kernel rounds it, dpre @ W_hh^T runs as
// bf16 mma.sync, dpre is stored bf16 and db's unrounded partial sums go to
// dbpart (cluster_scan.cuh).
// dx[d] = dpre @ W_ih[d]^T, dW_ih[d] = sum x^T dpre, dW_hh[d] = sum h_prev^T
// dpre and db[d] = sum dpre are products over all row-steps at once: the
// product and column-sum kernels of csrc/products.cu
// (tss_dprnn_tpu_torch/ops/lstm.py launches them after this scan).
//
// What bounds it: 2 * 2 (F + H) 4H FLOP per row-step and direction in all
// (the forward's twice: the gates are read, not recomputed), of which the
// scan's share is the recurrent product dpre @ W_hh^T, 2 * 4H * H, and the
// step-to-step dependency. With D = 1 and the inter-chunk shapes' rows
// (1,250-2,000) there are few row tiles: ops/lstm.py takes the tile height
// from cudaOccupancyMaxActiveClusters (the smallest that fits one wave).

#include "cluster_scan.cuh"

using namespace cluster_scan;

extern "C" {

// The reverse scan over D stacked directions. height: rows per tile, one of
// 16, 24, 32, 40, 48 (bf16: 16, 32, 48). dtype: 0 = fp32 streams, 1 = bf16.
// pre: [D, R, T, 4H] fp32; dpre: [D, R, T, 4H] out in the stream type; cp,
// tc, g: [D, R, T, H] in the stream type; wsplit: fp32 W_hh^T laid out
// [D, 2, 4, H / 2, H] (direction, half, gate, unit, k), bf16 in the fragment
// order of ops/bilstm2.bwd_weight_layout_bf16; dbpart: [tiles * 8, D, 4H]
// fp32 out (bf16 only, else null). All contiguous, 16-byte aligned; D 1 or
// 2; H a multiple of 16, at most 128. Returns a cudaError_t code (0 =
// launched).
int lstm_bwd_scan(int height, int dtype, const void* pre, void* dpre, const void* cp,
                  const void* tc, const void* g, const void* wsplit, void* dbpart, int D, int R,
                  int Tn, int H, void* stream) {
  if (D < 1 || D > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long steps = static_cast<long long>(R) * Tn;  // row-steps of one direction
  const long long size = dtype == 1 ? 2 : 4;                // bytes per stream element
  BwdScanArgs a = {};
  a.pre = static_cast<const float*>(pre);
  a.dpre = dpre;
  for (int d = 0; d < 2; ++d) {
    const long long off = (d < D ? d : 0) * steps * H * size;
    a.cp[d] = static_cast<const char*>(cp) + off;
    a.tc[d] = static_cast<const char*>(tc) + off;
    a.g[d] = static_cast<const char*>(g) + off;
  }
  a.wsplit = wsplit;
  a.lens = nullptr;
  a.dbpart = static_cast<float*>(dbpart);
  a.pre_dir = steps * 4 * H;
  a.pre_step = 4 * H;
  a.down1 = 1;
  a.R = R;
  a.Tn = Tn;
  a.H = H;
  return bwd_scan(height, dtype, a, D, static_cast<cudaStream_t>(stream));
}

// How many clusters of the scan at this tile height and dtype (as above) the
// card runs at once.
int lstm_bwd_max_clusters(int height, int dtype, int H, int* clusters) {
  return bwd_scan_max_clusters(height, dtype, H, clusters);
}

const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
