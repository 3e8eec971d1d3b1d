// Device helpers shared by the LSTM kernels (the cluster scans of
// bilstm2_serve.cu, bilstm2_resid.cu, bilstm2_bwd.cu and lstm_bwd.cu) and
// products.cu: stream-type conversion and rounding, the gate sigmoid (and its
// bf16-rounded form), cp.async copies, bulk copies into shared memory with
// their mbarriers, and 16-byte loads.
// Everything is force-inlined, so each kernel keeps its own register budget.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_common {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the stream type S and back (a no-op for fp32)
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<S>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }
// 1 / (1 + exp(-v)) with each operation rounded to the stream type S, as the
// manual-DMA TPU kernel's source computes it in a 16-bit type
// (tss_dprnn_tpu/ops/pallas_lstm.py:334-340)
template <typename S>
__device__ __forceinline__ float sigmoid_rounded(float v) {
  return round_to<S>(1.0f / round_to<S>(1.0f + round_to<S>(expf(-v))));
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// every cp.async group of this thread but the newest N has completed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Bulk copies into shared memory (the TMA engine without a tensor map) and
// the mbarriers that track them, for the resident weight slices of the
// cluster scans (cluster_scan.cuh). Addresses of shared memory are 32-bit
// shared-window addresses; every copy moves a multiple of 16 bytes between
// 16-byte aligned addresses.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` from bulk copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* smem, const void* gmem, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace scan_common
