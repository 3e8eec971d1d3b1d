// Device helpers shared by the LSTM scan kernels (bilstm2.cu, bilstm2_bwd.cu,
// lstm.cu, lstm_bwd.cu): stream-type conversion, the gate sigmoid, cp.async
// copies, 16-byte loads and stores, and the forward kernels' chunk product.
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

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// acc[gate][r][j] += A[row_r][k0 + kk] * W[k0 + kk][gate * H + u4 + j] for one
// chunk of kKChunk k-rows. a_row0 points at A[rg][k0]; the thread's NR rows
// are rg, rg + 8, ..., rg + 8 (NR - 1).
template <int kKChunk, typename AT, int NR>
__device__ __forceinline__ void mac_chunk(float (&acc)[4][NR][4], const AT* a_row0, int a_stride,
                                          const float* wc, int G, int H, int u4) {
#pragma unroll
  for (int kk = 0; kk < kKChunk; ++kk) {
    float a[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) a[r] = to_f(a_row0[8 * r * a_stride + kk]);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 w = *reinterpret_cast<const float4*>(wc + kk * G + g * H + u4);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        acc[g][r][0] = fmaf(a[r], w.x, acc[g][r][0]);
        acc[g][r][1] = fmaf(a[r], w.y, acc[g][r][1]);
        acc[g][r][2] = fmaf(a[r], w.z, acc[g][r][2]);
        acc[g][r][3] = fmaf(a[r], w.w, acc[g][r][3]);
      }
    }
  }
}

}  // namespace scan_common
