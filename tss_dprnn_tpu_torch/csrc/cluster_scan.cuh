// Helpers of the fused bidirectional LSTM's training scans (bilstm2_resid.cu,
// bilstm2_bwd.cu), which run as 2-CTA thread-block clusters: each cluster is a
// (direction, row tile), its two CTAs split the hidden units in halves, and
// each CTA keeps its slice of W_hh in shared memory for the whole scan.
// The cluster barrier, distributed shared-memory stores, the one-time bulk load of the
// resident weight slice and the cluster launch.

#pragma once

#include "scan_common.cuh"

namespace cluster_scan {

using namespace scan_common;

constexpr unsigned kBulkChunk = 16384;  // bytes per bulk copy of the weight slice

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both CTAs arrives; shared-memory writes before it (local
// and remote) are visible to every thread after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared::cluster address of `p`'s counterpart in CTA `rank`
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// two consecutive floats (8-byte aligned): load, store, store into a cluster
// peer's shared memory, and copy global -> shared with cp.async (zero-filled
// when !ok)
__device__ __forceinline__ void ld2(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void st2(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st2_cluster(unsigned addr, const float (&v)[2]) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v[0]), "f"(v[1])
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* smem, const float* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 8 : 0));
}

// Thread 0 starts the bulk copy of `bytes` (a multiple of 16) from src into
// dst, counted on `bar`. The barrier is initialised here: a CTA-wide barrier
// must separate this call from any mbar_wait(bar, 0).
__device__ __forceinline__ void load_resident(float* dst, const float* src, unsigned bytes,
                                              uint64_t* bar) {
  if (threadIdx.x != 0) return;
  mbar_init(bar, 1);
  mbar_init_fence();
  mbar_arrive_expect_tx(bar, bytes);
  for (unsigned off = 0; off < bytes; off += kBulkChunk)
    bulk_g2s(dst + off / 4, src + off / 4, min(kBulkChunk, bytes - off), bar);
}

inline cudaLaunchConfig_t cluster_config(int tiles, int threads, size_t smem, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, tiles, 2);  // (CTA of the cluster, row tile, direction)
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` as 2-CTA clusters over (tiles, 2 directions); returns a
// cudaError_t code.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int tiles, int threads, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(tiles, threads, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many such clusters the card runs at once.
template <typename Kernel>
int max_clusters(Kernel kernel, int threads, size_t smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, threads, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

}  // namespace cluster_scan
