// The mma.sync building blocks of the kernels that run products on the tensor
// cores (products.cu, bilstm2_serve.cu). 3xTF32, for fp32-accurate products:
// the split of an fp32 value into two TF32 values, mma.sync m16n8k8 tf32 with
// and without an accumulator, and the ldmatrix load of an A fragment from a
// [m][k] fp32 tile; products.cu's header says why each k-step's three
// products go into a fresh partial that is added to the running sum in fp32.
// bf16: mma.sync m16n8k16 with fp32 accumulation, and the ldmatrix loads of
// its A fragment from a [m][k] tile and of its B fragments from a [k][n] one.

#pragma once

#include "scan_common.cuh"

namespace tf32_mma {

using scan_common::smem_addr;

// x = big + small + (a rest below 2^-22 |x|), big and small TF32 values
// rounded to nearest, ties away from zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a @ b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a @ b (no accumulator: C is zero)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// the four 8 x 4 fp32 matrices of an A fragment from a [m][k] tile: lane L
// gives the address of row L % 8 of matrix L / 8 (rows + 8 for matrices 1
// and 3, k + 4 for 2 and 3) and receives a0..a3 (row lane / 4, k lane % 4)
__device__ __forceinline__ void ldmatrix_x4(float (&a)[4], const float* row) {
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = __uint_as_float(r[q]);
}

// d += a @ b on the tensor cores, bf16 operands: a 16 x 16 (row), b 16 x 8
// (col; b0 holds k 2 lt, 2 lt + 1 and b1 k 2 lt + 8, 2 lt + 9 of column lg),
// d 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a @ b (no accumulator: C is zero), bf16 operands as mma_bf16
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// the A fragment of a 16 x 16 bf16 tile from its [m][k] rows: lane L gives
// the address of row L % 16 at k 8 (L / 16); register q receives rows lane /
// 4 + 8 (q & 1), k 2 (lane % 4) + 8 (q >> 1) and the k after it
__device__ __forceinline__ void ldmatrix_x4_b16(uint32_t (&a)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(row)));
}

// the B fragments of two 8-column n-tiles of a 16-deep bf16 k-step from a
// [k][n] tile (n contiguous), transposed on the way: lane L gives the address
// of k-row L % 8 + 8 ((L / 8) % 2) at column 8 (L / 16); b[0], b[1] are the
// first n-tile's b0, b1 of mma_bf16 and b[2], b[3] the second's. Also the A
// fragment of a 16 x 16 tile held [k][m] (m contiguous): lane L gives the
// address of k-row L % 8 + 8 (L / 16) at m 8 ((L / 8) % 2), and register q
// receives rows lane / 4 + 8 (q & 1), k 2 (lane % 4) + 8 (q >> 1) and the k
// after it, as ldmatrix_x4_b16 gives them from [m][k].
__device__ __forceinline__ void ldmatrix_x4_trans_b16(uint32_t (&b)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(row)));
}

}  // namespace tf32_mma
