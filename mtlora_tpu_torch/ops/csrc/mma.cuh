// Tensor-core helpers shared by the port's kernels: mma.sync m16n8k16
// (bf16 in, fp32 accumulate), the 32-bit and ldmatrix fragment loads that
// feed it, and the cp.async copies that stage tiles in shared memory.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                           a[2] = (g, 2t+8..),   a[3] = (g+8, 2t+8..);
//   B (16 x 8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g),
//                           so B is read from an [n][k] array, k contiguous;
//   C (16 x 8):             c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 at p and p + stride as one register, the first in the low half.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p,
                                            int stride) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) |
         ((uint32_t)__bfloat16_as_ushort(p[stride]) << 16);
}

// A fragment of a 16 x 16 bf16 tile at `base` (row stride ld elements).
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base,
                                       int ld, int g, int t) {
  a[0] = ld32(base + g * ld + 2 * t);
  a[1] = ld32(base + (g + 8) * ld + 2 * t);
  a[2] = ld32(base + g * ld + 2 * t + 8);
  a[3] = ld32(base + (g + 8) * ld + 2 * t + 8);
}

// 16 bytes global -> shared without passing through registers, of which
// the first `bytes` (0..16) are read and the rest written as zeros (a
// copy that ends inside an array's last chunk).
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// The same, whole (`in`) or all zeros (a source size of 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  cp_async16_n(dst, src, in ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8 (16-byte aligned). Without .trans
// lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each
// matrix; with .trans, column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two matrices, transposed: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// Bytes of dynamic shared memory the block was launched with.
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}
