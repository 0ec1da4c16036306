// TMA boxes of weights into 128-byte-swizzled shared-memory slots, their
// mbarriers, and the products on such slots: the parts that ln_mlp.cu
// (kernel 4), ln_lora_qkv_bwd.cu (kernel 2b, y-only), merge_ln_fwd.cu
// (kernels 3 and 6) and head_mlp_fwd.cu (kernel 7) share. A slot is a
// box of up to 64 rows of 64 bf16 (128 bytes), its 16-byte chunks of row
// r XOR-swizzled by r % 8; slots start at 1024-byte boundaries (the
// swizzle's period). Tensor maps are built per call on the host with the
// driver's cuTensorMapEncodeTiled, reached through the runtime.
#pragma once

#include <cuda.h>

#include "slice_ring.cuh"

namespace lnk {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// An mbarrier that n arrivals complete (no fence: the caller fences once
// after initialising all of them).
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(n));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Box (c0.., r0..) of a tensor map into shared memory; its bytes complete
// on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory into shared
// memory, both 16-byte aligned; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Element (r, c) of a slot: 64 rows of 128 bytes, the 16-byte chunks of
// row r XOR-swizzled by r % 8 (TMA's 128-byte swizzle), so that ldmatrix
// reads 8 rows at one column without bank conflicts.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSliceW + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// acc[nt] += A B^T for the warp's 16 rows and the n-tiles n0 + 8 nt (NT
// even): A's fragments given, B a resident slot read as [n][k].
template <int NT>
__device__ __forceinline__ void mma_slot(float (*acc)[4],
                                         const uint32_t (*af)[4],
                                         const bf16* sl, int n0, int ks) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 0; k < kSliceW / 16; ++k)
    if (k < ks)
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, sl + swz(n0 + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                            16 * k + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(acc[2 * p], af[k], b[0], b[1]);
        mma_bf16_16816(acc[2 * p + 1], af[k], b[2], b[3]);
      }
}

// acc[nt] += A B for the warp's 16 rows and the n-tiles n0 + 8 nt (NT
// even): A's fragments given, B a resident slot read as [k][n]
// (ldmatrix.trans).
template <int NT>
__device__ __forceinline__ void mma_slot_t(float (*acc)[4],
                                           const uint32_t (*af)[4],
                                           const bf16* sl, int n0, int ks) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 0; k < kSliceW / 16; ++k)
    if (k < ks)
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, sl + swz(16 * k + (lane & 15),
                              n0 + 16 * p + (lane >> 4) * 8));
        mma_bf16_16816(acc[2 * p], af[k], b[0], b[1]);
        mma_bf16_16816(acc[2 * p + 1], af[k], b[2], b[3]);
      }
}

// The A fragments of the 16 rows r0.. x 16 ks columns of a resident slot.
__device__ __forceinline__ void a_frags_slot(uint32_t (*af)[4],
                                             const bf16* sl, int r0,
                                             int ks) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 0; k < kSliceW / 16; ++k)
    if (k < ks)
      ldsm_x4(af[k], sl + swz(r0 + (lane & 15), 16 * k + (lane >> 4) * 8));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link
// against libcuda); null if the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A row-major bf16 [rows][cols] array as boxes of box_rows x box_cols
// (64 x 64 by default), 128-byte swizzle (or `swizzle`: a box of 16
// columns takes the 32-byte one).
inline bool box_map(CUtensorMap* m, const void* p, int rows, int cols,
                    int box_rows = kSliceW, int box_cols = kSliceW,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace lnk
