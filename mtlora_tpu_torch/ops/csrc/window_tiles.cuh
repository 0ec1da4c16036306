// Tile pieces shared by the window attention kernels on tensor cores:
// the forward (window_attn_fwd.cu, kernels 1 and 1c) and the backward
// (window_attn_bwd.cu, kernels 1b and 1c's). Head dim 32; N <= 64 padded
// to 64 rows; a window's tiles of one head are [64][32] bf16 whose 16-byte
// chunks are XOR-swizzled, so that ldmatrix reads of 8 consecutive rows
// hit 8 distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace wtile {

constexpr int kHd = 32;     // head dim
constexpr int kRows = 64;   // N padded
constexpr int kCell = 8;    // windows per dense cell (kernel 1c)
constexpr int kTile = kRows * kHd;   // elements of a q/k/v/dO tile

// 16-byte chunks of a mask tile's copy: the tile starts up to 3 floats
// into its first chunk
__host__ __device__ constexpr int mask_chunks(int N) { return (N * N + 6) / 4; }

// Element offset of 16-byte chunk c (0..3) of row r of a [64][32] tile,
// and of chunk c (0..7) of row r of a [64][64] tile: the chunk index XOR
// the row bits, so that 8 consecutive rows of one chunk hit 8 distinct
// bank groups.
__device__ __forceinline__ int sw32(int r, int c) {
  return r * kHd + ((c ^ ((r >> 1) & 3)) << 3);
}
__device__ __forceinline__ int sw64(int r, int c) {
  return r * kRows + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// max and sum over the 4 lanes of a quad (the lanes that hold one row of
// an mma C fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q, k, v of head h of window w (and, with kParts = 4, dO), rows < N, into
// a buffer's consecutive tiles by cp.async; rows >= N are not written.
template <int kParts, int kThreads>
__device__ __forceinline__ void load_window(__nv_bfloat16* buf,
                                            const __nv_bfloat16* qkv,
                                            const __nv_bfloat16* dout, int w,
                                            int h, int N, int C) {
  constexpr int kPer = 4 * kParts;   // 16-byte chunks of a row
  const __nv_bfloat16* base = qkv + (size_t)w * N * 3 * C + h * kHd;
  const __nv_bfloat16* dbase = dout + (size_t)w * N * C + h * kHd;
  for (int i = threadIdx.x; i < N * kPer; i += kThreads) {
    const int r = (unsigned)i / kPer, part = ((unsigned)i % kPer) >> 2,
              c = i & 3;
    const __nv_bfloat16* src =
        part < 3 ? base + (size_t)r * 3 * C + part * C + c * 8
                 : dbase + (size_t)r * C + c * 8;
    cp_async16(buf + part * kTile + sw32(r, c), src, true);
  }
}

// Mask tile mi as it lies in the mask array (16-byte aligned at its
// start), from the 16-byte chunk that holds its first element: element
// (r, c) lands at slot[(mi * N * N) % 4 + r * N + c]. The last chunk of
// the array is read only up to the array's end.
template <int kThreads>
__device__ __forceinline__ void load_mask(float* slot, const float* mask,
                                          int mi, int NN, const float* end) {
  const float* start = mask + (size_t)mi * NN;
  const float* a0 = start - ((size_t)mi * NN & 3);
  const int n = ((int)(start - a0) + NN + 3) >> 2;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float* src = a0 + 4 * k;
    const long left = (long)(end - src) * 4;
    cp_async16_n(slot + 4 * k, src, left < 16 ? (int)left : 16);
  }
}

}  // namespace wtile
