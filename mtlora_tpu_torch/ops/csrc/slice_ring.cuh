// Weight slices streamed through shared memory and the products on them:
// the parts that the row kernels of ln_mlp_bwd.cu (kernel 4b) and
// ln_lora_tail_bwd.cu (kernel 2b, tail mode) share (ln_mlp.cu, kernel 4,
// takes a_frags and ksteps). Both give a block of
// kThreads threads BM rows; a warp owns 16 rows and a column span of every
// [64 x 64] product. (Their LayerNorm backward in registers stays in each
// kernel: as a function here it took 4b four more registers and 12 more
// bytes of spills, and 0.8% more time on the H100.)
//
// A slice is [64 x 64] bf16 of a row-major weight, stored in shared memory
// as 8 x 8 core matrices (element (r, c) at slot_off(r, c)), which
// ldmatrix reads either way round without bank conflicts: every weight is
// read in its module layout, ldmatrix.trans serving its transposed uses.
#pragma once

#include "ln_common.cuh"

namespace lnk {

constexpr int kSliceW = 64;                    // a slice: 64 x 64 bf16
constexpr int kSliceElems = kSliceW * kSliceW;

// Rows r0.., columns c0.. of src (row stride ld), zero outside
// [0, rows) x [0, cols).
struct Slice {
  const bf16* src;
  int ld, r0, c0, rows, cols;
};

__device__ __forceinline__ int slot_off(int r, int c) {
  return ((r >> 3) * 8 + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// The ring of weight slices of one block: kStages slots, the q-th slice
// being slice_of(a, q, ncs) (found by argument-dependent lookup beside
// the kernel's Args), streamed kGroup slices at a time. Every thread of
// the block calls next() at the same points: slice q is resident when
// next() returns it. Where q is a multiple of kGroup, next() waits for
// slices q .. q + kGroup - 1 and meets the block at a barrier, and
// slices q + kStages - kGroup .. q + kStages - 1 start streaming into the
// slots of q - kGroup .. q - 1, free because every thread passed that
// barrier after completing its products on them: kGroup slices per
// barrier, kStages - kGroup ahead. One cp.async group per kGroup slices,
// empty past the end. A warp copies 8 rows x 64 bytes per step: whole
// 32-byte sectors from device memory, and 8 consecutive lanes fill one
// core matrix (no bank conflicts).
template <class Args, int kThreads, int kStages, int kGroup = 1>
struct SliceRing {
  static_assert(kStages % kGroup == 0 && kStages >= 2 * kGroup,
                "kStages - kGroup slices ahead");
  bf16* buf;
  int q, total, ncs;

  __device__ __forceinline__ void load(const Args& a, int i) {
    constexpr int kWarps = kThreads / 32;
    if (i < total) {
      const Slice s = slice_of(a, i, ncs);
      bf16* dst = buf + (i % kStages) * kSliceElems;
#pragma unroll
      for (int p = 0; p < kSliceElems / 8 / kThreads; ++p) {
        const int u = (threadIdx.x >> 5) + p * kWarps, l = threadIdx.x & 31;
        const int row = 8 * (u & 7) + (l & 7);
        const int col = 8 * (4 * (u >> 3) + (l >> 3));
        const bool in = s.r0 + row < s.rows && s.c0 + col < s.cols;
        cp_async16(dst + slot_off(row, col),
                   in ? s.src + (size_t)(s.r0 + row) * s.ld + s.c0 + col
                      : s.src,
                   in);
      }
    }
  }

  // slices i .. i + kGroup - 1 as one cp.async group
  __device__ __forceinline__ void load_group(const Args& a, int i) {
    for (int k = 0; k < kGroup; ++k) load(a, i + k);
    cp_async_commit();
  }

  __device__ __forceinline__ void start(const Args& a) {
    for (int i = 0; i < kStages - kGroup; i += kGroup) load_group(a, i);
  }

  __device__ __forceinline__ const bf16* next(const Args& a) {
    if (q % kGroup == 0) {
      cp_async_wait<kStages / kGroup - 2>();
      __syncthreads();
      load_group(a, q + kStages - kGroup);
    }
    return buf + (q++ % kStages) * kSliceElems;
  }
};

// k-steps of 16 in the 64-column slice cs of C columns (C % 32 == 0: 2
// or 4).
__device__ __forceinline__ int ksteps(int C, int cs) {
  return min(kSliceW, C - kSliceW * cs) / 16;
}

// The A fragments of the warp's 16 rows x 16 ks columns at `a` (row
// stride lda), through ldmatrix; SC rounds s * A to bf16.
template <bool SC = false>
__device__ __forceinline__ void a_frags(uint32_t (*af)[4], const bf16* a,
                                        int lda, int ks, float s = 1.f) {
  const int lane = lane_id();
  const bf16* pa = a + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < kSliceW / 16; ++k)
    if (k < ks) {
      ldsm_x4(af[k], pa + 16 * k);
      if (SC)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[k][e] = scale_pair(af[k][e], s);
    }
}

// acc[nt] += A B as mma_sl does, with A's fragments given (a_frags).
template <int NT, bool TR>
__device__ __forceinline__ void mma_frags(float (*acc)[4],
                                          const uint32_t (*af)[4],
                                          const bf16* sl, int n0, int ks) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 0; k < kSliceW / 16; ++k)
    if (k < ks)
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        if (TR)
          ldsm_x4_t(b, sl + slot_off(16 * k + (lane & 15),
                                     n0 + 16 * p + (lane >> 4) * 8));
        else
          ldsm_x4(b, sl + slot_off(n0 + 16 * p + (lane & 7) +
                                       ((lane >> 4) << 3),
                                   16 * k + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(acc[2 * p], af[k], b[0], b[1]);
        mma_bf16_16816(acc[2 * p + 1], af[k], b[2], b[3]);
      }
}

// acc[nt] += A B for the warp's 16 rows and the n-tiles n0 + 8 nt
// (NT even): A [16 x 16 ks] at `a` (row stride lda) through ldmatrix, SC
// rounding s * A to bf16 first (du2 = bf16(s2 gy)); B a resident slice
// read as [n][k] (TR false) or [k][n] (TR true), mma.sync m16n8k16.
template <int NT, bool TR, bool SC = false>
__device__ __forceinline__ void mma_sl(float (*acc)[4], const bf16* a,
                                       int lda, const bf16* sl, int n0,
                                       int ks, float s = 1.f) {
  uint32_t af[kSliceW / 16][4];
  a_frags<SC>(af, a, lda, ks, s);
  mma_frags<NT, TR>(acc, af, sl, n0, ks);
}

// Rows [0, rows) x columns [0, cols) (cols % 8 == 0) of a shared tile (row
// stride ld) to rows m0 + i < M, columns c0.. of a device array (row
// stride ldo), 16 bytes a store, by all kThreads threads of the block.
template <int kThreads>
__device__ __forceinline__ void rows_out(bf16* out, int ldo, int c0,
                                         const bf16* tile, int ld, int m0,
                                         int M, int rows, int cols) {
  const int vc = cols / 8;
  for (int v = threadIdx.x; v < rows * vc; v += kThreads) {
    const int i = v / vc, c = (v - i * vc) * 8;
    if (m0 + i < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + i) * ldo + c0 + c) =
          *reinterpret_cast<const uint4*>(tile + i * ld + c);
  }
}

}  // namespace lnk
