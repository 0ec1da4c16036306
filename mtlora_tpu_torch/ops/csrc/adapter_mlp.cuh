// Shared pieces of the adapter MLP-tail kernels (adapter_mlp.cu, the
// probes' first-port forward; adapter_mlp_fwd.cu, kernel 5;
// adapter_mlp_bwd.cu, kernel 5b): the rank, the task count, the
// activations, and the pieces of the tensor-core kernels 5 and 5b, where
// the four tasks' ranks, T R = 16, are one mma.sync m16n8k16 depth: the
// weight tiles [h][16] in shared memory, p1 read straight into the C
// layout of a pair of n8 tiles, the task masks, bf16 packing, and the
// fixed-order sum of per-chunk partials.
//
// The columns of a pair of n8 tiles are permuted (logical column c of tile
// j is column 4 (c / 2) + 2 j + c % 2 of the pair), so that a lane's four
// p1 values of a row are adjacent: 8 bytes a lane and row, whole 32-byte
// sectors a warp.
#pragma once

#include "ln_common.cuh"

namespace adk {

using lnk::Act;
using lnk::act_fwd;
using lnk::act_pair;
using lnk::bf16;
using lnk::bf2;
using lnk::kGelu;

constexpr int R = 4;           // rank of every task (r_max)
constexpr int kMaxT = 4;       // tasks
constexpr int kTR = kMaxT * R;   // (task, rank) pairs: one mma depth

// Element offset of (column h, k = t R + r) in an [h][16] weight tile:
// 128-byte lines of four columns, their 16-byte units swizzled so that
// the eight columns an ldmatrix reads (4 (i / 2) + 2 j + i % 2 of a pair,
// in either half of k) fall in eight distinct units.
__device__ __forceinline__ int wt_off(int h, int k) {
  const int line = h >> 2, u = 2 * (h & 3) + (k >> 3);
  const int f = ((line & 1) << 2) | ((line >> 1) & 1);
  return line * 64 + (u ^ f) * 8 + (k & 7);
}

// Columns c0 .. c0 + n of B1 and A2T ([T R, H4] each), every task's, as
// [h][tr] tiles wb and wa (zeros past T R and past H4), by all threads of
// the block, 8 columns (16 bytes) a load.
template <int T>
__device__ __forceinline__ void stage_weight_tiles(bf16* wb, bf16* wa,
                                                   const bf16* b1,
                                                   const bf16* a2, int H4,
                                                   int c0, int n) {
  const int units = n / 8;
  for (int i = threadIdx.x; i < kTR * units; i += blockDim.x) {
    const int tr = i / units, h = 8 * (i - tr * units);
    uint4 vb = make_uint4(0u, 0u, 0u, 0u), va = vb;
    if (tr < T * R && c0 + h < H4) {
      const size_t o = (size_t)tr * H4 + c0 + h;
      vb = __ldg(reinterpret_cast<const uint4*>(b1 + o));
      va = __ldg(reinterpret_cast<const uint4*>(a2 + o));
    }
    const bf16* eb = reinterpret_cast<const bf16*>(&vb);
    const bf16* ea = reinterpret_cast<const bf16*>(&va);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wb[wt_off(h + e, tr)] = eb[e];
      wa[wt_off(h + e, tr)] = ea[e];
    }
  }
}

// A lane's p1 values of a pair: rows g and g + 8 of the 16 at m0, the 4
// adjacent columns 4 q.. of the pair at h0 (zeros past M).
__device__ __forceinline__ void load_p(uint2* p, const bf16* p1, int M,
                                       int H4, int m0, int h0, int g8,
                                       int q) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + g8 + 8 * i;
    const bool ok = m < M;
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
        p1 + (size_t)(ok ? m : 0) * H4 + h0 + 4 * q));
    p[i] = ok ? v : make_uint2(0u, 0u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// x where the lane's entries of a fragment register are of task half sel
// (`up`: they are of half 1), else 0: a select on a predicate, so that no
// mask waits in a register.
__device__ __forceinline__ uint32_t of_half(uint32_t x, bool up, int sel) {
  return up == (sel == 1) ? x : 0u;
}

// Element i of the sum of `chunks` fp32 partial arrays of E elements, in
// chunk order.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ part,
                                           int chunks, size_t E, size_t i) {
  float v = 0.f;
  for (int c = 0; c < chunks; ++c) v += part[(size_t)c * E + i];
  return v;
}

}  // namespace adk
