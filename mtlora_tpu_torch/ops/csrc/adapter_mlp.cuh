// Shared pieces of the adapter MLP-tail kernels: the rank, the task count
// and the activations (adapter_mlp.cu, adapter_mlp_bwd.cu), and the
// forward's arguments, staging of rank rows and per-task expansion z = p1 +
// s_t mid1_t^T B1_t for two hidden columns (adapter_mlp.cu).
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
constexpr int kRPW = 4;        // rows a warp carries at once
constexpr int kBlockRows = 4 * kRPW;

struct Args {
  const bf16 *mid1, *p1, *b1, *a2;   // [T,R,M], [M,H4], [T,R,H4] x2
  bf16* out;                          // mid2T [T,R,M]
  int T, M, H4;
  float s[kMaxT];
};

// vals[tr][i] = float(mid[t][r][m0 + i]) for tr = t * R + r < T * R, i <
// rows (zero past M), by all threads of the block; src is [T, R, M], or
// [T, M, R] with TMR (the probes' make_fwd_vpu layout).
template <bool TMR = false>
__device__ __forceinline__ void stage_rank_rows(float* vals, const bf16* src,
                                                int T, int M, int m0,
                                                int rows) {
  for (int i = threadIdx.x; i < T * R * rows; i += blockDim.x) {
    const int tr = i / rows, rr = i - tr * rows, m = m0 + rr;
    const size_t at = TMR ? ((size_t)(tr / R) * M + m) * R + tr % R
                          : (size_t)tr * M + m;
    vals[i] = m < M ? __bfloat162float(src[at]) : 0.f;
  }
}

// The two columns h, h + 1 of z for task t: z = p + s (sum_r mid[r] B1[r]).
__device__ __forceinline__ float2 expand(float2 p, const float* mid,
                                         int stride, const float2* b,
                                         float s) {
  float ux = 0.f, uy = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mv = mid[r * stride];
    ux += mv * b[r].x;
    uy += mv * b[r].y;
  }
  return make_float2(p.x + s * ux, p.y + s * uy);
}

// The same as make_fwd_vpu sums it: z = p, then z += (s mid[r]) B1[r] in
// r order, each product and sum rounded on its own.
__device__ __forceinline__ float2 expand_seq(float2 p, const float* mid,
                                             int stride, const float2* b,
                                             float s) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sm = __fmul_rn(s, mid[r * stride]);
    p.x = __fadd_rn(p.x, __fmul_rn(sm, b[r].x));
    p.y = __fadd_rn(p.y, __fmul_rn(sm, b[r].y));
  }
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace adk
