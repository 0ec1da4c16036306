// Shared pieces of the task-merge kernels (merge_ln_fwd.cu's task mode,
// task_merge_bwd.cu), which form one task's stream
//   y = ((base + c1 pre) + c2 p2) + sum_s midc[token, s] Bs[s, c]   (fp32)
// of a merged row's source token on the fly, in the 2x2 gather order of
// kernel 3, so that the [T, B, L, C] streams never exist: the rank values
// a token, 16-byte loads and the rank term's sum in fp32.
#pragma once

#include "ln_common.cuh"

namespace tmk {

using lnk::bf16;

constexpr int S = 8;     // r1 + r2 rank values per token

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s += u.x * v.x;
    s += u.y * v.y;
  }
  return s;
}

}  // namespace tmk
