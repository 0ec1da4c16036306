// Shared pieces of the task-merge kernels (task_merge.cu,
// task_merge_bwd.cu): the row source that forms one task's stream
//   y = ((base + c1 pre) + c2 p2) + sum_s midc[token, s] Bs[s, c]   (fp32)
// of a merged row's source token on the fly, in the 2x2 gather order of
// kernel 3 (lnk::Rows), so that the [T, B, L, C] streams never exist.
#pragma once

#include "ln_common.cuh"

namespace tmk {

using lnk::bf16;
using lnk::bf2;

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

// Operands of every task; rows(t) is task t's row source.
struct TmArgs {
  const bf16 *base, *pre, *p2;   // [B*L, C] shared rows
  const bf16 *mid;               // [T, B*L, S] rank rows, coefficients in
  const bf16 *bs_cs;             // [T, C, S] scaled rank matrices
  const float* coef;             // [T, B, 2] fp32 (c1, c2)
  int B, Mm, K, C, Wh, per_sample;   // merged rows Mm = B * per_sample
};

struct TaskRows {
  const bf16 *base, *pre, *p2, *mid, *bs;
  const float* coef;
  int M, K, Cin, Wh, per_sample;
  // element offset of (merged row m, k) in the [B*L, C] source rows,
  // k = (di + 2 dj) C + c (as lnk::Rows::offset)
  __device__ __forceinline__ size_t offset(int m, int k) const {
    const int q = k / Cin, c = k - q * Cin;
    const int rr = m / Wh, j = m - rr * Wh;
    return ((size_t)(2 * rr + (q & 1)) * (2 * Wh) + 2 * j + (q >> 1)) * Cin +
           c;
  }
  __device__ __forceinline__ float2 pair(int m, int k) const {
    const size_t o = offset(m, k);
    const size_t tok = o / Cin;
    const int c = (int)(o - tok * Cin);
    const int b = m / per_sample;
    const float c1 = coef[2 * b], c2 = coef[2 * b + 1];
    const float2 v = bf2(base + o), p = bf2(pre + o), q = bf2(p2 + o);
    const uint4 mv = ld16(mid + tok * S);
    const float u0 = dot8(mv, ld16(bs + (size_t)c * S));
    const float u1 = dot8(mv, ld16(bs + (size_t)(c + 1) * S));
    return make_float2(((v.x + c1 * p.x) + c2 * q.x) + u0,
                       ((v.y + c1 * p.y) + c2 * q.y) + u1);
  }
};

__device__ __forceinline__ TaskRows task_rows(const TmArgs& a, int t) {
  TaskRows R;
  R.base = a.base;
  R.pre = a.pre;
  R.p2 = a.p2;
  R.mid = a.mid + (size_t)t * a.B * a.per_sample * 4 * S;
  R.bs = a.bs_cs + (size_t)t * a.C * S;
  R.coef = a.coef + (size_t)t * a.B * 2;
  R.M = a.Mm;
  R.K = a.K;
  R.Cin = a.C;
  R.Wh = a.Wh;
  R.per_sample = a.per_sample;
  return R;
}

inline TmArgs make_tm_args(const void* base, const void* pre, const void* p2,
                           const void* mid, const void* bs_cs,
                           const void* coef, int B, int H, int W, int C) {
  TmArgs a;
  a.base = static_cast<const bf16*>(base);
  a.pre = static_cast<const bf16*>(pre);
  a.p2 = static_cast<const bf16*>(p2);
  a.mid = static_cast<const bf16*>(mid);
  a.bs_cs = static_cast<const bf16*>(bs_cs);
  a.coef = static_cast<const float*>(coef);
  a.B = B;
  a.per_sample = (H / 2) * (W / 2);
  a.Mm = B * a.per_sample;
  a.K = 4 * C;
  a.C = C;
  a.Wh = W / 2;
  return a;
}

}  // namespace tmk
