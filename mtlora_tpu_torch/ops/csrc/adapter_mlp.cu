// Fused MTLoRA adapter MLP tail (forward) for Hopper:
//   per task t, row m:  z = p1[m] + s_t sum_r mid1[t,r,m] B1[t,r]   fp32
//                       h = bf16(gelu(z))                            exact erf
//                       mid2[t,j,m] = bf16(sum_h h A2T[t,j,h])       fp32 sum
//
// Replaces mtlora_tpu/ops/pallas_adapter_mlp.py: _fwd_kernel, launched by
// _run_fwd through fused_adapter_mid (fc2's task projection in the four
// stage-tail blocks, where fc1's task output stays factored).
//
// What bounds it: the rank is 4, so tensor cores buy little; per hidden
// element and task the work is a rank-4 expansion (4 FMA), the GELU
// (exact erf, tens of fp32 operations) and a rank-4 contraction (4 FMA).
// At stage 0 that is T*M*H4 = 617 M GELUs against 308 MB of p1, so the
// CUDA cores' fp32 rate bounds it, not the bytes. The TPU kernel's win,
// kept here: the [T, M, 4C] task hidden never reaches device memory, and
// p1 is read once for all tasks. Design: a warp carries 4 rows; its lanes
// split the hidden columns in pairs (bf16x2 loads of p1 and of the
// weights, which are read once per pair and task for the 4 rows); each
// lane keeps its 4 x T x 4 partial sums of mid2 in registers and the warp
// reduces them with shuffles once per row group. mid1 and the results go
// through shared memory so that their [T, R, M] rows are read and written
// in runs of 16 tokens.

#include "adapter_mlp.cuh"

namespace {

using namespace adk;

template <int T>
__global__ void __launch_bounds__(128) adapter_mid_fwd_kernel(Args a) {
  __shared__ float mids[kMaxT * R * kBlockRows];
  __shared__ float outs[kMaxT * R * kBlockRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBlockRows, M = a.M, H4 = a.H4;
  stage_rank_rows(mids, a.mid1, T, M, m0, kBlockRows);
  __syncthreads();

  const int rl0 = warp * kRPW;
  float acc[kRPW][T][R];
#pragma unroll
  for (int i = 0; i < kRPW; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][t][j] = 0.f;

  for (int h = 2 * lane; h < H4; h += 64) {
    float2 p[kRPW];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int m = m0 + rl0 + i;
      p[i] = m < M ? bf2(a.p1 + (size_t)m * H4 + h) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float2 b[R], w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        b[r] = bf2(a.b1 + (size_t)(t * R + r) * H4 + h);
        w[r] = bf2(a.a2 + (size_t)(t * R + r) * H4 + h);
      }
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const float2 z = expand(p[i], mids + t * R * kBlockRows + rl0 + i,
                                kBlockRows, b, a.s[t]);
        const float hx = round_bf16(lnk::gelu_exact(z.x));
        const float hy = round_bf16(lnk::gelu_exact(z.y));
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][t][j] += hx * w[j].x + hy * w[j].y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRPW; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float v = warp_sum(acc[i][t][j]);
        if (lane == 0) outs[(t * R + j) * kBlockRows + rl0 + i] = v;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < T * R * kBlockRows; i += blockDim.x) {
    const int tr = i / kBlockRows, m = m0 + i - tr * kBlockRows;
    if (m < M) a.out[(size_t)tr * M + m] = __float2bfloat16(outs[i]);
  }
}

}  // namespace

// mid1T [T, 4, M], p1 [M, H4], b1 and a2T [T, 4, H4] (bf16) -> mid2T
// [T, 4, M]; s0..s3: the per-task scales (T <= 4, H4 % 64 == 0).
extern "C" int mtlora_adapter_mid_fwd(const void* mid1, const void* p1,
                                      const void* b1, const void* a2,
                                      void* out, int T, int M, int H4,
                                      float s0, float s1, float s2, float s3,
                                      void* stream) {
  if (T < 1 || T > kMaxT || M < 1 || H4 < 64 || H4 % 64)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.mid1 = static_cast<const bf16*>(mid1);
  a.p1 = static_cast<const bf16*>(p1);
  a.b1 = static_cast<const bf16*>(b1);
  a.a2 = static_cast<const bf16*>(a2);
  a.out = static_cast<bf16*>(out);
  a.T = T;
  a.M = M;
  a.H4 = H4;
  a.s[0] = s0;
  a.s[1] = s1;
  a.s[2] = s2;
  a.s[3] = s3;
  void (*kern)(Args) = T == 1   ? adapter_mid_fwd_kernel<1>
                       : T == 2 ? adapter_mid_fwd_kernel<2>
                       : T == 3 ? adapter_mid_fwd_kernel<3>
                                : adapter_mid_fwd_kernel<4>;
  kern<<<(M + kBlockRows - 1) / kBlockRows, 128, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
