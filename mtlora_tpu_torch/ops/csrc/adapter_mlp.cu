// The first port of the fused MTLoRA adapter MLP tail (forward), kept for
// the probes of tools/adapter_variants.py (make_fwd :56 and make_fwd_vpu
// :80, launched by make_fwd_fn :191 and make_fwd_fn_vpu :117), at T = 4:
//   per task t, row m:  z = p1[m] + s_t sum_r mid1[t,r,m] B1[t,r]   fp32
//                       h = act(z), rounded to bf16                  fp32
//                       mid2[t,j,m] = bf16(sum_h h A2T[t,j,h])       fp32 sum
// Kernel 5 itself (mtlora_tpu/ops/pallas_adapter_mlp.py: _fwd_kernel) is
// adapter_mlp_fwd.cu, its rank products on tensor cores; this body keeps
// them on the CUDA cores, as the probes were first measured.
//
// Design: a warp carries 4 rows; its lanes split the hidden columns in
// pairs (bf16x2 loads of p1 and of the weights, which are read once per
// pair and task for the 4 rows); each lane keeps its 4 x T x 4 partial
// sums of mid2 in registers and the warp reduces them with shuffles once
// per row group. mid1 and the results go through shared memory so that
// their [T, R, M] rows are read and written in runs of 16 tokens.
//
// The template's variants: the form of the activation (Erf, Tanh, Sig,
// None) and V:
//   kMain   the forward function;
//   kNoDot1 z = s_t p1, no rank expansion (make_fwd(dot1=False));
//   kVpu1   mid1 and the result in the [T, M, R] layout, z summed as
//           make_fwd_vpu sums it, h rounded to bf16 before the projection;
//   kVpu12  the same with the projection from the fp32 h, never rounded.

#include "adapter_mlp.cuh"

namespace {

using namespace adk;

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

enum Variant { kMain, kNoDot1, kVpu1, kVpu12 };

template <int T, Act A, int V>
__global__ void __launch_bounds__(128) adapter_mid_fwd_kernel(Args a) {
  constexpr bool kTMR = V == kVpu1 || V == kVpu12;
  __shared__ float mids[kMaxT * R * kBlockRows];
  __shared__ float outs[kMaxT * R * kBlockRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBlockRows, M = a.M, H4 = a.H4;
  if (V != kNoDot1)
    stage_rank_rows<kTMR>(mids, a.mid1, T, M, m0, kBlockRows);
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
        const float* mid = mids + t * R * kBlockRows + rl0 + i;
        float2 z;
        if constexpr (V == kNoDot1)
          z = make_float2(p[i].x * a.s[t], p[i].y * a.s[t]);
        else if constexpr (kTMR)
          z = expand_seq(p[i], mid, kBlockRows, b, a.s[t]);
        else
          z = expand(p[i], mid, kBlockRows, b, a.s[t]);
        float hx = act_fwd<A>(z.x), hy = act_fwd<A>(z.y);
        if constexpr (V != kVpu12) {
          hx = round_bf16(hx);
          hy = round_bf16(hy);
        }
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[i][t][j] += hx * w[j].x + hy * w[j].y;
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
    if (m >= M) continue;
    const size_t at = kTMR ? ((size_t)(tr / R) * M + m) * R + tr % R
                           : (size_t)tr * M + m;
    a.out[at] = __float2bfloat16(outs[i]);
  }
}

Args make_args(const void* mid1, const void* p1, const void* b1,
               const void* a2, void* out, int T, int M, int H4, float s0,
               float s1, float s2, float s3) {
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
  return a;
}

// The probes' ids, which adapter_mlp.py's FWD_PROBES name; all run at
// T = 4.
enum FwdId {
  kFwdBase = 0,      // Erf
  kFwdTanh = 1,      // kernel 5's form
  kFwdSig = 2,
  kFwdNoAct = 3,
  kFwdNoDot1 = 4,    // Erf, no rank expansion
  kFwdVpu1Sig = 5,
  kFwdVpu12Sig = 6,
  kFwdVpu1NoAct = 7,
};

}  // namespace

// Probe ``id`` (FwdId): mid1T [4, 4, M] ([4, M, 4] for the vpu
// variants), p1 [M, H4], b1 and a2T [4, 4, H4] (bf16) -> mid2T [4, 4, M]
// ([4, M, 4] for the vpu variants); s0..s3: the per-task scales.
// H4 % 64 == 0.
extern "C" int mtlora_adapter_mid_fwd(int id, const void* mid1,
                                      const void* p1, const void* b1,
                                      const void* a2, void* out, int T, int M,
                                      int H4, float s0, float s1, float s2,
                                      float s3, void* stream) {
  constexpr int K = kMaxT;
  if (T != kMaxT || M < 1 || H4 < 64 || H4 % 64)
    return (int)cudaErrorInvalidValue;
  void (*kern)(Args) = nullptr;
  switch (id) {
    case kFwdBase: kern = adapter_mid_fwd_kernel<K, Act::Erf, kMain>; break;
    case kFwdTanh: kern = adapter_mid_fwd_kernel<K, Act::Tanh, kMain>; break;
    case kFwdSig: kern = adapter_mid_fwd_kernel<K, Act::Sig, kMain>; break;
    case kFwdNoAct: kern = adapter_mid_fwd_kernel<K, Act::None, kMain>; break;
    case kFwdNoDot1: kern = adapter_mid_fwd_kernel<K, Act::Erf, kNoDot1>; break;
    case kFwdVpu1Sig: kern = adapter_mid_fwd_kernel<K, Act::Sig, kVpu1>; break;
    case kFwdVpu12Sig: kern = adapter_mid_fwd_kernel<K, Act::Sig, kVpu12>; break;
    case kFwdVpu1NoAct: kern = adapter_mid_fwd_kernel<K, Act::None, kVpu1>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const Args a = make_args(mid1, p1, b1, a2, out, T, M, H4, s0, s1, s2, s3);
  kern<<<(M + kBlockRows - 1) / kBlockRows, 128, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
