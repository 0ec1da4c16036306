// Fused MTLoRA adapter MLP tail (backward) for Hopper. With z, h = gelu(z)
// and gelu'(z) recomputed (never stored; the tanh form, lnk::kGelu), the
// cast points of _bwd_kernel:
//   dh  = sum_j g[t,j,m] A2T[t,j]           fp32
//   dz  = bf16(dh gelu'(z))
//   dp1 = bf16(sum_t dz)                    fp32 sum in task order
//   dmid1[t,r,m] = bf16(s_t sum_h B1[t,r,h] dz[h])
//   dB1[t,r,h]   = s_t sum_m mid1[t,r,m] dz[m,h]      fp32
//   dA2T[t,j,h]  = sum_m g[t,j,m] bf16(h)[m,h]        fp32
//
// Replaces mtlora_tpu/ops/pallas_adapter_mlp.py: _bwd_kernel, launched by
// _run_bwd from _bwd_rule, the custom VJP of fused_adapter_mid; with the
// activation form a template parameter, also the backward probe of
// tools/adapter_variants.py (make_bwd :136 through make_bwd_fn :209, with
// erf_pair :173 or sig_pair :178), at T = 4.
//
// What bounds it: as the forward, the fp32 work per hidden element (GELU
// and GELU' from one tanh, the rank-4 expansions and
// contractions) at T*M*H4 elements; dp1 doubles the forward's bytes. The
// TPU grid runs in order and carries dB1 and dA2T from step to step in
// VMEM; blocks here run in parallel, so:
//   - a row kernel (a warp carries 4 rows, its lanes split the hidden
//     columns in pairs, as the forward) writes dp1 and keeps the lanes'
//     partial sums of dmid1 in registers, reduced with shuffles once per
//     row group;
//   - a weight kernel gives each thread one column pair and walks a stripe
//     of rows, holding that pair's B1 and A2T of every task and its dB1 and
//     dA2T sums in registers; it recomputes z and dz (no [T, M, H4] tensor
//     is stored) and writes fp32 partials per stripe, which a second pass
//     sums in a fixed order (lnk::sum_parts). No fp32 atomics.

#include "adapter_mlp.cuh"

namespace {

using namespace adk;

template <int T, Act A>
__global__ void __launch_bounds__(128) adapter_mid_bwd_rows(Args a) {
  __shared__ float mids[kMaxT * R * kBlockRows];
  __shared__ float gs[kMaxT * R * kBlockRows];
  __shared__ float outs[kMaxT * R * kBlockRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBlockRows, M = a.M, H4 = a.H4;
  stage_rank_rows(mids, a.mid1, T, M, m0, kBlockRows);
  stage_rank_rows(gs, a.g, T, M, m0, kBlockRows);
  __syncthreads();

  const int rl0 = warp * kRPW;
  float acc[kRPW][T][R];
#pragma unroll
  for (int i = 0; i < kRPW; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][t][r] = 0.f;

  for (int h = 2 * lane; h < H4; h += 64) {
    float2 p[kRPW], dp[kRPW];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int m = m0 + rl0 + i;
      p[i] = m < M ? bf2(a.p1 + (size_t)m * H4 + h) : make_float2(0.f, 0.f);
      dp[i] = make_float2(0.f, 0.f);
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
        const int rl = rl0 + i;
        const float2 z = expand(p[i], mids + t * R * kBlockRows + rl,
                                kBlockRows, b, a.s[t]);
        float gx, gy, dgx, dgy;
        act_pair<A>(z.x, &gx, &dgx);
        act_pair<A>(z.y, &gy, &dgy);
        float dhx = 0.f, dhy = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float gv = gs[(t * R + j) * kBlockRows + rl];
          dhx += gv * w[j].x;
          dhy += gv * w[j].y;
        }
        const float dzx = round_bf16(dhx * dgx), dzy = round_bf16(dhy * dgy);
        dp[i].x += dzx;
        dp[i].y += dzy;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[i][t][r] += b[r].x * dzx + b[r].y * dzy;
      }
    }
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int m = m0 + rl0 + i;
      if (m < M) lnk::st_bf2(a.dp1 + (size_t)m * H4 + h, dp[i].x, dp[i].y);
    }
  }
#pragma unroll
  for (int i = 0; i < kRPW; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = warp_sum(acc[i][t][r]);
        if (lane == 0) outs[(t * R + r) * kBlockRows + rl0 + i] = a.s[t] * v;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < T * R * kBlockRows; i += blockDim.x) {
    const int tr = i / kBlockRows, m = m0 + i - tr * kBlockRows;
    if (m < M) a.out[(size_t)tr * M + m] = __float2bfloat16(outs[i]);
  }
}

constexpr int kChunk = 32;     // rows staged at once by the weight kernel

// One thread per hidden column pair h (blockIdx.x * 256 + 2 threadIdx.x),
// one stripe of rows per blockIdx.y: part[stripe][0][t][r][h..] = dB1,
// part[stripe][1][t][j][h..] = dA2T over the stripe's rows.
template <int T, Act A>
__global__ void __launch_bounds__(128) adapter_mid_bwd_weights(Args a) {
  __shared__ float mids[kMaxT * R * kChunk];
  __shared__ float gs[kMaxT * R * kChunk];
  const int M = a.M, H4 = a.H4;
  const int h = blockIdx.x * 256 + 2 * threadIdx.x;
  const bool on = h < H4;
  const int r_begin = blockIdx.y * a.stripe_rows;
  const int r_end = min(M, r_begin + a.stripe_rows);
  float2 b[T][R], w[T][R], db[T][R], da[T][R];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t o = (size_t)(t * R + r) * H4 + h;
      b[t][r] = on ? bf2(a.b1 + o) : make_float2(0.f, 0.f);
      w[t][r] = on ? bf2(a.a2 + o) : make_float2(0.f, 0.f);
      db[t][r] = da[t][r] = make_float2(0.f, 0.f);
    }
  for (int c0 = r_begin; c0 < r_end; c0 += kChunk) {
    const int rows = min(kChunk, r_end - c0);
    __syncthreads();
    stage_rank_rows(mids, a.mid1, T, M, c0, kChunk);
    stage_rank_rows(gs, a.g, T, M, c0, kChunk);
    __syncthreads();
    if (!on) continue;
    for (int i = 0; i < rows; ++i) {
      const float2 p = bf2(a.p1 + (size_t)(c0 + i) * H4 + h);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float2 z =
            expand(p, mids + t * R * kChunk + i, kChunk, b[t], a.s[t]);
        float gx, gy, dgx, dgy;
        act_pair<A>(z.x, &gx, &dgx);
        act_pair<A>(z.y, &gy, &dgy);
        gx = round_bf16(gx);
        gy = round_bf16(gy);
        float dhx = 0.f, dhy = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float gv = gs[(t * R + j) * kChunk + i];
          dhx += gv * w[t][j].x;
          dhy += gv * w[t][j].y;
          da[t][j].x += gv * gx;
          da[t][j].y += gv * gy;
        }
        const float dzx = round_bf16(dhx * dgx), dzy = round_bf16(dhy * dgy);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float mv = mids[(t * R + r) * kChunk + i];
          db[t][r].x += mv * dzx;
          db[t][r].y += mv * dzy;
        }
      }
    }
  }
  if (!on) return;
  float* out = a.part + (size_t)blockIdx.y * 2 * T * R * H4;
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t o = (size_t)(t * R + r) * H4 + h;
      *reinterpret_cast<float2*>(out + o) =
          make_float2(a.s[t] * db[t][r].x, a.s[t] * db[t][r].y);
      *reinterpret_cast<float2*>(out + (size_t)T * R * H4 + o) = da[t][r];
    }
}

template <int T, Act A>
cudaError_t run(const Args& a, int stripes, float* dw, cudaStream_t st) {
  adapter_mid_bwd_rows<T, A>
      <<<(a.M + kBlockRows - 1) / kBlockRows, 128, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  adapter_mid_bwd_weights<T, A>
      <<<dim3((a.H4 + 255) / 256, stripes), 128, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return lnk::sum_parts(a.part, stripes, 2 * (size_t)T * R * a.H4, dw, st);
}

Args make_args(const void* mid1, const void* p1, const void* b1,
               const void* a2, const void* g, void* dmid1, void* dp1,
               void* part, int T, int M, int H4, int stripes, float s0,
               float s1, float s2, float s3) {
  Args a = {};
  a.mid1 = static_cast<const bf16*>(mid1);
  a.p1 = static_cast<const bf16*>(p1);
  a.b1 = static_cast<const bf16*>(b1);
  a.a2 = static_cast<const bf16*>(a2);
  a.g = static_cast<const bf16*>(g);
  a.out = static_cast<bf16*>(dmid1);
  a.dp1 = static_cast<bf16*>(dp1);
  a.part = static_cast<float*>(part);
  a.T = T;
  a.M = M;
  a.H4 = H4;
  // stripes past the rows (the ceil) still write zero partials
  const int chunks = (M + kChunk - 1) / kChunk;
  a.stripe_rows = (chunks + stripes - 1) / stripes * kChunk;
  a.s[0] = s0;
  a.s[1] = s1;
  a.s[2] = s2;
  a.s[3] = s3;
  return a;
}

// The activations' ids, which adapter_mlp.py's BWD_PROBES and KERNEL5B_ACT
// name: kBwdTanh is kernel 5b and runs at any T <= 4; the probes at T = 4.
enum BwdId {
  kBwdErf = 0,    // the probe's erf_pair
  kBwdTanh = 1,   // kernel 5b
  kBwdSig = 2,    // sig_pair
};
static_assert(kGelu == Act::Tanh, "kernel 5b is the tanh form");

}  // namespace

// mid1T [T, 4, M], p1 [M, H4], b1, a2T [T, 4, H4], g [T, 4, M] (bf16) ->
// dmid1T [T, 4, M], dp1 [M, H4] (bf16) and dw [2][T][4][H4] (fp32: dB1,
// dA2T); part [stripes][2][T][4][H4] fp32 scratch; act: a BwdId.
extern "C" int mtlora_adapter_mid_bwd(int act, const void* mid1,
                                      const void* p1, const void* b1,
                                      const void* a2, const void* g,
                                      void* dmid1, void* dp1, void* part,
                                      void* dw, int T, int M, int H4,
                                      int stripes, float s0, float s1,
                                      float s2, float s3, void* stream) {
  if ((act != kBwdErf && act != kBwdTanh && act != kBwdSig) || T < 1 ||
      T > kMaxT || (act != kBwdTanh && T != kMaxT) || M < 1 || H4 < 64 ||
      H4 % 64 || stripes < 1)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(mid1, p1, b1, a2, g, dmid1, dp1, part, T, M, H4,
                           stripes, s0, s1, s2, s3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  cudaError_t e = act == kBwdErf ? run<kMaxT, Act::Erf>(a, stripes, out, st)
                  : act == kBwdSig ? run<kMaxT, Act::Sig>(a, stripes, out, st)
                  : T == 1       ? run<1, kGelu>(a, stripes, out, st)
                  : T == 2       ? run<2, kGelu>(a, stripes, out, st)
                  : T == 3       ? run<3, kGelu>(a, stripes, out, st)
                                 : run<4, kGelu>(a, stripes, out, st);
  return (int)e;
}
