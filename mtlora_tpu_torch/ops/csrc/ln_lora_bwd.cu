// Fused LayerNorm + frozen GEMM + shared LoRA (backward) for Hopper, and
// the fused patch merge's backward on the same template.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _bwd_kernel (launched by
// _bwd_rule, the custom VJP of fused_ln_lora_linear, y-only mode) and
// _merge_bwd_kernel (launched by _merge_bwd_rule with train_w). With the
// forward's LN, mask and m recomputed per row:
//   dln  = bf16(gy) W                    du = bf16(s gy)
//   dm   = bf16(du B)                    dln += drop(dm A^T)
//   dB^T = du^T m    dA^T = dm^T bf16(drop(ln))    (kernel 2)
//   dW^T = bf16(gy)^T bf16(ln)                       (kernel 3)
// Kernel 2's stage-tail mode (GELU on y, the outputs p and drop1(y)) has
// its own backward, ln_lora_tail_bwd.cu.
//   dgamma = sum dln xhat, dbeta = sum dln,
//   dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dln g
// with the cast points of the JAX kernels and fp32 accumulation.
//
// What bounds it: the dln product (2*O*K FLOP a row) and, at the first
// stage, the bytes of gy and x; the design keeps ln, the mask and the
// rank-r intermediates off device memory except two bf16 [M, r] rows (m,
// dm) for the weight products. The TPU grid runs in order and carries
// dgamma, dbeta, dA, dB, dW in VMEM from step to step; blocks on the H100
// run in parallel, so:
//   - a row kernel (a block of 4 warps owns 16 rows: the warps split the
//     rows' statistics, the LN tile and m, dm, then take the 64-column
//     chunks of dln round robin) computes dx and writes per 16-row tile
//     the fp32 column sums of dgamma and dbeta, plus the bf16 rows the
//     weight products read: bf16(drop(ln)) (or bf16(ln)), m and dm; dln
//     goes through a per-call fp32 scratch [M, K] that the same thread
//     writes and reads back (L2-resident in practice) between the two
//     passes of the LayerNorm backward;
//   - the weight gradients are products over rows (lnk::wgrad): one block
//     per 64 x 64 output tile and stripe of rows writes fp32 partials, and
//     a second kernel sums the stripes in a fixed order; for kernel 3's
//     dW (4.7 MB at the last merge) the stripes are few, so the partials
//     stay within 64 MB;
//   - the 16-row partials of dgamma and dbeta are summed the same way.
// Deterministic, with no fp32 atomics. mma.sync m16n8k16 throughout.

#include "ln_common.cuh"

namespace {

using namespace lnk;

struct BwdArgs {
  Rows R;
  const bf16 *gamma, *beta, *w_ko, *at, *a_kr, *b_ro, *gy;
  bf16 *dx, *lbuf, *mbuf, *dmbuf;
  float *mu_g, *inv_g, *work, *gb;
  int O, r;
  float scale;
  DropSpec drop;
};

// Shared memory of a block: LN tile [16][K + 8], m / dm tile [16][72]
// (bf16), per-warp row sums [2][4][16], mu and inv [16] (fp32).
inline size_t block_bytes(int K) {
  return sizeof(bf16) * kRows * ((size_t)(K + 8) + kT) +
         (2 * 4 + 2) * kRows * sizeof(float);
}

template <bool LORA>
__global__ void __launch_bounds__(128) ln_lora_bwd_rows(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.R.K, M = a.R.M, O = a.O, ld = K + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int valid = min(kRows, M - m0);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* ms = tile + kRows * ld;
  float* red = reinterpret_cast<float*>(ms + kRows * kT);   // [2][4][16]
  float* mu = red + 2 * 4 * kRows;
  float* inv = mu + kRows;
  const bf16* gy = a.gy + (size_t)m0 * O;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  if (threadIdx.x < valid) {
    a.mu_g[m0 + threadIdx.x] = mu[threadIdx.x];
    a.inv_g[m0 + threadIdx.x] = inv[threadIdx.x];
  }
  // bf16(drop(ln)) (adapter) or bf16(ln) (merge): the weight products'
  // row operand, written out once
  const Drop d = LORA ? make_drop(a.drop) : no_drop();
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, d, warp, warps);
  __syncthreads();
  block_tile_to_global(a.lbuf, tile, ld, m0, M, K);
  if (LORA) {
    // m = bf16(tile A^T) and dm = bf16(bf16(s gy) B), 16 columns per warp
    float acc[2][4];
    zero<2>(acc);
    mma_tile<2>(acc, tile, ld, a.at, K, K, 16 * warp, a.r);
    store_tile<2>(ms, kT, acc, 16 * warp);
    __syncthreads();
    block_tile_to_global(a.mbuf, ms, kT, m0, M, a.r);
    __syncthreads();
    zero<2>(acc);
    mma_rows<2, true>(acc, gy, O, valid, a.scale, a.b_ro, O, O, 16 * warp,
                      a.r);
    store_tile<2>(ms, kT, acc, 16 * warp);
    __syncthreads();
    block_tile_to_global(a.dmbuf, ms, kT, m0, M, a.r);
  }

  // ---- pass 1: dln by 64-column chunks, round robin over the warps;
  // dxhat to the scratch, row sums of dxhat and dxhat * xhat, column sums
  // of dgamma and dbeta ------------------------------------------------
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  float* gb = a.gb + (size_t)blockIdx.x * 2 * K;
  for (int k0 = 64 * warp; k0 < K; k0 += 64 * warps) {
    float acc[8][4];
    zero<8>(acc);
    mma_rows<8, false, LORA ? 2 : 1>(acc, gy, O, valid, 1.f, a.w_ko, O, O,
                                     k0, K);
    if (LORA) {
      float d2[8][4];
      zero<8>(d2);
      mma_tile<8>(d2, ms, kT, a.a_kr, a.r, a.r, k0, K);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] += d.apply(d2[nt][e], m0 + g + 8 * (e >> 1), K,
                                k0 + nt * 8 + 2 * t + (e & 1));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (k0 + nt * 8 >= K) continue;
      const int c = k0 + nt * 8 + 2 * t;
      const float2 gm = bf2(a.gamma + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const float2 v = a.R.pair(m, c);
        const float xh0 = (v.x - mu[g + 8 * half]) * inv[g + 8 * half];
        const float xh1 = (v.y - mu[g + 8 * half]) * inv[g + 8 * half];
        const float d0 = acc[nt][2 * half], d1 = acc[nt][2 * half + 1];
        const float dh0 = d0 * gm.x, dh1 = d1 * gm.y;
        s1[half] += dh0 + dh1;
        s2[half] += dh0 * xh0 + dh1 * xh1;
        cg[0] += d0 * xh0;
        cg[1] += d1 * xh1;
        cb[0] += d0;
        cb[1] += d1;
        *reinterpret_cast<float2*>(a.work + (size_t)m * K + c) =
            make_float2(dh0, dh1);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cg[e] += __shfl_xor_sync(0xffffffffu, cg[e], o);
          cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
        }
      if (g == 0) {
        *reinterpret_cast<float2*>(gb + c) = make_float2(cg[0], cg[1]);
        *reinterpret_cast<float2*>(gb + K + c) = make_float2(cb[0], cb[1]);
      }
    }
  }
  // the rows' sums over the warps, in order
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
    if (t == 0) {
      red[warp * kRows + g + 8 * half] = s1[half];
      red[(4 + warp) * kRows + g + 8 * half] = s2[half];
    }
  }
  __syncthreads();
  float m1[2], m2[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float u = 0.f, v = 0.f;
    for (int w = 0; w < warps; ++w) {
      u += red[w * kRows + g + 8 * half];
      v += red[(4 + w) * kRows + g + 8 * half];
    }
    m1[half] = u / K;
    m2[half] = v / K;
  }

  // ---- pass 2: dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) --
  for (int k0 = 64 * warp; k0 < K; k0 += 64 * warps) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (k0 + nt * 8 >= K) continue;
      const int c = k0 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const float mn = mu[g + 8 * half], iv = inv[g + 8 * half];
        const float2 v = a.R.pair(m, c);
        const float2 dh =
            *reinterpret_cast<const float2*>(a.work + (size_t)m * K + c);
        const float xh0 = (v.x - mn) * iv, xh1 = (v.y - mn) * iv;
        st_bf2(a.dx + a.R.offset(m, c), iv * (dh.x - m1[half] - xh0 * m2[half]),
               iv * (dh.y - m1[half] - xh1 * m2[half]));
      }
    }
  }
}

}  // namespace

// Kernel 2 backward (r > 0) or kernel 3 backward (r == 0, merge_wh > 0,
// dW^T into dwt). Layouts: w_ko = W [K, O], at = A^T [r, K],
// a_kr = A [K, r], b_ro = B [r, O]. Scratch: stats [2, M], work [M, K]
// fp32, lbuf [M, K] and mbuf [2, M, r] bf16, gb [ceil(M/16), 2, K], partials pa
// [sa, r, K], pb [sb, O, r], pw [sw, O, K]. Outputs: dx, dgb [2, K],
// dat [r, K], dbt [O, r], dwt [O, K] (fp32).
extern "C" int mtlora_ln_lora_bwd(
    const void* x, const void* gamma, const void* beta, const void* w_ko,
    const void* at, const void* a_kr, const void* b_ro, const void* seed,
    const void* gy, void* dx, void* stats, void* work, void* lbuf,
    void* mbuf, void* gb,
    void* pa, void* pb, void* pw, void* dgb, void* dat, void* dbt, void* dwt,
    int M, int K, int O, int r, int merge_wh, int sa, int sb, int sw,
    float scale, unsigned thr, int use_drop, float inv_keep, void* stream) {
  if (M < 1 || K % 16 || O % 16 || r < 0 || r % 16 || r > 64 ||
      (merge_wh && K % 8) || (!r && !merge_wh))
    return (int)cudaErrorInvalidValue;
  const bool lora = r > 0;
  BwdArgs a;
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = K;
  a.R.Cin = merge_wh ? K / 4 : K;
  a.R.Wh = merge_wh;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.w_ko = static_cast<const bf16*>(w_ko);
  a.at = static_cast<const bf16*>(at);
  a.a_kr = static_cast<const bf16*>(a_kr);
  a.b_ro = static_cast<const bf16*>(b_ro);
  a.gy = static_cast<const bf16*>(gy);
  a.dx = static_cast<bf16*>(dx);
  a.lbuf = static_cast<bf16*>(lbuf);
  a.mbuf = static_cast<bf16*>(mbuf);
  a.dmbuf = lora ? a.mbuf + (size_t)M * r : nullptr;
  a.mu_g = static_cast<float*>(stats);
  a.inv_g = a.mu_g + M;
  a.work = static_cast<float*>(work);
  a.gb = static_cast<float*>(gb);
  a.O = O;
  a.r = r;
  a.scale = scale;
  a.drop.seed = static_cast<const int*>(seed);
  a.drop.stream = 0;
  a.drop.on = lora && use_drop;
  a.drop.thr = thr;
  a.drop.inv_keep = inv_keep;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = block_bytes(K);
  const int tiles = (M + kRows - 1) / kRows;
  auto kern = lora ? ln_lora_bwd_rows<true> : ln_lora_bwd_rows<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<tiles, 128, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  MatSrc ln{a.lbuf, K, 1.f, 0};
  if (lora) {
    // dA^T [r, K] = dm^T bf16(drop(ln)); dB^T [O, r] = bf16(s gy)^T m
    MatSrc dm{a.dmbuf, r, 1.f, 0}, m{a.mbuf, r, 1.f, 0};
    MatSrc dus{a.gy, O, scale, 1};
    e = wgrad(dm, ln, M, r, K, sa, static_cast<float*>(pa),
              static_cast<float*>(dat), st);
    if (e != cudaSuccess) return (int)e;
    e = wgrad(dus, m, M, O, r, sb, static_cast<float*>(pb),
              static_cast<float*>(dbt), st);
  } else {
    // dW^T [O, K] = bf16(gy)^T bf16(ln)
    MatSrc gp{a.gy, O, 1.f, 0};
    e = wgrad(gp, ln, M, O, K, sw, static_cast<float*>(pw),
              static_cast<float*>(dwt), st);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, tiles, 2 * (size_t)K,
                        static_cast<float*>(dgb), st);
}
