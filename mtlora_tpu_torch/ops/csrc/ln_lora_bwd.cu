// The fused patch merge's backward (kernel 3b) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _merge_bwd_kernel (launched
// by _merge_bwd_rule with train_w). With the forward's 2x2 gather and LN
// recomputed per row:
//   gp   = bf16(gy)                      dln = gp W
//   dW^T = gp^T bf16(ln)
//   dgamma = sum dln xhat, dbeta = sum dln,
//   dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dln g
// with the cast points of the JAX kernel and fp32 accumulation. (Kernel
// 2b, the LN+LoRA backward, is ln_lora_qkv_bwd.cu and ln_lora_tail_bwd.cu.)
//
// What bounds it: the dln product (2*O*K FLOP a row) and the bytes of gy
// and x; the design keeps ln off device memory except the bf16 rows the
// weight product reads. The TPU grid runs in order and carries dgamma,
// dbeta and dW in VMEM from step to step; blocks on the H100 run in
// parallel, so:
//   - a row kernel (a block of 4 warps owns 16 rows: the warps split the
//     rows' statistics and the LN tile, then take the 64-column chunks of
//     dln round robin) computes dx and writes per 16-row tile the fp32
//     column sums of dgamma and dbeta, plus bf16(ln), the rows the weight
//     product reads; dln goes through a per-call fp32 scratch [M, K] that
//     the same thread writes and reads back (L2-resident in practice)
//     between the two passes of the LayerNorm backward;
//   - the weight gradient is a product over rows (lnk::wgrad): one block
//     per 64 x 64 output tile and stripe of rows writes fp32 partials, and
//     a second kernel sums the stripes in a fixed order; dW (4.7 MB at the
//     last merge) has few stripes, so the partials stay within 64 MB;
//   - the 16-row partials of dgamma and dbeta are summed the same way.
// Deterministic, with no fp32 atomics. mma.sync m16n8k16 throughout.

#include "ln_common.cuh"

namespace {

using namespace lnk;

struct BwdArgs {
  Rows R;
  const bf16 *gamma, *beta, *w_ko, *gy;
  bf16 *dx, *lbuf;
  float *mu_g, *inv_g, *work, *gb;
  int O;
};

// Shared memory of a block: LN tile [16][K + 8] (bf16), per-warp row sums
// [2][4][16], mu and inv [16] (fp32).
inline size_t block_bytes(int K) {
  return sizeof(bf16) * kRows * (size_t)(K + 8) +
         (2 * 4 + 2) * kRows * sizeof(float);
}

__global__ void __launch_bounds__(128) merge_ln_bwd_rows(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.R.K, M = a.R.M, O = a.O, ld = K + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int valid = min(kRows, M - m0);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(tile + kRows * ld);  // [2][4][16]
  float* mu = red + 2 * 4 * kRows;
  float* inv = mu + kRows;
  const bf16* gy = a.gy + (size_t)m0 * O;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  if (threadIdx.x < valid) {
    a.mu_g[m0 + threadIdx.x] = mu[threadIdx.x];
    a.inv_g[m0 + threadIdx.x] = inv[threadIdx.x];
  }
  // bf16(ln): the weight product's row operand, written out once
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, no_drop(), warp,
               warps);
  __syncthreads();
  block_tile_to_global(a.lbuf, tile, ld, m0, M, K);

  // ---- pass 1: dln by 64-column chunks, round robin over the warps;
  // dxhat to the scratch, row sums of dxhat and dxhat * xhat, column sums
  // of dgamma and dbeta ------------------------------------------------
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  float* gb = a.gb + (size_t)blockIdx.x * 2 * K;
  for (int k0 = 64 * warp; k0 < K; k0 += 64 * warps) {
    float acc[8][4];
    zero<8>(acc);
    // the k loop unrolled twice: more of W's and gy's fragment loads in
    // flight (rolled, the last merge's rows, one wave of latency-bound
    // blocks, ran 43% slower on the H100)
    mma_rows<8, false, 2>(acc, gy, O, valid, 1.f, a.w_ko, O, O, k0, K);
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

// Kernel 3 backward: x the [.., H, W, C] stream gathered 2x2 (merge_wh =
// W / 2, K = 4C), w_ko = W [K, O]. Scratch: stats [2, M], work [M, K]
// fp32, lbuf [M, K] bf16, gb [ceil(M/16), 2, K], partials pw [sw, O, K].
// Outputs: dx, dgb [2, K], dwt [O, K] (fp32).
extern "C" int mtlora_ln_lora_bwd(
    const void* x, const void* gamma, const void* beta, const void* w_ko,
    const void* gy, void* dx, void* stats, void* work, void* lbuf, void* gb,
    void* pw, void* dgb, void* dwt, int M, int K, int O, int merge_wh,
    int sw, void* stream) {
  if (M < 1 || K % 16 || O % 16 || merge_wh < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = K;
  a.R.Cin = K / 4;
  a.R.Wh = merge_wh;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.w_ko = static_cast<const bf16*>(w_ko);
  a.gy = static_cast<const bf16*>(gy);
  a.dx = static_cast<bf16*>(dx);
  a.lbuf = static_cast<bf16*>(lbuf);
  a.mu_g = static_cast<float*>(stats);
  a.inv_g = a.mu_g + M;
  a.work = static_cast<float*>(work);
  a.gb = static_cast<float*>(gb);
  a.O = O;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = block_bytes(K);
  const int tiles = (M + kRows - 1) / kRows;
  cudaError_t e = cudaFuncSetAttribute(
      merge_ln_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_ln_bwd_rows<<<tiles, 128, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dW^T [O, K] = bf16(gy)^T bf16(ln)
  const MatSrc gp{a.gy, O, 1.f, 0}, ln{a.lbuf, K, 1.f, 0};
  e = wgrad(gp, ln, M, O, K, sw, static_cast<float*>(pw),
            static_cast<float*>(dwt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, tiles, 2 * (size_t)K,
                        static_cast<float*>(dgb), st);
}
