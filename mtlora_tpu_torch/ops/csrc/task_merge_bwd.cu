// Fused factored-task patch merge (backward) for Hopper. With each task's
// stream y_t, its LN statistics and xhat recomputed (task_merge.cuh), the
// cast points of _tm_bwd_kernel:
//   dln   = bf16(gy_t) W                  dgamma = sum dln xhat, dbeta = sum dln
//   dy_t  = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dln g
//   dbase = sum_t dy_t, dpre = sum_t c1_t dy_t, dp2 = sum_t c2_t dy_t (fp32)
//   dU_t  = bf16(dy_t)                    dmidc_t = bf16(dU_t Bs_t^T)
//   dBs_t = midc_t^T dU_t  (fp32)         dW^T = sum_t bf16(gy_t)^T bf16(ln_t)
//
// Replaces mtlora_tpu/ops/pallas_task_merge.py: _tm_bwd_kernel, launched by
// _tm_bwd_rule (train_w: the reduction trains) from the custom VJP of
// task_merge_ln_linear.
//
// What bounds it: the bytes of gy, the shared rows and the three shared
// gradients, and the dln product (2*2C*4C FLOP per merged row and task).
// The TPU grid runs in order, sums dbase, dpre, dp2 over the tasks in
// VMEM and carries dBs, dgamma, dbeta, dW from step to step; here:
//   - a row kernel per (16 merged rows, task) recomputes the rows'
//     statistics, writes the bf16 LN rows (for dW), dxhat (fp32 scratch),
//     the rows' mu, inv, mean(dxhat), mean(dxhat xhat) and per-16-row
//     partials of dgamma and dbeta; dln = bf16(gy) W by mma.sync, 64
//     columns per warp at a time (kernel 3b's pass 1, ln_lora_bwd.cu);
//   - a combine kernel, one thread per merged row and column pair, walks
//     the tasks in order, forms dy_t, sums the three shared gradients in
//     registers (one write each) and writes bf16(dy_t) at the source token;
//   - dmidc by mma.sync over the bf16(dy) rows (one n8 tile: the 8 rank
//     values), dBs and dW as products over rows (lnk::wgrad: fp32 partials
//     per stripe of rows, summed in a fixed order), the dgamma and dbeta
//     partials summed the same way. No fp32 atomics.

#include "task_merge.cuh"

namespace {

using namespace lnk;
using tmk::S;
using tmk::TaskRows;
using tmk::TmArgs;

struct BwdBufs {
  const bf16 *gamma, *beta, *w_ko, *gy;
  float *stats, *work, *gb;       // [T][4][Mm], [T][Mm][K], [T*tiles][2][K]
  bf16 *lbuf, *du;                // [T][Mm][K], [T][B*L][C]
  bf16 *dbase, *dpre, *dp2;       // [B*L][C]
  int O, T;
};

__global__ void __launch_bounds__(128) task_merge_bwd_rows(TmArgs a,
                                                           BwdBufs b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, M = a.Mm, O = b.O, ld = K + 8, t = blockIdx.y;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int valid = min(kRows, M - m0);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(tile + kRows * ld);   // [2][4][16]
  float* mu = red + 2 * 4 * kRows;
  float* inv = mu + kRows;
  const TaskRows R = tmk::task_rows(a, t);
  const bf16* gy = b.gy + ((size_t)t * M + m0) * O;
  float* st = b.stats + (size_t)t * 4 * M;
  float* work = b.work + (size_t)t * M * K;

  rows_stats(R, m0, mu, inv, warp, warps);
  __syncthreads();
  if (threadIdx.x < valid) {
    st[m0 + threadIdx.x] = mu[threadIdx.x];
    st[M + m0 + threadIdx.x] = inv[threadIdx.x];
  }
  rows_ln_tile(tile, ld, R, b.gamma, b.beta, m0, mu, inv, no_drop(), warp,
               warps);
  __syncthreads();
  block_tile_to_global(b.lbuf + (size_t)t * M * K, tile, ld, m0, M, K);

  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  float* gb = b.gb + ((size_t)t * gridDim.x + blockIdx.x) * 2 * K;
  for (int k0 = 64 * warp; k0 < K; k0 += 64 * warps) {
    float acc[8][4];
    zero<8>(acc);
    mma_rows<8, false>(acc, gy, O, valid, 1.f, b.w_ko, O, O, k0, K);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (k0 + nt * 8 >= K) continue;
      const int c = k0 + nt * 8 + 2 * tq;
      const float2 gm = bf2(b.gamma + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const float2 v = R.pair(m, c);
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
        *reinterpret_cast<float2*>(work + (size_t)m * K + c) =
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
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
    if (tq == 0) {
      red[warp * kRows + g + 8 * half] = s1[half];
      red[(4 + warp) * kRows + g + 8 * half] = s2[half];
    }
  }
  __syncthreads();
  if (threadIdx.x < valid) {
    const int i = threadIdx.x;
    float u = 0.f, v = 0.f;
    for (int w = 0; w < warps; ++w) {
      u += red[w * kRows + i];
      v += red[(4 + w) * kRows + i];
    }
    st[2 * M + m0 + i] = u / K;
    st[3 * M + m0 + i] = v / K;
  }
}

// One thread per (merged row, column pair): dy_t for every task in order,
// the three shared gradients summed in registers, bf16(dy_t) to dU.
__global__ void __launch_bounds__(256) task_merge_bwd_combine(TmArgs a,
                                                              BwdBufs b) {
  const int K = a.K, M = a.Mm, pairs = K / 2;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * pairs) return;
  const int m = (int)(i / pairs), k = 2 * (int)(i - (size_t)m * pairs);
  const int bs = m / a.per_sample;
  float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  size_t o = 0;
  for (int t = 0; t < b.T; ++t) {
    const TaskRows R = tmk::task_rows(a, t);
    o = R.offset(m, k);
    const float* st = b.stats + (size_t)t * 4 * M;
    const float mu = st[m], iv = st[M + m], m1 = st[2 * M + m],
                m2 = st[3 * M + m];
    const float2 y = R.pair(m, k);
    const float2 dh =
        *reinterpret_cast<const float2*>(b.work + ((size_t)t * M + m) * K + k);
    const float xh0 = (y.x - mu) * iv, xh1 = (y.y - mu) * iv;
    const float dy0 = iv * (dh.x - m1 - xh0 * m2);
    const float dy1 = iv * (dh.y - m1 - xh1 * m2);
    const float c1 = R.coef[2 * bs], c2 = R.coef[2 * bs + 1];
    acc[0][0] += dy0;
    acc[0][1] += dy1;
    acc[1][0] += c1 * dy0;
    acc[1][1] += c1 * dy1;
    acc[2][0] += c2 * dy0;
    acc[2][1] += c2 * dy1;
    st_bf2(b.du + (size_t)t * a.B * a.per_sample * 4 * a.C + o, dy0, dy1);
  }
  st_bf2(b.dbase + o, acc[0][0], acc[0][1]);
  st_bf2(b.dpre + o, acc[1][0], acc[1][1]);
  st_bf2(b.dp2 + o, acc[2][0], acc[2][1]);
}

// dmidc[t][row][s] = bf16(sum_c dU[t][row][c] Bs[t][s][c]): a warp per 16
// source rows, blockIdx.y the task.
__global__ void __launch_bounds__(128)
task_merge_bwd_dmid(const bf16* __restrict__ du, const bf16* __restrict__ bs_sc,
                    bf16* __restrict__ dmid, int rows, int C) {
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            tq = lane & 3, t = blockIdx.y;
  const int r0 = (blockIdx.x * 4 + warp) * kRows;
  if (r0 >= rows) return;
  const int valid = min(kRows, rows - r0);
  float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  mma_rows<1, false>(acc, du + ((size_t)t * rows + r0) * C, C, valid, 1.f,
                     bs_sc + (size_t)t * S * C, C, C, 0, S);
  bf16* out = dmid + ((size_t)t * rows + r0) * S;
  if (g < valid) st_bf2(out + g * S + 2 * tq, acc[0][0], acc[0][1]);
  if (g + 8 < valid) st_bf2(out + (g + 8) * S + 2 * tq, acc[0][2], acc[0][3]);
}

}  // namespace

// Operands as mtlora_task_merge_fwd, plus bs_sc [T, 8, C] (bf16), w_ko =
// W [4C, O] and gy [T, B*H/2*W/2, O]. Scratch: stats [T, 4, Mm], work
// [T, Mm, 4C] fp32, lbuf [T, Mm, 4C] bf16, gb [T*ceil(Mm/16), 2, 4C] fp32,
// du [T, B*H*W, C] and dmid [T, B*H*W, 8] bf16, partials pb [sb, C, 8],
// pw [sw, O, 4C]. Outputs: dbase, dpre, dp2 [B*H*W, C] bf16; dbs [T, C, 8],
// dgb [2, 4C], dwt [O, 4C] fp32; dmid as above.
extern "C" int mtlora_task_merge_bwd(
    const void* base, const void* pre, const void* p2, const void* mid,
    const void* bs_cs, const void* bs_sc, const void* coef,
    const void* gamma, const void* beta, const void* w_ko, const void* gy,
    void* stats, void* work, void* lbuf, void* gb, void* du, void* dmid,
    void* pb, void* pw, void* dbase, void* dpre, void* dp2, void* dbs,
    void* dgb, void* dwt, int T, int B, int H, int W, int C, int O, int sb,
    int sw, void* stream) {
  if (T < 1 || B < 1 || H % 2 || W % 2 || C % 16 || O % 16 || sb < 1 ||
      sw < 1)
    return (int)cudaErrorInvalidValue;
  const TmArgs a = tmk::make_tm_args(base, pre, p2, mid, bs_cs, coef, B, H,
                                     W, C);
  BwdBufs b;
  b.gamma = static_cast<const bf16*>(gamma);
  b.beta = static_cast<const bf16*>(beta);
  b.w_ko = static_cast<const bf16*>(w_ko);
  b.gy = static_cast<const bf16*>(gy);
  b.stats = static_cast<float*>(stats);
  b.work = static_cast<float*>(work);
  b.gb = static_cast<float*>(gb);
  b.lbuf = static_cast<bf16*>(lbuf);
  b.du = static_cast<bf16*>(du);
  b.dbase = static_cast<bf16*>(dbase);
  b.dpre = static_cast<bf16*>(dpre);
  b.dp2 = static_cast<bf16*>(dp2);
  b.O = O;
  b.T = T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = a.K, Mm = a.Mm, rows = B * H * W;
  const int tiles = (Mm + kRows - 1) / kRows;

  const size_t smem = sizeof(bf16) * kRows * (size_t)(K + 8) +
                      (2 * 4 + 2) * kRows * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      task_merge_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  task_merge_bwd_rows<<<dim3(tiles, T), 128, smem, st>>>(a, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t threads = (size_t)Mm * (K / 2);
  task_merge_bwd_combine<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      a, b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  bf16* dm = static_cast<bf16*>(dmid);
  task_merge_bwd_dmid<<<dim3((rows + 63) / 64, T), 128, 0, st>>>(
      b.du, static_cast<const bf16*>(bs_sc), dm, rows, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dBs_t^T [C, 8] = dU_t^T midc_t, one product over the source rows per task
  for (int t = 0; t < T; ++t) {
    MatSrc P{b.du + (size_t)t * rows * C, C, 1.f, 0};
    MatSrc Q{a.mid + (size_t)t * rows * S, S, 1.f, 0};
    e = wgrad(P, Q, rows, C, S, sb, static_cast<float*>(pb),
              static_cast<float*>(dbs) + (size_t)t * C * S, st);
    if (e != cudaSuccess) return (int)e;
  }
  // dW^T [O, 4C] = bf16(gy)^T bf16(ln) over every task's rows
  MatSrc gp{b.gy, O, 1.f, 0}, ln{b.lbuf, K, 1.f, 0};
  e = wgrad(gp, ln, T * Mm, O, K, sw, static_cast<float*>(pw),
            static_cast<float*>(dwt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(b.gb, T * tiles, 2 * (size_t)K,
                        static_cast<float*>(dgb), st);
}
