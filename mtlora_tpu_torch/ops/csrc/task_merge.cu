// Fused factored-task patch merge (forward) for Hopper: per task t and
// merged row m, the 2x2 gather of the implicit stream y_t (task_merge.cuh),
// LN(4C) with fp32 statistics, and bf16(ln) W^T in fp32, rounded once.
//
// Replaces mtlora_tpu/ops/pallas_task_merge.py: _tm_fwd_kernel, launched by
// _tm_run_fwd through task_merge_ln_linear from task_merge_down (the patch
// merges of the task streams that the stage-tail blocks leave factored).
//
// What bounds it: the bytes. Per task a merged row of 4C values makes 2C
// outputs, 2*4C*2C FLOP; the shared rows (base, pre, p2) are read for
// every task but, at 3 x 2 bytes per source value against T = 4 outputs
// of 2C per merged row, the kernel sits below the card's ridge (stage 0:
// 231 MB of shared rows, 26 MB of rank rows, 154 MB out; 59 GFLOP). The
// TPU kernel's win, kept here: the [T, B, L, C] streams and their LN never
// reach device memory. Its pair-split rank layout and block-diagonal B
// exist to fit the TPU's (8, 128) tiles; here each source value takes its
// token's 8 rank values (one 16-byte load) and its column's 8 scaled B
// values (another) and sums them in fp32. Design: the first port of kernel
// 3's, with this row source: a block of 4 warps owns 16 merged rows of one task
// (blockIdx.y), splits their statistics and the bf16 LN tile in shared
// memory, then takes the 64-column output chunks round robin with
// mma.sync m16n8k16. No gate on W/2 % 8 (the TPU's sublane tiling): every
// merge runs here.

#include "task_merge.cuh"

namespace {

using namespace lnk;
using tmk::TaskRows;
using tmk::TmArgs;

__global__ void __launch_bounds__(128)
task_merge_fwd_kernel(TmArgs a, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta,
                      const bf16* __restrict__ wt, bf16* __restrict__ y,
                      int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, M = a.Mm, ld = K + 8, t = blockIdx.y;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * kRows;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* mu = reinterpret_cast<float*>(tile + kRows * ld);
  float* inv = mu + kRows;
  const TaskRows R = tmk::task_rows(a, t);

  rows_stats(R, m0, mu, inv, warp, warps);
  __syncthreads();
  rows_ln_tile(tile, ld, R, gamma, beta, m0, mu, inv, no_drop(), warp,
               warps);
  __syncthreads();
  bf16* yt = y + (size_t)t * M * O;
  for (int n0 = 64 * warp; n0 < O; n0 += 64 * warps) {
    float acc[8][4];
    zero<8>(acc);
    mma_tile<8>(acc, tile, ld, wt, K, K, n0, O);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (n0 + nt * 8 >= O) continue;
      const int c = n0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m < M)
          st_bf2(yt + (size_t)m * O + c, acc[nt][2 * half],
                 acc[nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// base, pre, p2 [B*H*W, C]; mid [T, B*H*W, 8]; bs_cs [T, C, 8] (bf16);
// coef [T, B, 2] fp32; gamma, beta [4C], wt [O, 4C] -> y [T, B*H/2*W/2, O].
extern "C" int mtlora_task_merge_fwd(const void* base, const void* pre,
                                     const void* p2, const void* mid,
                                     const void* bs_cs, const void* coef,
                                     const void* gamma, const void* beta,
                                     const void* wt, void* y, int T, int B,
                                     int H, int W, int C, int O,
                                     void* stream) {
  if (T < 1 || B < 1 || H % 2 || W % 2 || C % 16 || O % 8)
    return (int)cudaErrorInvalidValue;
  const TmArgs a = tmk::make_tm_args(base, pre, p2, mid, bs_cs, coef, B, H,
                                     W, C);
  const size_t smem =
      sizeof(bf16) * kRows * (size_t)(a.K + 8) + 2 * kRows * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      task_merge_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  task_merge_fwd_kernel<<<dim3((a.Mm + kRows - 1) / kRows, T), 128, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<const bf16*>(wt), static_cast<bf16*>(y), O);
  return (int)cudaGetLastError();
}
