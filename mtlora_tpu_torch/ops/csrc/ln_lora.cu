// Fused patch merge (kernel 3, forward) for Hopper: the rows of a
// [.., H, W, C] stream gathered 2x2 (concat order k = di + 2 dj), then
//   ln  = LN(x)                        fp32 statistics, var = E[x^2] - mu^2
//   y   = bf16(bf16(ln) W^T)           fp32 accumulate, rounded once
// with no bias and no adapter. (Kernel 2 is ln_lora_tail_fwd.cu, in its
// qkv and stage-tail modes; kernel 3's backward is merge_ln_bwd.cu.)
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _merge_fwd_kernel (launched
// by _merge_run_fwd through fused_merge_ln_linear).
//
// What bounds it: a merged row of K = 4C inputs makes O = 2C outputs,
// 2 K O FLOP for 2 (K + O) bytes: 256-1024 FLOP per byte at the
// flagship's merges, near or above the card's ~295 ridge, so the kernel
// wants to be bound by the tensor cores. The TPU kernel's win, kept here,
// is that the gathered and normalised rows never reach device memory.
// Design: a block of 4 warps owns 16 merged rows; the warps split the
// rows' statistics and the bf16(ln) tile in shared memory, then take the
// 64-column output chunks round robin, accumulating with mma.sync
// m16n8k16 and writing y. W is read in its nn.Linear layout ([O, K]: k
// contiguous, the mma B layout) straight from device memory through
// L1/L2. No TMA, wgmma or pipelining yet.

#include "ln_common.cuh"

namespace {

using namespace lnk;

// The widest merged row: its bf16(ln) tile [16][K + 8] and mu, inv [16]
// in the 232,448 bytes of shared memory a block can take.
constexpr int kMaxK = 7248;

struct MergeArgs {
  Rows R;
  const bf16 *gamma, *beta, *wt;
  bf16* y;
  int O;
};

// Shared memory of a block: the bf16(ln) tile [16][K + 8] (bf16), mu and
// inv [16] (fp32).
inline size_t block_bytes(int K) {
  return sizeof(bf16) * kRows * (size_t)(K + 8) + 2 * kRows * sizeof(float);
}
static_assert(sizeof(bf16) * kRows * (kMaxK + 8) + 2 * kRows * 4 <= 232448,
              "kMaxK's tile fits a block's shared memory");

__global__ void __launch_bounds__(128)
    patch_merge_fwd_kernel(MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.R.K, M = a.R.M, ld = K + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* mu = reinterpret_cast<float*>(tile + kRows * ld);
  float* inv = mu + kRows;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, no_drop(), warp,
               warps);
  __syncthreads();

  // 64-column output chunks, round robin over the warps
  for (int n0 = 64 * warp; n0 < a.O; n0 += 64 * warps) {
    float acc[8][4];
    zero<8>(acc);
    mma_tile<8>(acc, tile, ld, a.wt, K, K, n0, a.O);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = n0 + nt * 8 + 2 * t;
      if (n0 + nt * 8 >= a.O) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        st_bf2(a.y + (size_t)m * a.O + c, acc[nt][2 * half],
               acc[nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// x: the [L, H, W, K/4] stream with W = 2 merge_wh, M = L H W / 4 merged
// rows; y [M, O]. K % 16 == 0 up to kMaxK, O % 8 == 0, merge_wh >= 1.
extern "C" int mtlora_ln_lora_fwd(const void* x, const void* gamma,
                                  const void* beta, const void* wt, void* y,
                                  int M, int K, int O, int merge_wh,
                                  void* stream) {
  if (M < 1 || K % 16 || K > kMaxK || O < 8 || O % 8 || merge_wh < 1 ||
      M % merge_wh)
    return (int)cudaErrorInvalidValue;
  MergeArgs a = {};
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = K;
  a.R.Cin = K / 4;
  a.R.Wh = merge_wh;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.wt = static_cast<const bf16*>(wt);
  a.y = static_cast<bf16*>(y);
  a.O = O;
  const size_t smem = block_bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      patch_merge_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  patch_merge_fwd_kernel<<<(M + kRows - 1) / kRows, 128, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
