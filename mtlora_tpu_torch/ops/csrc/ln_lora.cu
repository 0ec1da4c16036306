// Fused LayerNorm + frozen GEMM + shared LoRA (forward) for Hopper, and
// the fused patch merge on the same template:
//   ln  = LN(x)                        fp32 statistics, var = E[x^2] - mu^2
//   p   = bf16(ln) W^T + b             fp32 accumulate, bf16 bias
//   m   = bf16(bf16(drop(ln)) A^T)     shared adapter, rank r <= 64
//   y   = bf16(p + s * (m B^T))        rounded once
// Kernel 3 is the same with the rows gathered 2x2 from a [.., H, W, C]
// stream (concat order k = di + 2 dj), no bias and no adapter. (The
// stage-tail mode is ln_lora_tail_fwd.cu.)
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _fwd_kernel (launched by
// _run_fwd through fused_ln_lora_linear) in y-only mode and
// _merge_fwd_kernel (launched by _merge_run_fwd through
// fused_merge_ln_linear).
//
// What bounds it: at the flagship's qkv shapes a row of K = C inputs makes
// 3C outputs, 2*C*3C + 2*r*(C + 3C) FLOP for 2*(C + 3C) bytes: 96-768
// FLOP per byte, near or above the card's ~295 ridge, so the kernel wants
// to be bound by the tensor cores. The TPU kernel's win, kept here, is
// that the normalised activations and the rank-r intermediate never reach
// device memory. Design: a block of 4 warps owns
// 16 rows (so that the 6,272 rows of the last stage still make 392
// blocks); the warps split the rows' statistics and the bf16(drop(ln))
// tile in shared memory, then the 64 columns of m = tile A (bf16, held on
// chip, once per row block), rewrite the tile as bf16(ln), and take the
// 64-column output chunks round robin, accumulating p and u with mma.sync
// m16n8k16 and writing y. Dropout masks are a hash of the element index
// (dropout.cuh): nothing is stored for the backward.
// The weights are read in their nn.Linear layouts ([O, K], [r, K], [O, r]:
// k contiguous, the mma B layout) straight from device memory through
// L1/L2. No TMA, wgmma or pipelining yet.

#include "ln_common.cuh"

namespace {

using namespace lnk;

struct FwdArgs {
  Rows R;
  const bf16 *gamma, *beta, *wt, *bias, *at, *bt;
  bf16* y;
  int O, r;
  float scale;
  DropSpec drop;
};

// Shared memory of a block: LN tile [16][K + 8] and m tile [16][72]
// (bf16), mu and inv [16] (fp32).
inline size_t block_bytes(int K) {
  return sizeof(bf16) * kRows * ((size_t)(K + 8) + kT) +
         2 * kRows * sizeof(float);
}

template <bool LORA>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.R.K, M = a.R.M, ld = K + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* ms = tile + kRows * ld;
  float* mu = reinterpret_cast<float*>(ms + kRows * kT);
  float* inv = mu + kRows;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  const Drop d = LORA ? make_drop(a.drop) : no_drop();
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, d, warp, warps);
  __syncthreads();
  if (LORA) {
    // m = bf16(bf16(drop(ln)) A^T), 16 of its 64 columns per warp; then
    // the tile becomes bf16(ln)
    float macc[2][4];
    zero<2>(macc);
    mma_tile<2>(macc, tile, ld, a.at, K, K, 16 * warp, a.r);
    store_tile<2>(ms, kT, macc, 16 * warp);
    __syncthreads();
    if (d.on) {
      rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, no_drop(),
                   warp, warps);
      __syncthreads();
    }
  }

  // 64-column output chunks, round robin over the warps
  for (int n0 = 64 * warp; n0 < a.O; n0 += 64 * warps) {
    float acc[8][4], u[8][4];
    zero<8>(acc);
    zero<8>(u);
    mma_tile<8>(acc, tile, ld, a.wt, K, K, n0, a.O);
    if (LORA) mma_tile<8>(u, ms, kT, a.bt, a.r, a.r, n0, a.O);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = n0 + nt * 8 + 2 * t;
      if (n0 + nt * 8 >= a.O) continue;
      const float2 b = a.bias ? bf2(a.bias + c) : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const float p0 = acc[nt][2 * half] + b.x;
        const float p1 = acc[nt][2 * half + 1] + b.y;
        const float z0 = p0 + a.scale * u[nt][2 * half];
        const float z1 = p1 + a.scale * u[nt][2 * half + 1];
        st_bf2(a.y + (size_t)m * a.O + c, z0, z1);
      }
    }
  }
}

template <bool LORA>
__global__ void __launch_bounds__(128) ln_lora_fwd_kernel(FwdArgs a) {
  fwd_body<LORA>(a);
}

FwdArgs make_args(const void* x, const void* gamma, const void* beta,
                  const void* wt, const void* bias, const void* at,
                  const void* bt, const void* seed, int M, int K, int O,
                  int r, int merge_wh, float scale, unsigned thr,
                  int use_drop, float inv_keep) {
  FwdArgs a = {};
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = K;
  a.R.Cin = merge_wh ? K / 4 : K;
  a.R.Wh = merge_wh;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.wt = static_cast<const bf16*>(wt);
  a.bias = static_cast<const bf16*>(bias);
  a.at = static_cast<const bf16*>(at);
  a.bt = static_cast<const bf16*>(bt);
  a.O = O;
  a.r = r;
  a.scale = scale;
  a.drop.seed = static_cast<const int*>(seed);
  a.drop.stream = 0;
  a.drop.on = use_drop;
  a.drop.thr = thr;
  a.drop.inv_keep = inv_keep;
  return a;
}

cudaError_t launch(void (*kern)(FwdArgs), const FwdArgs& a, void* stream) {
  const size_t smem = block_bytes(a.R.K);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(a.R.M + kRows - 1) / kRows, 128, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int O, int r, int merge_wh) {
  return M < 1 || K % 16 || O % 8 || r < 0 || r % 16 || r > 64 ||
         (merge_wh && K % 8);
}

}  // namespace

// x: [M, K] (merge_wh == 0) or the [.., H, W, K/4] stream with W =
// 2 merge_wh; y [M, O]. at, bt, bias may be null (r == 0: no adapter).
extern "C" int mtlora_ln_lora_fwd(const void* x, const void* gamma,
                                  const void* beta, const void* wt,
                                  const void* bias, const void* at,
                                  const void* bt, const void* seed, void* y,
                                  int M, int K, int O, int r, int merge_wh,
                                  float scale, unsigned thr, int use_drop,
                                  float inv_keep, void* stream) {
  if (bad_shape(M, K, O, r, merge_wh)) return (int)cudaErrorInvalidValue;
  FwdArgs a = make_args(x, gamma, beta, wt, bias, at, bt, seed, M, K, O, r,
                        merge_wh, scale, thr, use_drop, inv_keep);
  a.y = static_cast<bf16*>(y);
  const bool lora = r > 0 && scale != 0.f;
  return (int)launch(lora ? ln_lora_fwd_kernel<true> : ln_lora_fwd_kernel<false>,
                     a, stream);
}
